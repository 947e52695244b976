"""pgvector_tpu_torch — the PyTorch / CUDA port of ``pgvector_tpu``.

The same engine as the JAX package (reference: pgvector/pgvector 0.8.6),
on torch tensors: the value types (``vector``, ``halfvec``, ``sparsevec``,
``bit``) with their text and binary I/O and the vector aggregates; dense
(f32, bf16, f16), bit and sparse tables on the card (or a ``device`` the
caller names, such as ``"cpu"``), exact search (K1 inside its gate, the
grouped engine, the tiled scan), HNSW (packed f32, bf16 or int8 slabs),
IVFFlat (dense and bit), the re-ranking pipelines (binary quantization,
subvectors, expression indexes), checkpoints in the JAX package's
directory format, and the SQL-facing surface (:class:`Relation` with the
planner, the btree index, COPY through the native codec, the replication
log, the batching executor and the SQL functions) and the mesh paths
(:mod:`pgvector_tpu_torch.parallel`: sharded search, sharded k-means,
sharded indexes and the mesh build over a mesh of torch devices), with
the JAX package's two Pallas kernels as hand-written CUDA kernels for
Hopper (``csrc/``; built with ``nvcc`` at first use):

- K1 :mod:`pgvector_tpu_torch.ops.fused_topk` — exact L2/IP top-k scan
  (3xTF32 on the tensor cores)
- K2 :mod:`pgvector_tpu_torch.ops.packed_hop` — one whole HNSW
  beam-search hop (the E-selection, neighbor ids, dedupe, slab scores
  over slabs brought in by TMA bulk copies, the merge, done and hop
  counts) over an f32, bf16 or int8 slab (the int8 tier's scorer,
  ``__dp4a``); the reference's tail alone is
  :mod:`pgvector_tpu_torch.ops.hop_tail`

and two more for the bit type, whose popcounts the JAX package left to
XLA (:mod:`pgvector_tpu_torch.ops.bit_scan`): K4 ``bit_topk``, the exact
Hamming / Jaccard top-k, and K5 ``bit_point_scores``, the distances to
gathered rows.

Each kernel has a plain PyTorch version of the same function, used for
CPU tensors.  The package imports neither ``jax`` nor ``pgvector_tpu``.

f32 distance math stays f32: TF32 is switched off for matmuls and cuDNN
on import, and ``compute.matmul_precision`` (default ``highest``) maps
onto ``torch.set_float32_matmul_precision``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import config  # noqa: E402
from .errors import (  # noqa: E402
    VectorError,
    DataException,
    InvalidTextRepresentation,
    ProgramLimitExceeded,
    NumericValueOutOfRange,
    InvalidParameterValue,
    FeatureNotSupported,
    InternalError,
)
from .types import (  # noqa: E402
    Vector,
    HalfVec,
    SparseVec,
    Bit,
    VectorAggState,
    avg,
    vec_sum,
    VECTOR_MAX_DIM,
    HALFVEC_MAX_DIM,
    SPARSEVEC_MAX_DIM,
    SPARSEVEC_MAX_NNZ,
    BITVEC_MAX_DIM,
)
from .ops.metric import Metric  # noqa: E402
from .store.table import BitTable, DenseTable, SparseTable  # noqa: E402
from .index.flat import FlatIndex  # noqa: E402
from .index.hnsw import HNSWIndex  # noqa: E402
from .index.ivfflat import IVFFlatIndex  # noqa: E402
from .relation import Relation  # noqa: E402
from .rerank import (  # noqa: E402
    BinaryQuantizedIndex,
    ExpressionIndex,
    SubvectorIndex,
    exact_rerank,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "Relation",
    "Metric",
    "FlatIndex",
    "HNSWIndex",
    "IVFFlatIndex",
    "DenseTable",
    "BitTable",
    "SparseTable",
    "BinaryQuantizedIndex",
    "ExpressionIndex",
    "SubvectorIndex",
    "exact_rerank",
    "Vector",
    "HalfVec",
    "SparseVec",
    "Bit",
    "VectorAggState",
    "avg",
    "vec_sum",
    "VectorError",
    "DataException",
    "InvalidTextRepresentation",
    "ProgramLimitExceeded",
    "NumericValueOutOfRange",
    "InvalidParameterValue",
    "FeatureNotSupported",
    "InternalError",
    "VECTOR_MAX_DIM",
    "HALFVEC_MAX_DIM",
    "SPARSEVEC_MAX_DIM",
    "SPARSEVEC_MAX_NNZ",
    "BITVEC_MAX_DIM",
]
