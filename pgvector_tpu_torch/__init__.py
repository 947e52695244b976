"""pgvector_tpu_torch — the PyTorch / CUDA port of ``pgvector_tpu``.

The same engine as the JAX package (reference: pgvector/pgvector 0.8.6),
on torch tensors: dense tables on a chosen ``device``, exact search and
HNSW, with the JAX package's two Pallas kernels as hand-written CUDA
kernels for Hopper (``csrc/``; built with ``nvcc`` at first use):

- K1 :mod:`pgvector_tpu_torch.ops.fused_topk` — exact L2/IP top-k scan
- K2 :mod:`pgvector_tpu_torch.ops.hop_tail` — HNSW beam-search hop tail

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
    VECTOR_MAX_DIM,
    HALFVEC_MAX_DIM,
)
from .ops.metric import Metric  # noqa: E402
from .store.table import DenseTable  # noqa: E402
from .index.flat import FlatIndex  # noqa: E402
from .index.hnsw import HNSWIndex  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "config",
    "Metric",
    "FlatIndex",
    "HNSWIndex",
    "DenseTable",
    "Vector",
    "HalfVec",
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
]
