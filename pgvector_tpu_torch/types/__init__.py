"""Value types, counterparts of :mod:`pgvector_tpu.types`:
:class:`Vector` (dense fp32, src/vector.c), :class:`HalfVec` (dense fp16,
src/halfvec.c), :class:`SparseVec` (sparse fp32, src/sparsevec.c) and
:class:`Bit` (the ``bit`` string, src/bitvec.c), with their text and
binary I/O, scalar functions, ordering, and the vector aggregates
(:class:`VectorAggState`, :func:`avg`, :func:`vec_sum`).
"""

from .vector import Vector, VectorAggState, avg, vec_sum, VECTOR_MAX_DIM
from .halfvec import HalfVec, HALFVEC_MAX_DIM
from .sparsevec import SparseVec, SPARSEVEC_MAX_DIM, SPARSEVEC_MAX_NNZ
from .bitvec import Bit, BITVEC_MAX_DIM

__all__ = [
    "Vector",
    "HalfVec",
    "SparseVec",
    "Bit",
    "VectorAggState",
    "avg",
    "vec_sum",
    "VECTOR_MAX_DIM",
    "HALFVEC_MAX_DIM",
    "SPARSEVEC_MAX_DIM",
    "SPARSEVEC_MAX_NNZ",
    "BITVEC_MAX_DIM",
]
