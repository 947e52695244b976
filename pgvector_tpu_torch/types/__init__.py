"""Value types that the port's tables and exact search accept.

:class:`Vector` (dense fp32, src/vector.c) and :class:`HalfVec` (dense
fp16, src/halfvec.c), with the reference's constructor checks only; the
parsers, scalar functions and aggregates of :mod:`pgvector_tpu.types` are
not ported yet.  ``SparseVec`` and ``Bit`` come with the sparse and bit
tables.
"""

from .vector import Vector, VECTOR_MAX_DIM
from .halfvec import HalfVec, HALFVEC_MAX_DIM

__all__ = [
    "Vector",
    "HalfVec",
    "VECTOR_MAX_DIM",
    "HALFVEC_MAX_DIM",
]
