"""Value types that the port's tables and exact search accept.

:class:`Vector` (dense fp32, src/vector.c) and :class:`HalfVec` (dense
fp16, src/halfvec.c) with the reference's constructor checks only;
:class:`SparseVec` (sparse fp32, src/sparsevec.c) without its text and
binary I/O; :class:`Bit` (the ``bit`` string, src/bitvec.c) whole.  The
parsers, scalar functions and aggregates of the dense types are not
ported yet.
"""

from .vector import Vector, VECTOR_MAX_DIM
from .halfvec import HalfVec, HALFVEC_MAX_DIM
from .sparsevec import SparseVec, SPARSEVEC_MAX_DIM, SPARSEVEC_MAX_NNZ
from .bitvec import Bit, BITVEC_MAX_DIM

__all__ = [
    "Vector",
    "HalfVec",
    "SparseVec",
    "Bit",
    "VECTOR_MAX_DIM",
    "HALFVEC_MAX_DIM",
    "SPARSEVEC_MAX_DIM",
    "SPARSEVEC_MAX_NNZ",
    "BITVEC_MAX_DIM",
]
