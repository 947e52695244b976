"""``vector`` — the dense float32 value type, as far as the port's tables
and exact search take it: a checked 1-D array in ``.x``.

Counterpart of :class:`pgvector_tpu.types.Vector` (reference src/vector.c)
for construction only: at least 1 and at most 16,000 dimensions
(src/vector.h:11), no NaN, no infinity.  Text and binary I/O, the scalar
distance functions, arithmetic, ordering and aggregates are not ported
yet.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from ..errors import DataException, ProgramLimitExceeded

VECTOR_MAX_DIM = 16000  # src/vector.h:11


class DenseValue:
    """A checked 1-D array of ``dtype`` (the reference's constructor
    checks, src/vector.c:95-123)."""

    __slots__ = ("x",)

    type_name = "vector"
    max_dim = VECTOR_MAX_DIM
    dtype = np.float32

    def __init__(self, values: Union[Sequence[float], np.ndarray]):
        arr = np.asarray(values, dtype=self.dtype)
        if arr.ndim != 1:
            raise DataException("array must be 1-D")
        if arr.shape[0] < 1:
            raise DataException(f"{self.type_name} must have at least 1 dimension")
        if arr.shape[0] > self.max_dim:
            raise ProgramLimitExceeded(
                f"{self.type_name} cannot have more than {self.max_dim} dimensions")
        if np.isnan(arr).any():
            raise DataException(f"NaN not allowed in {self.type_name}")
        if np.isinf(arr).any():
            raise DataException(f"infinite value not allowed in {self.type_name}")
        self.x = arr

    @property
    def dim(self) -> int:
        return int(self.x.shape[0])

    def __len__(self) -> int:
        return self.dim

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.x.tolist()!r})"


class Vector(DenseValue):
    """A single dense fp32 vector value."""

    __slots__ = ()
