"""``halfvec`` — the dense float16 value type; counterpart of
:class:`pgvector_tpu.types.HalfVec` (reference src/halfvec.c, which
mirrors vector.c 1:1).

Everything :class:`.vector.DenseValue` does, with fp16 storage and wire
format, at most 16,000 dimensions (src/halfvec.h:60).  Literals and
arithmetic results that overflow float16 are refused (``Float4ToHalf``'s
overflow error, src/halfutils.h:244-261); text output prints each half as
the float32 shortest decimal (src/halfvec.c:290-330).  Tables store a
halfvec column as bf16 or f16 tensors scored in f32.
"""

from __future__ import annotations

import numpy as np

from ..errors import NumericValueOutOfRange
from . import _scan
from .vector import DenseValue, Vector

HALFVEC_MAX_DIM = 16000  # src/halfvec.h:60


class HalfVec(DenseValue):
    """A single dense fp16 vector value."""

    __slots__ = ()

    type_name = "halfvec"
    max_dim = HALFVEC_MAX_DIM
    dtype = np.float16
    wire = ">f2"

    @staticmethod
    def _narrow(val: float, text: str) -> np.floating:
        return _scan.narrow_f16(val, text, "halfvec")

    @staticmethod
    def _format(v) -> str:
        return _scan.format_f16(v)

    # -- casts (halfvec <-> vector, sql/vector.sql:688-710) ------------------
    def to_vector(self) -> Vector:
        return Vector(self.x.astype(np.float32), _checked=True)

    @classmethod
    def from_vector(cls, v: Vector) -> "HalfVec":
        with np.errstate(over="ignore"):
            rx = v.x.astype(np.float16)
        if np.isinf(rx).any():
            raise NumericValueOutOfRange(
                f'"{v.x[np.isinf(rx)][0]}" is out of range for type halfvec')
        return cls(rx, _checked=True)
