"""The user-facing function surface — counterpart of
``pgvector_tpu.functions``, the analogue of pgvector's SQL catalog
(reference sql/vector.sql, 1,213 lines; §2.5 of SURVEY.md).  Host-side
code over the port's value types; it needs no device.

Every SQL-callable function and operator maps to a Python callable here,
with the same names and semantics:

========================  =====================================
SQL                       here
========================  =====================================
``l2_distance``           :func:`l2_distance`            (``<->``)
``inner_product``         :func:`inner_product`
``<#>``                   :func:`negative_inner_product`
``cosine_distance``       :func:`cosine_distance`        (``<=>``)
``l1_distance``           :func:`l1_distance`            (``<+>``)
``hamming_distance``      :func:`hamming_distance`       (``<~>``)
``jaccard_distance``      :func:`jaccard_distance`       (``<%>``)
``l2_norm/vector_norm``   :func:`l2_norm`
``l2_normalize``          :func:`l2_normalize`
``vector_dims``           :func:`vector_dims`
``binary_quantize``       :func:`binary_quantize`
``subvector``             :func:`subvector`
``avg`` / ``sum``         :func:`avg` / :func:`sum_`  (aggregates)
casts                     :func:`to_vector` / :func:`to_halfvec` /
                          :func:`to_sparsevec` / :func:`to_bit` /
                          :func:`to_float4`
========================  =====================================

Functions accept any of the four value types where the corresponding SQL
overload exists (sql/vector.sql:46-89, 490-533, 868-878, 955-983) and raise
the reference's error for unsupported pairings.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from .errors import DataException, NumericValueOutOfRange
from .types import Bit, HalfVec, SparseVec, Vector
from .types.vector import VectorAggState, _OVERFLOW

AnyVec = Union[Vector, HalfVec, SparseVec]


def _pair(a, b, op: str):
    if type(a) is not type(b):
        raise DataException(
            f"operator does not exist: {type(a).__name__} {op} {type(b).__name__}"
        )
    return a, b


# -- distances (sql/vector.sql:46-77, 490-521, 955-975) --------------------
def l2_distance(a: AnyVec, b: AnyVec) -> float:
    a, b = _pair(a, b, "<->")
    return a.l2_distance(b)


def inner_product(a: AnyVec, b: AnyVec) -> float:
    a, b = _pair(a, b, "<#>")
    return a.inner_product(b)


def negative_inner_product(a: AnyVec, b: AnyVec) -> float:
    a, b = _pair(a, b, "<#>")
    return a.negative_inner_product(b)


def cosine_distance(a: AnyVec, b: AnyVec) -> float:
    a, b = _pair(a, b, "<=>")
    return a.cosine_distance(b)


def l1_distance(a: AnyVec, b: AnyVec) -> float:
    a, b = _pair(a, b, "<+>")
    return a.l1_distance(b)


def hamming_distance(a: Bit, b: Bit) -> float:
    return a.hamming_distance(b)


def jaccard_distance(a: Bit, b: Bit) -> float:
    return a.jaccard_distance(b)


# -- norms / utilities ------------------------------------------------------
def l2_norm(a: AnyVec) -> float:
    """l2_norm / vector_norm — sql/vector.sql:68-76, 523-526, 977-980."""
    return a.norm()


vector_norm = l2_norm


def l2_normalize(a: AnyVec) -> AnyVec:
    return a.l2_normalize()


def vector_dims(a: Union[AnyVec, Bit]) -> int:
    """vector_dims / array_length analogue — sql/vector.sql:78-85."""
    return a.dim


def binary_quantize(a: Union[Vector, HalfVec]) -> Bit:
    """binary_quantize → bit(x > 0) — src/vector.c:952-978."""
    return Bit(a.binary_quantize())


def subvector(a: Union[Vector, HalfVec], start: int, count: int):
    """1-indexed subvector, substring semantics — src/vector.c:983-1025."""
    return a.subvector(start, count)


def concat(a: AnyVec, b: AnyVec):
    """The ``||`` operator — src/vector.c:926-947."""
    a, b = _pair(a, b, "||")
    return a.concat(b)


def to_float4(a: Union[Vector, HalfVec]) -> List[float]:
    """vector_to_float4 / halfvec_to_float4 — the ``vector → real[]`` cast
    (sql/vector.sql:227-231, 681-685; src/vector.c:1100-1124): a plain list
    of the stored elements widened to Python floats (vector elements are
    already f32; halfvec elements widen exactly)."""
    return a.tolist()


# -- aggregates (vector + halfvec; sql/vector.sql:180-198, 624-642) --------
def avg(values: Iterable[Union[Vector, HalfVec]]):
    values = list(values)
    if not values:
        return None
    if isinstance(values[0], HalfVec):
        state = _HalfAgg()
    else:
        state = VectorAggState()
    for v in values:
        state.accum(v)
    return state.avg()


def sum_(values: Iterable[Union[Vector, HalfVec]]):
    values = list(values)
    if not values:
        return None
    if isinstance(values[0], HalfVec):
        state = _HalfAgg()
    else:
        state = VectorAggState()
    for v in values:
        state.accum(v)
    return state.sum_result()


class _HalfAgg:
    """halfvec_accum/avg/sum — f64 state like the vector aggregates
    (src/halfvec.c:1104-1196)."""

    def __init__(self) -> None:
        self.n = 0
        self.sum: Optional[np.ndarray] = None

    def accum(self, v: HalfVec) -> "_HalfAgg":
        x = v.x.astype(np.float64)
        if self.sum is None:
            self.sum, self.n = x, 1
        else:
            if self.sum.shape[0] != v.dim:
                raise DataException(
                    f"expected {self.sum.shape[0]} dimensions, not {v.dim}"
                )
            self.sum = self.sum + x
            self.n += 1
        return self

    def combine(self, other: "_HalfAgg") -> "_HalfAgg":
        if other.sum is None:
            return self
        if self.sum is None:
            self.n, self.sum = other.n, other.sum.copy()
            return self
        self.sum = self.sum + other.sum
        self.n += other.n
        return self

    def _narrow(self, arr64: np.ndarray) -> HalfVec:
        with np.errstate(over="ignore"):
            rx = arr64.astype(np.float16)
        if np.isinf(rx).any():
            raise NumericValueOutOfRange(_OVERFLOW)
        return HalfVec(rx, _checked=True)

    def avg(self) -> Optional[HalfVec]:
        if self.sum is None:
            return None
        return self._narrow(self.sum / self.n)

    def sum_result(self) -> Optional[HalfVec]:
        if self.sum is None:
            return None
        return self._narrow(self.sum)


# -- casts (the full matrix, sql/vector.sql:234-250, 688-710, 1081-1106) ---
def to_vector(x, typmod: int = -1) -> Vector:
    """array/halfvec/sparsevec/text → vector."""
    if isinstance(x, Vector):
        v = x
    elif isinstance(x, HalfVec):
        v = x.to_vector()
    elif isinstance(x, SparseVec):
        v = x.to_vector()
    elif isinstance(x, str):
        return Vector.from_text(x, typmod)
    else:
        arr = np.asarray(x, dtype=np.float64)
        if arr.ndim != 1:
            raise DataException("array must be 1-D")
        if np.isnan(arr).any():
            raise DataException("NaN not allowed in vector")
        with np.errstate(over="ignore"):
            f = arr.astype(np.float32)
        if np.isinf(f).any() and not np.isinf(arr).any():
            raise NumericValueOutOfRange("value out of range for type vector")
        v = Vector(f)
    if typmod != -1 and v.dim != typmod:
        raise DataException(f"expected {typmod} dimensions, not {v.dim}")
    return v


def to_halfvec(x, typmod: int = -1) -> HalfVec:
    if isinstance(x, HalfVec):
        h = x
    elif isinstance(x, Vector):
        h = HalfVec.from_vector(x)
    elif isinstance(x, SparseVec):
        h = HalfVec.from_vector(x.to_vector())
    elif isinstance(x, str):
        return HalfVec.from_text(x, typmod)
    else:
        arr = np.asarray(x, dtype=np.float64)
        if arr.ndim != 1:
            raise DataException("array must be 1-D")
        with np.errstate(over="ignore"):
            f = arr.astype(np.float16)
        if np.isinf(f).any() and not np.isinf(arr).any():
            raise NumericValueOutOfRange("value out of range for type halfvec")
        h = HalfVec(f)
    if typmod != -1 and h.dim != typmod:
        raise DataException(f"expected {typmod} dimensions, not {h.dim}")
    return h


def to_sparsevec(x, typmod: int = -1) -> SparseVec:
    if isinstance(x, SparseVec):
        s = x
    elif isinstance(x, (Vector, HalfVec)):
        s = SparseVec.from_dense(x)
    elif isinstance(x, str):
        return SparseVec.from_text(x, typmod)
    else:
        s = SparseVec.from_dense(np.asarray(x, dtype=np.float32))
    if typmod != -1 and s.dim != typmod:
        raise DataException(f"expected {typmod} dimensions, not {s.dim}")
    return s


def to_bit(x) -> Bit:
    if isinstance(x, Bit):
        return x
    if isinstance(x, (Vector, HalfVec)):
        return Bit(x.binary_quantize())
    if isinstance(x, str):
        return Bit.from_text(x)
    return Bit(np.asarray(x, dtype=bool))
