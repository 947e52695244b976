"""``vector`` — the dense float32 value type; counterpart of
:class:`pgvector_tpu.types.Vector` (reference src/vector.c).

:class:`DenseValue` holds what ``vector`` and ``halfvec`` share (the
reference's halfvec.c mirrors vector.c 1:1): text format ``[1,2,3]``,
big-endian binary wire format ``{int16 dim, int16 unused, element x[dim]}``,
at least 1 and at most 16,000 dimensions (src/vector.h:11), no NaN, no
infinity, typmod checks, the six distance functions with f32 accumulation
and f64 norms, checked arithmetic, ``concat``, ``subvector``,
``binary_quantize`` and array-style total ordering.  A subclass names its
element type, its wire type and its float narrowing.  ``vector`` adds the
aggregates, with an f64 state (:class:`VectorAggState`, :func:`avg`,
:func:`vec_sum`).

These are host-side scalar values (one value at a time, the analogue of
Postgres fmgr calls); batched compute runs on torch tensors.
"""

from __future__ import annotations

import math
import struct
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from ..errors import DataException, NumericValueOutOfRange, ProgramLimitExceeded
from . import _scan

VECTOR_MAX_DIM = 16000  # src/vector.h:11

_OVERFLOW = "value out of range: overflow"
_UNDERFLOW = "value out of range: underflow"


def _check_dim(dim: int, type_name: str = "vector",
               max_dim: int = VECTOR_MAX_DIM) -> None:
    # src/vector.c:95-105
    if dim < 1:
        raise DataException(f"{type_name} must have at least 1 dimension")
    if dim > max_dim:
        raise ProgramLimitExceeded(
            f"{type_name} cannot have more than {max_dim} dimensions")


def _check_expected_dim(typmod: int, dim: int) -> None:
    # src/vector.c:83-89
    if typmod != -1 and typmod != dim:
        raise DataException(f"expected {typmod} dimensions, not {dim}")


class DenseValue:
    """A checked 1-D array of ``dtype`` in ``.x``; the functions
    ``vector`` and ``halfvec`` share.  Distances widen to f32 and
    accumulate in f32, as the reference's kernels (src/vector.c:560-735,
    the F16C path of src/halfutils.c:46-122); arithmetic computes in f32
    and narrows back with an overflow check."""

    __slots__ = ("x",)

    type_name = "vector"
    max_dim = VECTOR_MAX_DIM
    dtype = np.float32
    #: big-endian element type of the binary wire format
    wire = ">f4"

    def __init__(self, values: Union[Sequence[float], np.ndarray], *,
                 _checked: bool = False):
        arr = np.asarray(values, dtype=self.dtype)
        if arr.ndim != 1:
            raise DataException("array must be 1-D")  # src/vector.c:457-459
        self.x = arr
        if not _checked:
            _check_dim(arr.shape[0], self.type_name, self.max_dim)
            # src/vector.c:111-123
            if np.isnan(arr).any():
                raise DataException(f"NaN not allowed in {self.type_name}")
            if np.isinf(arr).any():
                raise DataException(
                    f"infinite value not allowed in {self.type_name}")

    @property
    def dim(self) -> int:
        return int(self.x.shape[0])

    def __len__(self) -> int:
        return self.dim

    # -- text I/O (vector_in/out, src/vector.c:176-326) --------------------
    @staticmethod
    def _narrow(val: float, text: str) -> np.floating:
        return _scan.narrow_f32(val, text, "vector")

    @staticmethod
    def _format(v) -> str:
        return _scan.format_f32(v)

    @classmethod
    def from_text(cls, lit: str, typmod: int = -1):
        values = _parse_dense_literal(lit, cls.type_name, cls.max_dim,
                                      cls._narrow)
        _check_dim(len(values), cls.type_name, cls.max_dim)
        _check_expected_dim(typmod, len(values))
        return cls(np.array(values, dtype=cls.dtype), _checked=True)

    def to_text(self) -> str:
        return "[" + ",".join(self._format(v) for v in self.x) + "]"

    # -- binary I/O (vector_recv/send, src/vector.c:374-423) ---------------
    @classmethod
    def from_binary(cls, data: bytes, typmod: int = -1):
        if len(data) < 4:
            raise DataException("insufficient data")
        dim, unused = struct.unpack_from(">hh", data, 0)
        _check_dim(dim, cls.type_name, cls.max_dim)
        _check_expected_dim(typmod, dim)
        if unused != 0:
            raise DataException(f"expected unused to be 0, not {unused}")
        size = np.dtype(cls.wire).itemsize
        if len(data) < 4 + size * dim:
            raise DataException("insufficient data left in message")
        arr = np.frombuffer(data, dtype=cls.wire, count=dim,
                            offset=4).astype(cls.dtype)
        return cls(arr)

    def to_binary(self) -> bytes:
        return struct.pack(">hh", self.dim, 0) + self.x.astype(self.wire).tobytes()

    # -- distances (f32 accumulation) ----------------------------------------
    def _f32(self) -> np.ndarray:
        return np.asarray(self.x, dtype=np.float32)

    def _check_dims(self, other: "DenseValue") -> None:
        if self.dim != other.dim:
            raise DataException(
                f"different {self.type_name} dimensions {self.dim} and {other.dim}")

    def l2_squared_distance(self, other: "DenseValue") -> float:
        """VectorL2SquaredDistance (src/vector.c:560-574)."""
        self._check_dims(other)
        d = self._f32() - other._f32()
        return float(np.float32(np.dot(d, d)))

    def l2_distance(self, other: "DenseValue") -> float:
        """l2_distance (src/vector.c:579-589), sqrt in f64."""
        return math.sqrt(self.l2_squared_distance(other))

    def inner_product(self, other: "DenseValue") -> float:
        """VectorInnerProduct (src/vector.c:607-617)."""
        self._check_dims(other)
        return float(np.float32(np.dot(self._f32(), other._f32())))

    def negative_inner_product(self, other: "DenseValue") -> float:
        """The ``<#>`` operator (src/vector.c:636-647)."""
        return -self.inner_product(other)

    def cosine_distance(self, other: "DenseValue") -> float:
        """cosine_distance (src/vector.c:649-694): f32 sums, f64 division,
        clamped to [-1, 1]; a zero vector gives NaN."""
        self._check_dims(other)
        a, b = self._f32(), other._f32()
        sim = np.float32(np.dot(a, b))
        na = np.float32(np.dot(a, a))
        nb = np.float32(np.dot(b, b))
        with np.errstate(divide="ignore", invalid="ignore"):
            similarity = float(np.float64(sim)
                               / np.sqrt(np.float64(na) * np.float64(nb)))
        if not math.isnan(similarity):
            similarity = min(1.0, max(-1.0, similarity))
        return 1.0 - similarity

    def spherical_distance(self, other: "DenseValue") -> float:
        """vector_spherical_distance (src/vector.c:703-722)."""
        self._check_dims(other)
        ip = float(np.float32(np.dot(self._f32(), other._f32())))
        ip = min(1.0, max(-1.0, ip))
        return math.acos(ip) / math.pi

    def l1_distance(self, other: "DenseValue") -> float:
        """VectorL1Distance (src/vector.c:725-735)."""
        self._check_dims(other)
        return float(np.float32(np.sum(np.abs(self._f32() - other._f32()),
                                       dtype=np.float32)))

    # -- norm / normalize (f64 accumulation, src/vector.c:767-819) -----------
    def norm(self) -> float:
        a = self.x.astype(np.float64)
        return math.sqrt(float(np.dot(a, a)))

    def l2_normalize(self):
        """l2_normalize: a zero norm gives the zero vector."""
        norm = self.norm()
        if norm > 0:
            with np.errstate(over="ignore"):
                rx = (self.x.astype(np.float64) / norm).astype(self.dtype)
            if np.isinf(rx).any():
                raise NumericValueOutOfRange(_OVERFLOW)
            return type(self)(rx, _checked=True)
        return type(self)(np.zeros_like(self.x), _checked=True)

    # -- checked arithmetic (src/vector.c:824-947) ---------------------------
    def _narrow_back(self, rx32: np.ndarray):
        with np.errstate(over="ignore"):
            rx = rx32.astype(self.dtype)
        if np.isinf(rx).any():
            raise NumericValueOutOfRange(_OVERFLOW)
        return type(self)(rx, _checked=True)

    def __add__(self, other):
        self._check_dims(other)
        with np.errstate(over="ignore"):
            return self._narrow_back(self._f32() + other._f32())

    def __sub__(self, other):
        self._check_dims(other)
        with np.errstate(over="ignore"):
            return self._narrow_back(self._f32() - other._f32())

    def __mul__(self, other):
        self._check_dims(other)
        with np.errstate(over="ignore", under="ignore"):
            result = self._narrow_back(self._f32() * other._f32())
        if ((result.x == 0) & (self.x != 0) & (other.x != 0)).any():
            raise NumericValueOutOfRange(_UNDERFLOW)
        return result

    def concat(self, other):
        """The ``||`` operator (src/vector.c:926-947)."""
        dim = self.dim + other.dim
        _check_dim(dim, self.type_name, self.max_dim)
        return type(self)(np.concatenate([self.x, other.x]), _checked=True)

    def binary_quantize(self) -> np.ndarray:
        """binary_quantize (src/vector.c:952-978): ``x > 0`` as a bool
        array; :class:`..types.Bit` wraps it as the varbit value."""
        return self.x > 0

    def subvector(self, start: int, count: int):
        """subvector (src/vector.c:983-1025), 1-indexed like substring."""
        if count < 1:
            raise DataException(f"{self.type_name} must have at least 1 dimension")
        end = self.dim + 1 if start > self.dim - count else start + count
        if start < 1:
            start = 1
        elif start > self.dim:
            raise DataException(f"{self.type_name} must have at least 1 dimension")
        dim = end - start
        _check_dim(dim, self.type_name, self.max_dim)
        return type(self)(self.x[start - 1: start - 1 + dim].copy(),
                          _checked=True)

    # -- ordering (src/vector.c:1030-1143): values before dims ---------------
    def compare(self, other) -> int:
        n = min(self.dim, other.dim)
        a, b = self.x[:n], other.x[:n]
        neq = np.nonzero(a != b)[0]
        if neq.size:
            i = int(neq[0])
            return -1 if a[i] < b[i] else 1
        if self.dim != other.dim:
            return -1 if self.dim < other.dim else 1
        return 0

    def __lt__(self, o):
        return self.compare(o) < 0

    def __le__(self, o):
        return self.compare(o) <= 0

    def __eq__(self, o):
        return isinstance(o, type(self)) and self.compare(o) == 0

    def __ne__(self, o):
        return not self.__eq__(o)

    def __ge__(self, o):
        return self.compare(o) >= 0

    def __gt__(self, o):
        return self.compare(o) > 0

    def __hash__(self) -> int:
        # x + 0.0 maps -0.0 to +0.0: __eq__ treats them equal (float
        # compare), so their hashes must match too
        return hash((self.type_name, (self.x + 0.0).tobytes()))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_text()!r})"

    def to_numpy(self) -> np.ndarray:
        return self.x

    def tolist(self) -> List[float]:
        return [float(v) for v in self.x]


class Vector(DenseValue):
    """A single dense fp32 vector value."""

    __slots__ = ()


def _parse_dense_literal(lit: str, type_name: str, max_dim: int, narrow) -> list:
    """The ``[a,b,c]`` scanner of vector and halfvec (src/vector.c:176-282)."""
    i = _scan.skip_space(lit, 0)
    if i >= len(lit) or lit[i] != "[":
        raise _scan.bad_literal(type_name, lit,
                                'Vector contents must start with "[".')
    i = _scan.skip_space(lit, i + 1)
    if i < len(lit) and lit[i] == "]":
        raise DataException(f"{type_name} must have at least 1 dimension")
    out = []
    while True:
        if len(out) == max_dim:
            raise ProgramLimitExceeded(
                f"{type_name} cannot have more than {max_dim} dimensions")
        i = _scan.skip_space(lit, i)
        if i >= len(lit):
            raise _scan.bad_literal(type_name, lit)
        val, end, text = _scan.strtof(lit, i)
        if val is None:
            raise _scan.bad_literal(type_name, lit)
        f = narrow(val, text)
        if np.isnan(f):
            raise DataException(f"NaN not allowed in {type_name}")
        if np.isinf(f):
            raise DataException(f"infinite value not allowed in {type_name}")
        out.append(f)
        i = _scan.skip_space(lit, end)
        if i < len(lit) and lit[i] == ",":
            i += 1
        elif i < len(lit) and lit[i] == "]":
            i += 1
            break
        else:
            raise _scan.bad_literal(type_name, lit)
    i = _scan.skip_space(lit, i)
    if i != len(lit):
        raise _scan.bad_literal(type_name, lit, "Junk after closing right brace.")
    return out


# -- aggregates (src/vector.c:1148-1318): f64 state {n, sum[dim]} ---------
class VectorAggState:
    """The vector_accum / vector_combine state (parallel-safe combine)."""

    __slots__ = ("n", "sum")

    def __init__(self) -> None:
        self.n = 0
        self.sum: Optional[np.ndarray] = None

    def accum(self, v: Vector) -> "VectorAggState":
        if self.sum is None:
            self.sum = v.x.astype(np.float64)
            self.n = 1
        else:
            if self.sum.shape[0] != v.dim:
                raise DataException(
                    f"expected {self.sum.shape[0]} dimensions, not {v.dim}")
            self.sum = self.sum + v.x.astype(np.float64)
            self.n += 1
        return self

    def combine(self, other: "VectorAggState") -> "VectorAggState":
        if other.sum is None:
            return self
        if self.sum is None:
            self.n, self.sum = other.n, other.sum.copy()
            return self
        if self.sum.shape[0] != other.sum.shape[0]:
            raise DataException(
                f"expected {self.sum.shape[0]} dimensions, not {other.sum.shape[0]}")
        self.n += other.n
        self.sum = self.sum + other.sum
        return self

    def _result(self, rx64: np.ndarray) -> Vector:
        with np.errstate(over="ignore"):
            rx = rx64.astype(np.float32)
        if np.isinf(rx).any():
            raise NumericValueOutOfRange(_OVERFLOW)
        return Vector(rx, _checked=True)

    def avg(self) -> Optional[Vector]:
        """vector_avg (src/vector.c:1260-1292); None (NULL) on no input."""
        return None if self.sum is None else self._result(self.sum / self.n)

    def sum_result(self) -> Optional[Vector]:
        """vector_sum (src/vector.c:1294-1318)."""
        return None if self.sum is None else self._result(self.sum)


def avg(vectors: Iterable[Vector]) -> Optional[Vector]:
    state = VectorAggState()
    for v in vectors:
        state.accum(v)
    return state.avg()


def vec_sum(vectors: Iterable[Vector]) -> Optional[Vector]:
    state = VectorAggState()
    for v in vectors:
        state.accum(v)
    return state.sum_result()
