"""``sparsevec`` — the sparse float32 value type; counterpart of
:class:`pgvector_tpu.types.SparseVec` (reference src/sparsevec.c).

The layout is the reference's ``{dim, nnz, int32 indices[] (sorted,
0-based), float values[]}`` (src/sparsevec.h:18-29), at most 1e9
dimensions and 16,000 non-zeros (src/sparsevec.h:11-12).  Zero values are
dropped on input, indices must ascend without duplicates.  The text format
is ``{index:value,...}/dim`` with 1-based indices (src/sparsevec.c:203-423),
the binary format big-endian ``{int32 dim, int32 nnz, int32 unused,
int32 indices[nnz], float4 values[nnz]}`` (src/sparsevec.c:505-585).
Distances are the reference's merge joins (src/sparsevec.c:822-1056) as
set operations, accumulated in f32; norms in f64.
"""

from __future__ import annotations

import math
import re
import struct
from typing import List, Sequence, Tuple, Union

import numpy as np

from ..errors import (
    DataException,
    InvalidTextRepresentation,
    NumericValueOutOfRange,
    ProgramLimitExceeded,
)
from . import _scan
from .halfvec import HalfVec
from .vector import VECTOR_MAX_DIM, Vector

SPARSEVEC_MAX_DIM = 1_000_000_000  # src/sparsevec.h:11
SPARSEVEC_MAX_NNZ = 16000  # src/sparsevec.h:12

_OVERFLOW = "value out of range: overflow"


def _check_dim(dim: int) -> None:
    # src/sparsevec.c:69-80
    if dim < 1:
        raise DataException("sparsevec must have at least 1 dimension")
    if dim > SPARSEVEC_MAX_DIM:
        raise ProgramLimitExceeded(
            f"sparsevec cannot have more than {SPARSEVEC_MAX_DIM} dimensions")


def _check_nnz(nnz: int, dim: int) -> None:
    # src/sparsevec.c:85-101
    if nnz < 0:
        raise DataException("sparsevec cannot have negative number of elements")
    if nnz > SPARSEVEC_MAX_NNZ:
        raise ProgramLimitExceeded(
            f"sparsevec cannot have more than {SPARSEVEC_MAX_NNZ} non-zero elements")
    if nnz > dim:
        raise DataException("sparsevec cannot have more elements than dimensions")


def _check_expected_dim(typmod: int, dim: int) -> None:
    if typmod != -1 and typmod != dim:
        raise DataException(f"expected {typmod} dimensions, not {dim}")


def _parse_long(s: str, i: int) -> Tuple[int, int]:
    """strtol base 10 (src/sparsevec.c:275-291), clamped to int32."""
    m = re.match(r"[+-]?\d+", s[i:])
    if m is None:
        raise InvalidTextRepresentation(
            f'invalid input syntax for type sparsevec: "{s}"')
    v = min(max(int(m.group(0)), -(2**31) + 1), 2**31 - 1)
    return v, i + m.end()


class SparseVec:
    """A single sparse fp32 vector value (sorted 0-based indices)."""

    __slots__ = ("dim", "indices", "values")

    type_name = "sparsevec"

    def __init__(self, dim: int, indices: Union[Sequence[int], np.ndarray],
                 values: Union[Sequence[float], np.ndarray], *,
                 _checked: bool = False):
        self.dim = int(dim)
        idx = np.asarray(indices, dtype=np.int32)
        val = np.asarray(values, dtype=np.float32)
        if not _checked:
            _check_dim(self.dim)
            _check_nnz(idx.shape[0], self.dim)
            if idx.shape[0] != val.shape[0]:
                raise DataException(
                    "sparsevec indices and values must have same length")
            # order, bounds and duplicates (src/sparsevec.c:104-131)
            if idx.size:
                if idx.min() < 0 or idx.max() >= self.dim:
                    raise DataException("sparsevec index out of bounds")
                d = np.diff(idx)
                if (d < 0).any():
                    raise DataException(
                        "sparsevec indices must be in ascending order")
                if (d == 0).any():
                    raise DataException(
                        "sparsevec indices must not contain duplicates")
            if np.isnan(val).any():
                raise DataException("NaN not allowed in sparsevec")
            if np.isinf(val).any():
                raise DataException("infinite value not allowed in sparsevec")
            nz = val != 0  # zeros are never stored (sparsevec_in)
            idx, val = idx[nz], val[nz]
        self.indices = idx
        self.values = val

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dense(cls, dense: Union[Sequence[float], np.ndarray, Vector,
                                     HalfVec]) -> "SparseVec":
        """The vector → sparsevec cast (src/sparsevec.c:587-660)."""
        if isinstance(dense, (Vector, HalfVec)):
            dense = dense.x
        arr = np.asarray(dense, dtype=np.float32)
        _check_dim(arr.shape[0])
        idx = np.nonzero(arr)[0].astype(np.int32)
        _check_nnz(idx.shape[0], arr.shape[0])
        return cls(arr.shape[0], idx, arr[idx], _checked=True)

    def to_dense(self) -> np.ndarray:
        """The dense values (src/sparsevec.c:663-720)."""
        out = np.zeros(self.dim, dtype=np.float32)
        out[self.indices] = self.values
        return out

    def to_vector(self) -> Vector:
        if self.dim > VECTOR_MAX_DIM:
            raise ProgramLimitExceeded(
                f"vector cannot have more than {VECTOR_MAX_DIM} dimensions")
        return Vector(self.to_dense())

    # -- text I/O (src/sparsevec.c:203-423) ----------------------------------
    @classmethod
    def from_text(cls, lit: str, typmod: int = -1) -> "SparseVec":
        if lit.count(",") + 1 > SPARSEVEC_MAX_NNZ:
            raise ProgramLimitExceeded(
                f"sparsevec cannot have more than {SPARSEVEC_MAX_NNZ} non-zero elements")
        i = _scan.skip_space(lit, 0)
        if i >= len(lit) or lit[i] != "{":
            raise _scan.bad_literal("sparsevec", lit,
                                    'Vector contents must start with "{".')
        i = _scan.skip_space(lit, i + 1)
        pairs: List[Tuple[int, np.float32]] = []
        if i < len(lit) and lit[i] == "}":
            i += 1
        else:
            while True:
                i = _scan.skip_space(lit, i)
                if i >= len(lit):
                    raise _scan.bad_literal("sparsevec", lit)
                index, i = _parse_long(lit, i)
                i = _scan.skip_space(lit, i)
                if i >= len(lit) or lit[i] != ":":
                    raise _scan.bad_literal("sparsevec", lit)
                i = _scan.skip_space(lit, i + 1)
                val, end, text = _scan.strtof(lit, i)
                if val is None:
                    raise _scan.bad_literal("sparsevec", lit)
                f = _scan.narrow_f32(val, text, "sparsevec")
                if np.isnan(f):
                    raise DataException("NaN not allowed in sparsevec")
                if np.isinf(f):
                    raise DataException("infinite value not allowed in sparsevec")
                pairs.append((index, f))
                i = _scan.skip_space(lit, end)
                if i < len(lit) and lit[i] == ",":
                    i += 1
                elif i < len(lit) and lit[i] == "}":
                    i += 1
                    break
                else:
                    raise _scan.bad_literal("sparsevec", lit)
        i = _scan.skip_space(lit, i)
        if i >= len(lit) or lit[i] != "/":
            raise _scan.bad_literal("sparsevec", lit,
                                    'Unexpected end of input. Expected "/".')
        i = _scan.skip_space(lit, i + 1)
        dim, i = _parse_long(lit, i)
        i = _scan.skip_space(lit, i)
        if i != len(lit):
            raise _scan.bad_literal("sparsevec", lit, "Junk after dimensions.")
        _check_dim(dim)
        _check_expected_dim(typmod, dim)
        # sorted by index; text indices are 1-based (src/sparsevec.c:376-408)
        pairs.sort(key=lambda p: p[0])
        indices, values = [], []
        prev = None
        for index, f in pairs:
            zero_based = index - 1
            if zero_based < 0 or zero_based >= dim:
                raise DataException("sparsevec index out of bounds")
            if zero_based == prev:
                raise DataException("sparsevec indices must not contain duplicates")
            prev = zero_based
            if f != 0:  # zeros are never stored
                indices.append(zero_based)
                values.append(f)
        return cls(dim, np.array(indices, dtype=np.int32),
                   np.array(values, dtype=np.float32), _checked=True)

    def to_text(self) -> str:
        """sparsevec_out, 1-based indices."""
        body = ",".join(f"{int(i) + 1}:{_scan.format_f32(v)}"
                        for i, v in zip(self.indices, self.values))
        return "{" + body + "}/" + str(self.dim)

    # -- binary I/O (src/sparsevec.c:505-585) --------------------------------
    @classmethod
    def from_binary(cls, data: bytes, typmod: int = -1) -> "SparseVec":
        dim, nnz, unused = struct.unpack_from(">iii", data, 0)
        _check_dim(dim)
        _check_nnz(nnz, dim)
        _check_expected_dim(typmod, dim)
        if unused != 0:
            raise DataException(f"expected unused to be 0, not {unused}")
        idx = np.frombuffer(data, dtype=">i4", count=nnz,
                            offset=12).astype(np.int32)
        val = np.frombuffer(data, dtype=">f4", count=nnz,
                            offset=12 + 4 * nnz).astype(np.float32)
        if (val == 0).any():
            raise DataException(
                "binary representation of sparsevec cannot contain zero values")
        return cls(dim, idx, val)

    def to_binary(self) -> bytes:
        return (struct.pack(">iii", self.dim, self.nnz, 0)
                + self.indices.astype(">i4").tobytes()
                + self.values.astype(">f4").tobytes())

    # -- distances (merge-join semantics, f32 accumulation) ------------------
    def _check_dims(self, other: "SparseVec") -> None:
        if self.dim != other.dim:
            raise DataException(
                f"different sparsevec dimensions {self.dim} and {other.dim}")

    def _join(self, other: "SparseVec"):
        _, ia, ib = np.intersect1d(self.indices, other.indices,
                                   assume_unique=True, return_indices=True)
        return ia, ib

    def _only(self, ia, other: "SparseVec", ib):
        mask_a = np.ones(self.nnz, dtype=bool)
        mask_a[ia] = False
        mask_b = np.ones(other.nnz, dtype=bool)
        mask_b[ib] = False
        return self.values[mask_a], other.values[mask_b]

    def l2_squared_distance(self, other: "SparseVec") -> float:
        """SparsevecL2SquaredDistance (src/sparsevec.c:822-865)."""
        self._check_dims(other)
        ia, ib = self._join(other)
        d = np.float32(0)
        d += np.sum((self.values[ia] - other.values[ib]) ** 2, dtype=np.float32)
        a_only, b_only = self._only(ia, other, ib)
        d += np.sum(a_only ** 2, dtype=np.float32)
        d += np.sum(b_only ** 2, dtype=np.float32)
        return float(np.float32(d))

    def l2_distance(self, other: "SparseVec") -> float:
        return math.sqrt(self.l2_squared_distance(other))

    def inner_product(self, other: "SparseVec") -> float:
        """SparsevecInnerProduct (src/sparsevec.c:901-932)."""
        self._check_dims(other)
        ia, ib = self._join(other)
        return float(np.float32(np.dot(self.values[ia], other.values[ib])))

    def negative_inner_product(self, other: "SparseVec") -> float:
        return -self.inner_product(other)

    def cosine_distance(self, other: "SparseVec") -> float:
        """sparsevec_cosine_distance (src/sparsevec.c:967-1007)."""
        self._check_dims(other)
        sim = np.float32(self.inner_product(other))
        na = np.float32(np.dot(self.values, self.values))
        nb = np.float32(np.dot(other.values, other.values))
        with np.errstate(divide="ignore", invalid="ignore"):
            similarity = float(np.float64(sim)
                               / np.sqrt(np.float64(na) * np.float64(nb)))
        if not math.isnan(similarity):
            similarity = min(1.0, max(-1.0, similarity))
        return 1.0 - similarity

    def l1_distance(self, other: "SparseVec") -> float:
        """sparsevec_l1_distance (src/sparsevec.c:1012-1056)."""
        self._check_dims(other)
        ia, ib = self._join(other)
        d = np.sum(np.abs(self.values[ia] - other.values[ib]), dtype=np.float32)
        a_only, b_only = self._only(ia, other, ib)
        d += np.sum(np.abs(a_only), dtype=np.float32)
        d += np.sum(np.abs(b_only), dtype=np.float32)
        return float(np.float32(d))

    # -- norm and normalize (src/sparsevec.c:1061-1100, f64) -----------------
    def norm(self) -> float:
        a = self.values.astype(np.float64)
        return math.sqrt(float(np.dot(a, a)))

    def l2_normalize(self) -> "SparseVec":
        norm = self.norm()
        if norm > 0:
            rx = (self.values.astype(np.float64) / norm).astype(np.float32)
            if np.isinf(rx).any():
                raise NumericValueOutOfRange(_OVERFLOW)
            return SparseVec(self.dim, self.indices.copy(), rx, _checked=True)
        return SparseVec(self.dim, np.empty(0, np.int32),
                         np.empty(0, np.float32), _checked=True)

    # -- ordering as if dense (src/sparsevec.c:1189-1280) --------------------
    def compare(self, other: "SparseVec") -> int:
        # walk the union of indices in order; a missing index is 0
        ai = bi = 0
        big = np.iinfo(np.int32).max
        while ai < self.nnz or bi < other.nnz:
            an = self.indices[ai] if ai < self.nnz else big
            bn = other.indices[bi] if bi < other.nnz else big
            pos = min(an, bn)
            if pos >= min(self.dim, other.dim):
                break
            av = self.values[ai] if an == pos else np.float32(0)
            bv = other.values[bi] if bn == pos else np.float32(0)
            if av < bv:
                return -1
            if av > bv:
                return 1
            if an == pos:
                ai += 1
            if bn == pos:
                bi += 1
        # every compared position is equal: the dims decide, values before
        # dims as vector_cmp_internal (src/vector.c:1030-1052)
        if self.dim != other.dim:
            return -1 if self.dim < other.dim else 1
        return 0

    def __lt__(self, o):
        return self.compare(o) < 0

    def __le__(self, o):
        return self.compare(o) <= 0

    def __eq__(self, o):
        return isinstance(o, SparseVec) and self.compare(o) == 0

    def __ne__(self, o):
        return not self.__eq__(o)

    def __ge__(self, o):
        return self.compare(o) >= 0

    def __gt__(self, o):
        return self.compare(o) > 0

    def __hash__(self) -> int:
        return hash((self.dim, self.indices.tobytes(), self.values.tobytes()))

    def __repr__(self) -> str:
        return f"SparseVec({self.to_text()!r})"
