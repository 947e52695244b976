"""Device-resident vector tables — counterpart of
``pgvector_tpu.store.table``:

- :class:`DenseTable` — ``float32`` / ``bfloat16`` / ``float16`` (cap, D)
  (the ``vector`` / ``halfvec`` column)
- :class:`BitTable` — packed words (cap, ceil(D/32)) (the ``bit`` column),
  int32 tensors holding the reference's uint32 bit patterns
- :class:`SparseTable` — padded CSR rows, ``int32`` indices and ``float32``
  values (cap, nnz_cap) (the ``sparsevec`` column)

A table is a padded device tensor (or two) plus a validity mask.  Rows are
addressed by their insertion index (the heap TID analogue); deletes flip
the mask (dead tuples), and indexes consult it the way index scans consult
the heap.  Appends past the capacity grow it to the next power of two.
Every index inherits the table's ``device``, which is the card unless the
caller names another (``device="cpu"``).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..errors import DataException
from ..ops.distance import SPARSE_PAD, pack_bits
from ..types import Bit, HalfVec, SparseVec, Vector


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _initial_cap(requested: int) -> int:
    """Explicitly-requested capacities are honored, rounded up to a
    256-row multiple (at least 1024) instead of pow2-padded; growth past
    the initial capacity doubles."""
    return max(-(-requested // 256) * 256, 1024)


def _resolve_device(device) -> torch.device:
    """The caller's device, or the card when none is named.  Without a card
    an unnamed device is an error, never a quiet move to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise DataException(
            'no CUDA device: tables live on the card by default; '
            'pass device="cpu" to keep one on the CPU')
    return torch.device("cuda", torch.cuda.current_device())


class BaseTable:
    """Shared row bookkeeping: count, capacity, validity mask."""

    def __init__(self, capacity: int, device=None):
        self.device = _resolve_device(device)
        self.count = 0
        self.capacity = capacity
        self.valid = torch.zeros(capacity, dtype=torch.bool,
                                 device=self.device)

    def __len__(self) -> int:
        return self.count

    @property
    def live_count(self) -> int:
        return int(self.valid.sum())

    def delete(self, rows: Union[int, Sequence[int], np.ndarray]) -> None:
        """Mark rows dead (the DELETE analogue)."""
        rows = torch.as_tensor(np.atleast_1d(np.asarray(rows, np.int64)),
                               device=self.device)
        self.valid[rows] = False

    def _grow_to(self, n: int, arrays, fills) -> tuple:
        """Grow ``arrays`` (leading axis = capacity) and the mask to hold
        ``n`` rows: the next power of two, new rows filled with ``fills``."""
        if n <= self.capacity:
            return tuple(arrays)
        new_cap = _next_pow2(n)
        out = tuple(torch.cat([a, a.new_full((new_cap - self.capacity,)
                                             + tuple(a.shape[1:]), f)])
                    for a, f in zip(arrays, fills))
        self._grow_mask(new_cap)
        return out

    def _grow_mask(self, new_cap: int) -> None:
        self.valid = torch.cat([
            self.valid,
            torch.zeros(new_cap - self.capacity, dtype=torch.bool,
                        device=self.device)])
        self.capacity = new_cap


class DenseTable(BaseTable):
    """Dense vector column: ``float32`` for ``vector``; ``bfloat16`` or
    ``float16`` for ``halfvec``."""

    def __init__(self, dim: int, dtype=torch.float32, capacity: int = 1024,
                 device=None):
        if dim < 1:
            raise DataException("vector must have at least 1 dimension")
        super().__init__(_initial_cap(capacity), device)
        self.dim = dim
        self.dtype = dtype
        self.data = torch.zeros((self.capacity, dim), dtype=dtype,
                                device=self.device)

    def _coerce(self, vectors) -> np.ndarray:
        if isinstance(vectors, (Vector, HalfVec)):
            vectors = vectors.x[None, :]
        elif isinstance(vectors, (list, tuple)) and vectors and isinstance(
            vectors[0], (Vector, HalfVec)
        ):
            vectors = np.stack([v.x for v in vectors])
        arr = np.asarray(vectors)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.shape[1] != self.dim:
            raise DataException(
                f"expected {self.dim} dimensions, not {arr.shape[1]}"
            )
        return arr

    def insert(self, vectors) -> np.ndarray:
        """Append rows; returns their row ids."""
        arr = self._coerce(vectors)
        n = arr.shape[0]
        start = self.count
        (self.data,) = self._grow_to(start + n, (self.data,), (0,))
        # in place, where the reference donates the buffers to its append
        # kernel (_append_block): no second table-sized copy
        block = torch.as_tensor(np.ascontiguousarray(arr))
        self.data[start:start + n].copy_(block.to(self.dtype))
        self.valid[start:start + n] = True
        self.count = start + n
        return np.arange(start, start + n, dtype=np.int32)

    def get(self, row: int) -> np.ndarray:
        return self.data[row].cpu().numpy()


class BitTable(BaseTable):
    """Packed bit column: int32 words with the reference's uint32 bit
    patterns, MSB first (:func:`..ops.distance.pack_bits`)."""

    def __init__(self, dim: int, capacity: int = 1024, device=None):
        if dim < 1:
            raise DataException("bit must have at least 1 dimension")
        super().__init__(_initial_cap(capacity), device)
        self.dim = dim
        self.words = -(-dim // 32)
        self.data = torch.zeros((self.capacity, self.words), dtype=torch.int32,
                                device=self.device)

    def _coerce(self, bits):
        """Bit values, or bools (…, dim) as numpy or a tensor."""
        if isinstance(bits, Bit):
            bits = bits.bits[None, :]
        elif isinstance(bits, (list, tuple)) and bits and isinstance(
                bits[0], Bit):
            bits = np.stack([b.bits for b in bits])
        if not torch.is_tensor(bits):
            bits = np.asarray(bits, dtype=bool)
        if bits.ndim == 1:
            bits = bits[None, :]
        if bits.shape[1] != self.dim:
            raise DataException(
                f"different bit lengths {self.dim} and {bits.shape[1]}")
        return bits

    def insert(self, bits) -> np.ndarray:
        """Append rows of bits; returns their row ids."""
        packed = pack_bits(self._coerce(bits)).to(self.device)
        return self.insert_words(packed)

    def insert_words(self, words) -> np.ndarray:
        """Append rows of packed words (N, words), int32 or uint32 bit
        patterns; returns their row ids."""
        if not torch.is_tensor(words):
            words = torch.from_numpy(
                np.ascontiguousarray(words).view(np.int32))
        if words.ndim != 2 or words.shape[1] != self.words:
            raise DataException(
                f"expected {self.words} words a row, not {tuple(words.shape)}")
        n = words.shape[0]
        start = self.count
        (self.data,) = self._grow_to(start + n, (self.data,), (0,))
        self.data[start:start + n].copy_(words.to(torch.int32))
        self.valid[start:start + n] = True
        self.count = start + n
        return np.arange(start, start + n, dtype=np.int32)

    def get(self, row: int) -> Bit:
        w = self.data[row].cpu().numpy().view(np.uint32).astype(">u4")
        return Bit(np.unpackbits(w.view(np.uint8))[: self.dim].astype(bool))


class SparseTable(BaseTable):
    """Sparse column: fixed-width padded CSR rows.  ``nnz_cap`` is the
    per-row slot budget (a row with more non-zeros is refused, the
    analogue of the 16,000-nnz limit, src/sparsevec.h:12); pads hold
    ``pad_index`` (SPARSE_PAD) and 0.  ``version`` counts inserts (the
    densified copies of exact search key on it)."""

    def __init__(self, dim: int, nnz_cap: int = 128, capacity: int = 1024,
                 device=None):
        if dim < 1:
            raise DataException("sparsevec must have at least 1 dimension")
        super().__init__(_initial_cap(capacity), device)
        self.dim = dim
        self.nnz_cap = nnz_cap
        self.pad_index = SPARSE_PAD
        self.idx = torch.full((self.capacity, nnz_cap), SPARSE_PAD,
                              dtype=torch.int32, device=self.device)
        self.val = torch.zeros((self.capacity, nnz_cap), dtype=torch.float32,
                               device=self.device)
        self.version = 0

    def insert(self, vectors: Sequence[SparseVec]) -> np.ndarray:
        """Append SparseVec rows; returns their row ids."""
        if isinstance(vectors, SparseVec):
            vectors = [vectors]
        n = len(vectors)
        idx_block = np.full((n, self.nnz_cap), SPARSE_PAD, dtype=np.int32)
        val_block = np.zeros((n, self.nnz_cap), dtype=np.float32)
        for r, sv in enumerate(vectors):
            if sv.dim != self.dim:
                raise DataException(
                    f"expected {self.dim} dimensions, not {sv.dim}")
            if sv.nnz > self.nnz_cap:
                raise DataException(
                    f"sparsevec cannot have more than {self.nnz_cap} "
                    "non-zero elements for this table")
            idx_block[r, : sv.nnz] = sv.indices
            val_block[r, : sv.nnz] = sv.values
        return self.insert_arrays(idx_block, val_block, _checked=True)

    def insert_arrays(self, idx, val, _checked: bool = False) -> np.ndarray:
        """Append padded CSR rows: ``idx`` (N, P ≤ nnz_cap) int32 indices,
        ascending and distinct, padded with SPARSE_PAD; ``val`` (N, P) f32,
        non-zero at the indices and 0 at the pads (numpy or tensors).
        Returns their row ids."""
        idx = torch.as_tensor(idx, dtype=torch.int32)
        val = torch.as_tensor(val, dtype=torch.float32)
        n, p = idx.shape
        if val.shape != idx.shape or p > self.nnz_cap:
            raise DataException(
                f"sparse rows of shape {tuple(idx.shape)} / "
                f"{tuple(val.shape)} do not fit {self.nnz_cap} slots")
        if not _checked:
            _check_csr(idx, val, self.dim)
        start = self.count
        self.idx, self.val = self._grow_to(start + n, (self.idx, self.val),
                                           (SPARSE_PAD, 0.0))
        self.idx[start:start + n, :p].copy_(idx)
        self.val[start:start + n, :p].copy_(val)
        self.valid[start:start + n] = True
        self.count = start + n
        self.version += 1
        return np.arange(start, start + n, dtype=np.int32)

    def get(self, row: int) -> SparseVec:
        idx = self.idx[row].cpu().numpy()
        val = self.val[row].cpu().numpy()
        live = idx < self.pad_index
        return SparseVec(self.dim, idx[live], val[live], _checked=True)


def _check_csr(idx: torch.Tensor, val: torch.Tensor, dim: int) -> None:
    """SparseVec's checks over padded rows, vectorized: in-bounds indices,
    ascending and distinct, pads only after the entries, finite non-zero
    values and zero pads."""
    live = idx != SPARSE_PAD
    if bool(((idx < 0) | (live & (idx >= dim))).any()):
        raise DataException("sparsevec index out of bounds")
    if idx.shape[1] > 1:
        a, b = idx[:, :-1], idx[:, 1:]
        if bool((live[:, 1:] & ~live[:, :-1]).any()) or \
                bool((live[:, 1:] & (b <= a)).any()):
            raise DataException(
                "sparsevec indices must be ascending and distinct")
    if not bool(torch.isfinite(val).all()):
        raise DataException("sparsevec values must be finite")
    if bool((live & (val == 0)).any()) or bool((~live & (val != 0)).any()):
        raise DataException(
            "sparse rows hold non-zero values at indices and 0 at pads")
