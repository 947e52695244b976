"""Device-resident vector tables — counterpart of
``pgvector_tpu.store.table`` (the dense table; bit and sparse tables come
later).

A table is a padded device tensor plus a validity mask.  Rows are
addressed by their insertion index (the heap TID analogue); deletes flip
the mask (dead tuples), and indexes consult it the way index scans consult
the heap.  Appends past the capacity grow it to the next power of two.
Every index inherits the table's ``device``.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..errors import DataException
from ..types import HalfVec, Vector


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


class BaseTable:
    """Shared row bookkeeping: count, capacity, validity mask."""

    def __init__(self, capacity: int, device=None):
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
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
        if start + n > self.capacity:
            new_cap = _next_pow2(start + n)
            self.data = torch.cat([
                self.data,
                torch.zeros((new_cap - self.capacity, self.dim),
                            dtype=self.dtype, device=self.device)])
            self._grow_mask(new_cap)
        # in place, where the reference donates the buffers to its append
        # kernel (_append_block): no second table-sized copy
        block = torch.as_tensor(np.ascontiguousarray(arr))
        self.data[start:start + n].copy_(block.to(self.dtype))
        self.valid[start:start + n] = True
        self.count = start + n
        return np.arange(start, start + n, dtype=np.int32)

    def get(self, row: int) -> np.ndarray:
        return self.data[row].cpu().numpy()
