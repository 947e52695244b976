"""Ordered (btree-opclass) index — counterpart of
``pgvector_tpu.index.btree``: the analogue of the reference's btree
operator classes over vector values (sql/vector.sql:300-346 `vector_ops`,
810-817 `halfvec_ops`, 1180-1187 `sparsevec_ops`; behavior pinned by
test/sql/btree.sql): equality and range predicates over the memcmp-style
total ordering (values element-by-element, then dims — vector.c:1030-1143),
plus ordered scans.

Design: a sorted permutation of live row ids.  Dense rows sort by a
byte-comparable key built with the IEEE-754 total-order transform (sign
bit flip for non-negatives, full complement for negatives), which makes
lexicographic byte order equal elementwise float order — so lookups are
O(log n) bisects on a bytes list instead of compare callbacks.  Negative
zeros canonicalize to +0.0 first (float comparison treats them equal,
vector.c:1060).  Sparse rows compare as-if-dense (sparsevec.c:1189-1280),
which has no finite byte encoding at dim ≤ 1e9 — they sort by the
SparseVec compare itself.

This is a host-side structure by design: the reference's btree indexes are
also CPU-side Postgres btrees.  The table's rows live on its device; every
build, insert and vacuum takes one device→host copy for its whole block of
rows (a copy per row would be a million transfers at 1M rows), and a
lookup copies only the validity of the rows it returns.
"""

from __future__ import annotations

import bisect
import functools
import heapq
from typing import List, Tuple

import numpy as np
import torch

from ..errors import DataException
from ..ops.distance import pack_bits
from ..store.table import BitTable, DenseTable, SparseTable
from ..types import Bit, HalfVec, SparseVec, Vector


def _dense_keys(block: np.ndarray) -> List[bytes]:
    """IEEE-754 total-order byte keys for a (R, D) block: big-endian
    transformed uint32 per element; byte order == elementwise float order
    for finite floats."""
    x = np.ascontiguousarray(np.atleast_2d(block), np.float32)
    x = np.where(x == 0.0, np.float32(0.0), x)  # -0.0 == +0.0 (vector.c:1060)
    bits = x.view(np.uint32)
    neg = bits >> 31 == 1
    t = np.where(neg, ~bits, bits | np.uint32(0x80000000)).astype(">u4")
    return [row.tobytes() for row in t]


def _dense_key(row: np.ndarray) -> bytes:
    return _dense_keys(np.asarray(row, np.float32)[None])[0]


def _word_keys(words: np.ndarray) -> List[bytes]:
    """Bit rows' keys: the packed words as big-endian uint32 (the port
    keeps them as int32 tensors holding the same bit patterns)."""
    w = np.atleast_2d(np.asarray(words, np.int32)).view(np.uint32)
    return [r.tobytes() for r in w.astype(">u4")]


def _sparse_item_cmp(a: Tuple, b: Tuple) -> int:
    """Total order on (SparseVec key, row id) pairs (sparsevec.c:1189-1280
    as-if-dense compare, row id as tie-break)."""
    return a[0].compare(b[0]) or (a[1] - b[1])


class OrderedIndex:
    """Sorted-permutation index over a table's total value ordering.

    Supports the btree opclass surface: ``search_eq`` (=), ``search_range``
    (< <= >= > between), and ``scan`` (ORDER BY value).  Maintained online
    by ``insert``/``vacuum`` like the AM indexes."""

    def __init__(self, table, build: bool = True):
        if not isinstance(table, (DenseTable, BitTable, SparseTable)):
            raise DataException(
                f"btree does not support {type(table).__name__}")
        self.table = table
        self._keys: List = []
        self._rows: List[int] = []
        if build:
            self.build()

    # ------------------------------------------------------------------ keys
    def _row_keys(self, rows: np.ndarray) -> List:
        """Keys for a row-id batch — one device gather and one host copy
        for the whole batch."""
        t = self.table
        sel = torch.as_tensor(np.asarray(rows, np.int64), device=t.device)
        if isinstance(t, DenseTable):
            return _dense_keys(t.data[sel].float().cpu().numpy())
        if isinstance(t, BitTable):
            return _word_keys(t.data[sel].cpu().numpy())
        idx_b = np.atleast_2d(t.idx[sel].cpu().numpy())
        val_b = np.atleast_2d(t.val[sel].cpu().numpy())
        pad = int(t.pad_index)
        return [
            SparseVec(t.dim, i[i != pad], v[i != pad], _checked=True)
            for i, v in zip(idx_b, val_b)
        ]

    def _value_key(self, value):
        t = self.table
        if isinstance(t, DenseTable):
            if isinstance(value, (Vector, HalfVec)):
                value = value.x
            arr = np.asarray(value, np.float32)
            if arr.shape != (t.dim,):
                raise DataException(
                    f"different vector dimensions {arr.shape[-1]} and {t.dim}")
            return _dense_key(arr)
        if isinstance(t, BitTable):
            if isinstance(value, Bit):
                value = value.bits
            arr = np.asarray(value, bool)
            if arr.shape != (t.dim,):
                raise DataException(
                    f"different bit lengths {arr.shape[-1]} and {t.dim}")
            return _word_keys(pack_bits(arr[None]).numpy())[0]
        if not isinstance(value, SparseVec):
            raise DataException("sparsevec btree lookups take a SparseVec")
        if value.dim != t.dim:
            raise DataException(
                f"different sparsevec dimensions {value.dim} and {t.dim}")
        return value

    # ----------------------------------------------------------------- build
    @staticmethod
    def _sort_items(items: List[Tuple]) -> None:
        """Sort (key, row-id) pairs in place; sparse keys are compare-based,
        bytes keys are memcmp — tie-break on row id for a deterministic
        scan order."""
        if items and isinstance(items[0][0], SparseVec):
            items.sort(key=functools.cmp_to_key(_sparse_item_cmp))
        else:
            items.sort()

    def build(self) -> None:
        t = self.table
        live = np.flatnonzero(t.valid[: t.count].cpu().numpy())
        items = list(zip(self._row_keys(live), live.tolist()))
        self._sort_items(items)
        self._keys = [k for k, _ in items]
        self._rows = [r for _, r in items]

    # -------------------------------------------------------------- mutation
    def insert(self, rows) -> None:
        """Bulk insert: sort the batch once, then single-pass sorted-merge
        with the existing permutation — O(n + b·log b) for a b-row batch
        instead of O(n·b) per-row list.insert.  The merge keys on
        (key, row-id), preserving build()'s order within equal-key runs so
        an incrementally maintained index scans duplicates identically to
        a rebuilt one."""
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        if rows.size == 0:
            return
        items = list(zip(self._row_keys(rows), rows.tolist()))
        self._sort_items(items)
        if not self._keys:
            merged = items
        elif isinstance(items[0][0], SparseVec):
            merged = list(heapq.merge(
                zip(self._keys, self._rows), items,
                key=functools.cmp_to_key(_sparse_item_cmp)))
        else:
            merged = list(heapq.merge(zip(self._keys, self._rows), items))
        self._keys = [k for k, _ in merged]
        self._rows = [r for _, r in merged]

    def vacuum(self) -> None:
        valid = self.table.valid.cpu().numpy()
        keep = [(k, r) for k, r in zip(self._keys, self._rows) if valid[r]]
        self._keys = [k for k, _ in keep]
        self._rows = [r for _, r in keep]

    # ----------------------------------------------------------------- scans
    def _bisect(self, key, side: str) -> int:
        if isinstance(key, SparseVec):
            lo, hi = 0, len(self._keys)
            while lo < hi:
                mid = (lo + hi) // 2
                c = self._keys[mid].compare(key)
                if c < 0 or (side == "right" and c == 0):
                    lo = mid + 1
                else:
                    hi = mid
            return lo
        fn = bisect.bisect_right if side == "right" else bisect.bisect_left
        return fn(self._keys, key)

    def _live(self, rows: List[int]) -> np.ndarray:
        """The live ones of ``rows``, in order: one gather of their
        validity on the table's device."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return rows
        valid = self.table.valid
        ok = valid[torch.as_tensor(rows, device=valid.device)].cpu().numpy()
        return rows[ok]

    def search_eq(self, value) -> np.ndarray:
        """``column = value`` — all rows whose stored value equals, in row
        order (test/sql/btree.sql equality scans)."""
        key = self._value_key(value)
        lo = self._bisect(key, "left")
        hi = self._bisect(key, "right")
        return self._live(sorted(self._rows[lo:hi]))

    def search_range(self, lo=None, hi=None, lo_inc: bool = True,
                     hi_inc: bool = True) -> np.ndarray:
        """Range predicate over the total ordering (``>`` ``>=`` ``<``
        ``<=`` and BETWEEN compositions), rows in value order."""
        a = 0 if lo is None else self._bisect(
            self._value_key(lo), "left" if lo_inc else "right")
        b = len(self._rows) if hi is None else self._bisect(
            self._value_key(hi), "right" if hi_inc else "left")
        return self._live(self._rows[a:b])

    def scan(self, ascending: bool = True) -> np.ndarray:
        """ORDER BY column [DESC] over live rows."""
        rows = self._live(self._rows)
        return rows if ascending else rows[::-1]
