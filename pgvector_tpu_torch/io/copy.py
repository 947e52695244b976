"""Bulk load/dump — the COPY analogue, counterpart of
``pgvector_tpu.io.copy`` (reference test/sql/copy.sql tests text and
binary COPY round-trips of all four types).

Text format: one literal per line (``[1,2,3]`` / ``{1:0.5}/4`` / ``0101``).
Binary format: the per-value wire format (vector_recv/send layout)
concatenated, with a small header carrying count + kind — the reference's
bytes exactly, so a dump of either package loads into the other.  Dense
vector paths use the native C++ codec when available.

The target of a load is a table, or a :class:`~..relation.Relation`,
whose insert carries the rows through every index and the replication
log, as COPY into a table maintains its indexes.  A dump copies the
table's rows from its device once.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

import numpy as np
import torch

from .. import native
from ..errors import DataException, NumericValueOutOfRange
from ..ops.distance import unpack_bits
from ..relation import Relation
from ..store.table import BitTable, DenseTable, SparseTable
from ..types import Bit, SparseVec

_BIN_MAGIC = b"PGVTCOPY"


def _table_of(target):
    return target.table if isinstance(target, Relation) else target


def _check_dense_range(table: DenseTable, arr: np.ndarray) -> None:
    """Values must survive narrowing to the table's storage dtype:
    DenseTable.insert casts silently, so a 70000.0 loaded into a float16
    table would store +inf and break the no-NaN/inf invariant halfvec_in
    enforces (src/halfvec.c:90-102).  Narrowed by torch's round to nearest
    even, as the table stores it."""
    if torch.finfo(table.dtype).bits != 16:
        return
    wide = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    narrowed = wide.to(table.dtype).float().numpy()
    bad = np.isinf(narrowed) & np.isfinite(np.asarray(arr, np.float32))
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise NumericValueOutOfRange(
            f'"{float(arr[r, c])}" is out of range for type halfvec')


def copy_in_text(target, lines: Iterable[str]) -> np.ndarray:
    """Bulk insert from text literals.  Returns row ids."""
    table = _table_of(target)
    lines = [l.strip() for l in lines if l.strip()]
    if isinstance(table, DenseTable):
        arr = native.parse_vectors(lines, expected_dim=table.dim)
        _check_dense_range(table, arr)
        return target.insert(arr)
    if isinstance(table, SparseTable):
        return target.insert([SparseVec.from_text(l) for l in lines])
    if isinstance(table, BitTable):
        return target.insert([Bit.from_text(l) for l in lines])
    raise DataException(f"cannot COPY into {type(table).__name__}")


def _live_rows(table) -> np.ndarray:
    return np.flatnonzero(table.valid[: table.count].cpu().numpy())


def _bulk_sparse(table: SparseTable, live: np.ndarray):
    """Yield live rows as SparseVecs from TWO device→host copies —
    table.get() per row costs two tiny copies each (minutes of chatter
    at 1M rows)."""
    idx = table.idx[: table.count].cpu().numpy()[live]
    val = table.val[: table.count].cpu().numpy()[live]
    for ri, rv in zip(idx, val):
        m = ri < table.pad_index
        yield SparseVec(table.dim, ri[m], rv[m], _checked=True)


def _dense_rows(table: DenseTable, live: np.ndarray) -> np.ndarray:
    return table.data[: table.count].float().cpu().numpy()[live]


def _bit_rows(table: BitTable, live: np.ndarray) -> np.ndarray:
    bits = unpack_bits(table.data[: table.count], table.dim)
    return bits.cpu().numpy()[live].astype(bool)


def copy_out_text(table) -> List[str]:
    """Dump live rows as text literals (row order preserved; dead rows
    skipped, like COPY seeing only live tuples)."""
    table = _table_of(table)
    live = _live_rows(table)
    if isinstance(table, DenseTable):
        return native.format_vectors(_dense_rows(table, live))
    if isinstance(table, SparseTable):
        return [sv.to_text() for sv in _bulk_sparse(table, live)]
    if isinstance(table, BitTable):
        return ["".join("1" if b else "0" for b in row)
                for row in _bit_rows(table, live)]
    raise DataException(f"cannot COPY from {type(table).__name__}")


def copy_out_binary(table) -> bytes:
    """Binary dump: header {magic, kind, count} + wire-format values."""
    table = _table_of(table)
    live = _live_rows(table)
    if isinstance(table, DenseTable):
        body = native.encode_binary(_dense_rows(table, live))
        kind = b"V"
    elif isinstance(table, SparseTable):
        body = b"".join(sv.to_binary() for sv in _bulk_sparse(table, live))
        kind = b"S"
    elif isinstance(table, BitTable):
        parts = []
        for row in _bit_rows(table, live):
            b = Bit(row)
            parts.append(struct.pack(">i", b.dim) + b.to_bytes())
        body = b"".join(parts)
        kind = b"B"
    else:
        raise DataException(f"cannot COPY from {type(table).__name__}")
    return _BIN_MAGIC + kind + struct.pack(">q", len(live)) + body


def copy_in_binary(target, data: bytes) -> np.ndarray:
    """Binary load (round-trips copy_out_binary)."""
    table = _table_of(target)
    if data[:8] != _BIN_MAGIC:
        raise DataException("invalid binary copy data: bad magic")
    kind = data[8:9]
    (count,) = struct.unpack_from(">q", data, 9)
    body = data[17:]
    if kind == b"V":
        if not isinstance(table, DenseTable):
            raise DataException("binary data is vector, table is not dense")
        arr = native.decode_binary(body, count)
        if count and arr.shape[1] != table.dim:
            raise DataException(
                f"expected {table.dim} dimensions, not {arr.shape[1]}"
            )
        if count:
            _check_dense_range(table, arr)
        return target.insert(arr) if count else np.zeros(0, np.int32)
    if kind == b"S":
        vals = []
        off = 0
        for _ in range(count):
            dim, nnz, unused = struct.unpack_from(">iii", body, off)
            rowlen = 12 + 8 * nnz
            vals.append(SparseVec.from_binary(body[off: off + rowlen]))
            off += rowlen
        return target.insert(vals)
    if kind == b"B":
        vals = []
        off = 0
        for _ in range(count):
            (dim,) = struct.unpack_from(">i", body, off)
            nbytes = -(-dim // 8)
            vals.append(Bit.from_bytes(body[off + 4: off + 4 + nbytes], dim))
            off += 4 + nbytes
        return target.insert(vals)
    raise DataException("invalid binary copy data: unknown kind")
