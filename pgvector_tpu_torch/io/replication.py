"""Incremental replication — delta shipping between a primary and replicas,
counterpart of ``pgvector_tpu.io.replication`` in the same record format:
a log written by either package replays in the other.

The reference keeps replicas current by streaming Generic WAL records for
every page mutation (tested by running the same KNN query on primary and
replica after each insert/delete/vacuum cycle, test/t/001_wal.pl:16-44).
The array-native analogue is a LOGICAL delta log: the primary appends one
record per mutation batch (op + row ids + the row values for inserts); a
replica that starts from the same base checkpoint replays the log and
reaches an IDENTICAL index state, because

- every device program of the insert and vacuum paths is deterministic
  given identical inputs (no atomics whose order could differ: the
  visited-set inserts are scatter-max, the merges stable sorts), and
- the only randomness — HNSW level assignment — replays identically since
  checkpoints capture the level rng state (io/checkpoint.py).

So "same query → same result" holds exactly, not just statistically: the
replica's graph arrays are bit-equal to the primary's after replay.

Usage::

    log = ReplicationLog(dir)                      # primary side
    rel = Relation(table); rel.replication_log = log  # or call log_* manually
    log.log_insert(table, rows); log.log_delete(rows); log.log_vacuum()

    applied = apply_deltas(table2, [idx2], dir, start_seq=0)   # replica
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Sequence

import numpy as np
import torch

from ..errors import DataException
from ..store.table import BitTable, DenseTable, SparseTable
# one bfloat16-as-tagged-uint16 file convention, owned by io.checkpoint
from .checkpoint import _fsync_dir, _load, _save_arrays

_MAGIC = "pgvector-tpu-delta"
_VERSION = 1
# committed records only — a crashed append's "delta_NNN.tmp" must not match
_DELTA_RE = re.compile(r"^delta_(\d{8})$")


class ReplicationLog:
    """Append-only logical delta log (one subdirectory per record)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        # next seq = one past the HIGHEST existing record, not the entry
        # count: a log with a gap (pruned/lost record) must never re-issue
        # a used sequence number — overwriting history in place would hand
        # replicas different content at an already-replayed seq
        entries = self._entries()
        self.seq = (int(entries[-1].split("_")[1]) + 1) if entries else 0

    def _entries(self) -> List[str]:
        return sorted(d for d in os.listdir(self.path)
                      if _DELTA_RE.match(d))

    def _record(self, payload: dict, arrays: dict) -> None:
        """Append one record crash-atomically: stage the whole record in a
        hidden tmp dir (never matched by ``_entries``), fsync its contents,
        then rename into place — the logical-WAL analogue of GenericXLog's
        all-or-nothing page records (src/hnswinsert.c:695-743).  A crash
        mid-append leaves at most an ignorable ``.tmp`` dir."""
        final = os.path.join(self.path, f"delta_{self.seq:08d}")
        tmp = final + ".tmp"
        if os.path.isdir(tmp):  # leftover from a crashed append
            for fn in os.listdir(tmp):
                os.remove(os.path.join(tmp, fn))
        else:
            os.makedirs(tmp)
        _save_arrays(tmp, arrays, 0)  # fsyncs each array file
        payload.update({"magic": _MAGIC, "version": _VERSION, "seq": self.seq})
        with open(os.path.join(tmp, "record.json"), "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.rename(tmp, final)
        _fsync_dir(self.path)
        self.seq += 1

    def prune(self, upto_seq: int) -> int:
        """Drop records with seq < ``upto_seq`` (a checkpoint base already
        containing their effects — take ``log.seq`` right after saving the
        checkpoint and pass it here).  Replicas bootstrapped from that
        checkpoint replay with ``start_seq=upto_seq``; older replicas will
        hit the gap check in :func:`apply_deltas` and re-bootstrap instead
        of silently diverging.  Returns the number of records removed."""
        removed = 0
        for name in self._entries():
            if int(name.split("_")[1]) >= upto_seq:
                break
            d = os.path.join(self.path, name)
            for fn in os.listdir(d):
                os.remove(os.path.join(d, fn))
            os.rmdir(d)
            removed += 1
        if removed:
            _fsync_dir(self.path)
        return removed

    # ------------------------------------------------------------- producers
    def log_insert(self, table, rows: Sequence[int]) -> None:
        """Record an insert batch: row ids + their stored values (the
        replica re-inserts the same values and must land on the same ids)."""
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        sel = torch.as_tensor(rows, device=table.device)
        if isinstance(table, BitTable):
            # (R, W) packed MSB-first, the int32 words as uint32
            words = table.data[sel].cpu().numpy().view(np.uint32)
            shifts = np.arange(31, -1, -1, dtype=np.uint32)
            bits = ((words[:, :, None] >> shifts) & 1).reshape(len(rows), -1)
            arrays = {"rows": rows,
                      "data": bits[:, : table.dim].astype(bool)}
            kind = "bit"
        elif isinstance(table, DenseTable):
            # the stored dtype; bfloat16 goes to the tagged uint16 file
            arrays = {"rows": rows, "data": table.data[sel]}
            kind = "dense"
        elif isinstance(table, SparseTable):
            arrays = {"rows": rows, "idx": table.idx[sel],
                      "val": table.val[sel]}
            kind = "sparse"
        else:
            raise DataException(f"cannot replicate {type(table).__name__}")
        self._record({"op": "insert", "kind": kind}, arrays)

    def log_delete(self, rows: Sequence[int]) -> None:
        self._record({"op": "delete"},
                     {"rows": np.atleast_1d(np.asarray(rows, np.int64))})

    def log_vacuum(self) -> None:
        self._record({"op": "vacuum"}, {})


def _load_arr(path: str, name: str):
    """A record's array (records use the epoch-less file names)."""
    return _load(path, name, 0)


def apply_deltas(table, indexes, path: str, start_seq: int = 0) -> int:
    """Replay deltas ``start_seq..`` onto a replica's table + indexes.

    Returns the next sequence number (pass it back as ``start_seq`` on the
    next catch-up — replicas stay current incrementally instead of
    re-copying full snapshots).  The replica must have started from the
    same base state the log's records assume; a row-id mismatch on replay
    means it did not and raises."""
    entries = sorted(d for d in os.listdir(path) if _DELTA_RE.match(d))
    seq = start_seq
    for name in entries:
        rec_seq = int(name.split("_")[1])
        if rec_seq < start_seq:
            continue
        if rec_seq != seq:
            # a gap means a lost mutation: replaying past it would build a
            # silently divergent replica that LOOKS caught up
            raise DataException(
                f"delta log gap: expected seq {seq}, found {rec_seq} — "
                f"re-bootstrap the replica from a newer base checkpoint")
        d = os.path.join(path, name)
        with open(os.path.join(d, "record.json")) as f:
            rec = json.load(f)
        if rec.get("magic") != _MAGIC:
            raise DataException("invalid delta record: bad magic")
        if rec.get("version") != _VERSION:
            raise DataException(
                f"unsupported delta record version {rec.get('version')}")
        if rec.get("seq") != rec_seq:
            raise DataException(
                f"delta record seq mismatch: dir {rec_seq}, "
                f"payload {rec.get('seq')}")
        if rec["op"] == "insert":
            rows = _load_arr(d, "rows")
            if rec["kind"] == "sparse":
                from ..types import SparseVec

                idx_a = _load_arr(d, "idx")
                val_a = _load_arr(d, "val")
                pad = table.pad_index
                vals = [SparseVec(table.dim, r_i[r_i != pad],
                                  r_v[r_i != pad], _checked=True)
                        for r_i, r_v in zip(idx_a, val_a)]
                got = table.insert(vals)
            else:  # dense and bit both re-insert raw value blocks
                data = _load_arr(d, "data")
                if torch.is_tensor(data):  # bfloat16: widening is exact
                    data = data.float().numpy()
                got = table.insert(data)
            if not np.array_equal(np.asarray(got, np.int64), rows):
                raise DataException(
                    "delta replay diverged: replica row ids differ from the "
                    "primary's (replica did not start from the log's base)")
            for ix in indexes:
                ix.insert(got)
        elif rec["op"] == "delete":
            table.delete(_load_arr(d, "rows"))
        elif rec["op"] == "vacuum":
            for ix in indexes:
                ix.vacuum()
        else:
            raise DataException(f"unknown delta op {rec['op']!r}")
        seq = rec_seq + 1
    return seq
