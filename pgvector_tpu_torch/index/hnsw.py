"""HNSW index over a dense, bit or sparse table — counterpart of
``pgvector_tpu.index.hnsw``: build, insert, heap-TID dedup, search with
and without iterative scans, and the 4-pass vacuum.

Graph layout, as in the reference:

- ``values``    — the index's value copies (normalized for cosine): a
                  (cap, D) tensor (dense), (cap, W) int32 words (bit) or
                  an (idx, val) pair of padded (cap, P) rows (sparse);
                  they alias the table's tensors when rows map 1:1 to
                  elements
- ``nbr0``      — int32[cap, 2m] level-0 neighbors
- ``nbr_up``    — int32[cap_up, L, m] upper-level neighbors of the ~1/m
                  elements with level ≥ 1 (``up_slot`` maps element → row)
- ``kept0`` / ``kept_up`` — sticky heuristic-kept flags per neighbor slot
- ``levels``, ``elem_rows`` — host numpy bookkeeping (level per element,
                  up to 10 heap TIDs per element; -1 level = free slot)

Build and insert are wave-parallel: batches of elements search the frozen
graph together (``wave_search``), select neighbors together and merge
backlinks grouped by target — wholesale (``connect_level``) or, in
``incremental`` mode, one source at a time (``merge_backlinks``).  Levels
come from ``np.random.default_rng(seed)`` exactly as the reference draws
them, and freed slots are reused in the reference's order, so both
packages give every element the same slot and level.  With ``dedup``
(the default), rows whose values are byte-equal share one element of up
to 10 heap TIDs.

Search is Algorithm 5 (hnswscan.c:25-56).  On CUDA tables the layer-0 scan
of a dense index reads an adjacency-packed copy of the neighbor values
(f32, bf16 or int8 with a per-dim scale, sized to the card's memory by
:func:`auto_packed_dtype`) and runs each hop in K2; bit and sparse hops
gather rows (bit distances in K5).  ``hnsw.iterative_scan``
resumes exhausted searches from their discarded candidates with a
persistent visited set, on row gathers, as the reference does.

Vacuum is the reference's 4 passes (hnswvacuum.c:777-797): drop dead TIDs,
repair the lists that pointed at deleted elements by re-searching, check,
then free the slots.

With ``build_mesh`` (a ``parallel.Mesh`` of more than one device) a
build's wave searches, select rows and backlink chunks split over the
mesh's devices (``hnsw_kernels.wave_search_sharded`` and
``connect_level_sharded``), and the graph is the single-device build's
bit for bit.  The reference's knobs are read where it reads them:
``PGVECTOR_TPU_VISITED`` (the visited set of scans and builds),
``PGVECTOR_TPU_L_UNROLL`` (the upper-level depth, clamped to ``L_MAX``),
``PGVECTOR_TPU_QUERY_MAX_STEPS`` (a layer-0 hop cap on plain scans),
``PGVECTOR_TPU_WAVE_SYNC_EVERY`` (a device sync and a progress line on
stderr every N build waves) and ``PGVECTOR_TPU_PHASE_SYNC`` (with timers
on, a device sync at each wave's search / connect boundary).

Left out of the port: the ``sketch`` packed tier (a JL projection the
reference offers only on request).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..errors import (DataException, FeatureNotSupported, InternalError,
                      InvalidParameterValue)
from ..ops.distance import SPARSE_PAD
from ..ops.metric import Metric, stored_to_user
from ..store.table import BitTable, DenseTable, SparseTable
from ..utils.stats import ScanStats
from ..utils.telemetry import Progress, host_read, timers
from . import hnsw_kernels as K

# reloption bounds — src/hnsw.h:53-62
DEFAULT_M = 16
MIN_M, MAX_M = 2, 100
DEFAULT_EF_CONSTRUCTION = 64
MIN_EF_CONSTRUCTION, MAX_EF_CONSTRUCTION = 4, 1000

#: per-type dimension caps (hnswutils.c:1375-1431, hnsw.h:33-34)
MAX_DIM_F32 = 2000
MAX_DIM_F16 = 4000
MAX_DIM_BIT = 64000
MAX_NNZ_SPARSE = 1000

#: heap TIDs per element (hnsw.h:69)
HEAPTIDS = 10

#: static upper-level array depth; P(level ≥ 12) = m^-12 — unreachable
L_MAX = 12

DENSE_OPCLASSES = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)
BIT_OPCLASSES = (Metric.HAMMING, Metric.JACCARD)
SPARSE_OPCLASSES = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)

#: PGVECTOR_TPU_PACKED_SCAN modes of the reference that the port takes
PACKED_MODES = ("auto", "off", "f32", "bf16", "int8")


def auto_packed_dtype(cap_e: int, m: int, dim: int, metric: Metric,
                      total_bytes: int) -> Optional[torch.dtype]:
    """The ``auto`` packed tier for a (cap_e, 2m, dim) slab on a card of
    ``total_bytes``: f32 while the f32 slab is at most 1/8 of the memory,
    bf16 while its bf16 half is at most 9/16, int8 while its quarter is
    at most 9/16 and the metric has the dot form (L2, inner product,
    cosine; L1 would dequantize the slab in f32, the bytes the tier saves),
    else None (row gathers).  The reference's 2 GB / 9 GB / 9 GB
    thresholds on a 16 GB chip (hnsw.py:1238-1246), in the same ratios."""
    f32_bytes = cap_e * 2 * m * dim * 4
    if f32_bytes <= total_bytes // 8:
        return torch.float32
    if f32_bytes // 2 <= total_bytes * 9 // 16:
        return torch.bfloat16
    if (f32_bytes // 4 <= total_bytes * 9 // 16
            and metric in (Metric.L2, Metric.IP, Metric.COSINE)):
        return torch.int8
    return None


class HNSWIndex:
    """An HNSW access method over a DenseTable, BitTable or SparseTable,
    on the table's device."""

    def __init__(
        self,
        table: DenseTable,
        metric: Metric,
        m: int = DEFAULT_M,
        ef_construction: int = DEFAULT_EF_CONSTRUCTION,
        seed: int = 0,
        build: bool = True,
        wave_size: int = 1024,
        beam_expand: int = 1,
        backlink_mode: str = "wholesale",
        dedup: bool = True,
        notice_hook=None,
        progress=None,
        capacity: Optional[int] = None,
        build_mesh=None,
    ):
        if not MIN_M <= m <= MAX_M:
            raise DataException(f'value {m} out of bounds for option "m"')
        if not MIN_EF_CONSTRUCTION <= ef_construction <= MAX_EF_CONSTRUCTION:
            raise DataException(
                f'value {ef_construction} out of bounds for option "ef_construction"'
            )
        if ef_construction < 2 * m:
            # hnswbuild.c:713-716
            raise DataException("ef_construction must be greater than or equal to 2 * m")
        if isinstance(table, DenseTable):
            self.kind = "dense"
            if metric not in DENSE_OPCLASSES:
                raise FeatureNotSupported(
                    f"operator {metric.op} is not supported by hnsw for vectors")
            cap = MAX_DIM_F16 if table.dtype != torch.float32 else MAX_DIM_F32
            if table.dim > cap:
                raise DataException(
                    f"column cannot have more than {cap} dimensions for hnsw index")
        elif isinstance(table, BitTable):
            self.kind = "bit"
            if metric not in BIT_OPCLASSES:
                raise FeatureNotSupported(
                    f"operator {metric.op} is not supported by hnsw for bit vectors")
            if table.dim > MAX_DIM_BIT:
                raise DataException(
                    f"column cannot have more than {MAX_DIM_BIT} dimensions for hnsw index")
        elif isinstance(table, SparseTable):
            self.kind = "sparse"
            if metric not in SPARSE_OPCLASSES:
                raise FeatureNotSupported(
                    f"operator {metric.op} is not supported by hnsw for sparse vectors")
            if table.nnz_cap > MAX_NNZ_SPARSE:
                raise DataException(
                    f"sparsevec cannot have more than {MAX_NNZ_SPARSE} non-zero elements for hnsw index")
        else:
            raise FeatureNotSupported(
                f"hnsw does not support {type(table).__name__}")
        self.table = table
        self.device = table.device
        self.metric = metric
        self.m = m
        self.ef_construction = ef_construction
        self.seed = seed
        self.wave_size = wave_size
        #: candidates expanded per beam hop (1 = exact Algorithm 2 order)
        self.beam_expand = beam_expand
        #: "wholesale" = one SelectNeighbors over old ∪ new per target per
        #: wave; "incremental" = the reference's per-source one-eviction
        #: fold (hnswutils.c:1181-1229)
        self.backlink_mode = backlink_mode
        #: optional ``parallel.Mesh``: a build's wave searches and connects
        #: split over its devices, giving the single-device graph
        self.build_mesh = build_mesh
        self.dedup = dedup
        self.notice_hook = notice_hook or (lambda msg: None)
        self.progress = progress or Progress()
        #: pg_stat_user_indexes / nsearches analogue (utils/stats.py)
        self.stats = ScanStats()
        self.ml = 1.0 / math.log(m)  # hnsw.h:130
        self._mem_notice_fired = False
        self._wave_eff = wave_size  # wave size after the memory budget
        self._rng = np.random.default_rng(seed)
        if capacity:
            self._init_graph(capacity=max(-(-capacity // 256) * 256, 1024))
        else:
            self._init_graph(capacity=max(self._table_rows(), 1024))
        if build:
            self.build()

    # ------------------------------------------------------------- graph state
    def _derive_l_unroll(self, capacity: int) -> int:
        """Upper-level depth: the highest level with ≥2 expected elements
        (E[count at L] = n·m^-L), as the reference derives it, or
        ``PGVECTOR_TPU_L_UNROLL`` clamped to [1, L_MAX] (the upper-level
        arrays are L_MAX deep at most)."""
        env = os.environ.get("PGVECTOR_TPU_L_UNROLL")
        if env is not None:
            return min(L_MAX, max(1, int(env)))
        need = math.floor(math.log(max(capacity // 2, 2)) / math.log(self.m))
        return min(L_MAX, max(2, need))

    def _init_graph(self, capacity: int) -> None:
        if capacity > 2**30:
            # pool entries pack (id·2 | flag) into int32
            raise DataException("hnsw index cannot hold more than 2^30 elements")
        self._l_unroll = self._derive_l_unroll(capacity)
        t = self.table
        dev = self.device
        self.cap_e = capacity
        self.cap_u = max(capacity // max(self.m // 2, 1), 64)
        # a 16-bit table's index stores 16-bit values; scoring is f32
        dense = self.kind == "dense"
        self._val_dtype = (t.dtype if dense and t.dtype in (torch.bfloat16,
                                                            torch.float16)
                           else torch.float32)
        # the index's value copy aliases the table's tensors while rows map
        # 1:1 to elements and values are stored unmodified (not cosine)
        self._alias_values = (
            not (dense and self.metric is Metric.COSINE)
            and (not dense or self._val_dtype == t.dtype)
            and self._table_rows() >= capacity)
        if self._alias_values:
            self._refresh_alias()
        elif dense:
            self.values = torch.zeros((capacity, t.dim), dtype=self._val_dtype,
                                      device=dev)
        elif self.kind == "bit":
            self.values = torch.zeros((capacity, t.words), dtype=torch.int32,
                                      device=dev)
        else:
            self.values = (
                torch.full((capacity, t.nnz_cap), SPARSE_PAD,
                           dtype=torch.int32, device=dev),
                torch.zeros((capacity, t.nnz_cap), dtype=torch.float32,
                            device=dev))
        self.nbr0 = torch.full((capacity, 2 * self.m), -1, dtype=torch.int32,
                               device=dev)
        self.nbr_up = torch.full((self.cap_u, self._l_unroll, self.m), -1,
                                 dtype=torch.int32, device=dev)
        self.kept0 = torch.zeros((capacity, 2 * self.m), dtype=torch.bool,
                                 device=dev)
        self.kept_up = torch.zeros((self.cap_u, self._l_unroll, self.m),
                                   dtype=torch.bool, device=dev)
        self.up_slot = np.full(capacity, -1, np.int32)
        self.levels = np.full(capacity, -1, np.int32)
        self.elem_rows = np.full((capacity, HEAPTIDS), -1, np.int32)
        self.n_elems = 0
        self.n_upper = 0
        self.entry: int = -1
        self.entry_level: int = -1
        self.free_slots: List[int] = []
        self.row_to_elem: Dict[int, int] = {}
        self._dup_index: Dict[bytes, int] = {}
        self._up_slot_dev: Optional[torch.Tensor] = None
        self._elem_rows_dev: Optional[torch.Tensor] = None
        self._dirty = True
        #: adjacency-packed neighbor values for the scan (built lazily,
        #: dropped by any graph change); an int8 slab keeps its per-dim
        #: scale (D,) and each element's dequantized squared norm beside it
        self._nbr_vals: Optional[torch.Tensor] = None
        self._nbr_scale: Optional[torch.Tensor] = None
        self._nbr_norm2: Optional[torch.Tensor] = None
        self._last_scan_steps = 0
        self._last_scan_launches = 0
        self._last_scan_rounds = 1
        #: elements the last vacuum freed and re-linked
        self.last_vacuum = {"deleted": 0, "repaired": 0}

    def _table_rows(self) -> int:
        t = self.table
        return int((t.idx if self.kind == "sparse" else t.data).shape[0])

    def _refresh_alias(self) -> None:
        """Re-point aliased values at the table's current tensors (growth
        replaces them)."""
        if self._alias_values:
            t = self.table
            self.values = (t.idx, t.val) if self.kind == "sparse" else t.data

    def _value_arrays(self) -> tuple:
        """The value arrays as a tuple, whatever the kind (sparse: idx,
        val)."""
        return self.values if self.kind == "sparse" else (self.values,)

    def _set_value_arrays(self, arrays) -> None:
        self.values = tuple(arrays) if self.kind == "sparse" else arrays[0]

    def _value_fills(self) -> tuple:
        """What a free slot holds: SPARSE_PAD and 0 for sparse, 0 else."""
        return (SPARSE_PAD, 0.0) if self.kind == "sparse" else (0,)

    def _materialize_values(self) -> None:
        """Break the table alias: gather every element its own value copy
        by primary TID, so index-private rewrites (vacuum zeroing, slot
        reuse) never reach the heap."""
        if not self._alias_values:
            return
        self._refresh_alias()
        rows = torch.as_tensor(np.maximum(self.elem_rows[:, 0], 0)
                               .astype(np.int64), device=self.device)
        live = torch.as_tensor(self.elem_rows[:, 0] >= 0, device=self.device)
        self._set_value_arrays([
            torch.where(live[:, None], a[rows],
                        torch.full((), f, dtype=a.dtype, device=self.device))
            for a, f in zip(self._value_arrays(), self._value_fills())])
        self._alias_values = False

    def _ensure_unroll_depth(self, depth: int) -> None:
        """Widen the upper-level arrays to ``depth`` levels."""
        depth = min(max(depth, self._l_unroll), L_MAX)
        self._l_unroll = depth
        width = self.nbr_up.shape[1]
        if width >= depth:
            return
        pad = depth - width
        self.nbr_up = torch.cat([self.nbr_up, self.nbr_up.new_full(
            (self.cap_u, pad, self.m), -1)], dim=1)
        self.kept_up = torch.cat([self.kept_up, self.kept_up.new_zeros(
            (self.cap_u, pad, self.m))], dim=1)

    def _sync_device_meta(self) -> None:
        self._refresh_alias()
        if self._dirty:
            self._up_slot_dev = torch.as_tensor(self.up_slot, device=self.device)
            self._elem_rows_dev = torch.as_tensor(self.elem_rows,
                                                  device=self.device)
            self._dirty = False

    def _sync(self) -> None:
        """End a timed phase on the device's clock: phase timers read the
        host clock, and CUDA work is asynchronous."""
        if timers.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- index values
    def _form_values(self, rows: np.ndarray):
        """HnswFormIndexValue (hnswutils.c:406-428): fetch and normalize
        (cosine) the rows' values.  Returns (values, keep mask) — zero-norm
        rows are not indexed for cosine (hnswutils.c:417-423)."""
        r = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        keep_all = np.ones(len(rows), bool)
        if self.kind == "bit":
            return self.table.data[r], keep_all
        if self.kind == "sparse":
            return (self.table.idx[r], self.table.val[r]), keep_all
        vals = self.table.data[r]
        if self.metric is Metric.COSINE:
            vals = vals.float()
            norms = torch.sqrt(torch.sum(vals * vals, dim=1, keepdim=True))
            host_read("insert.nonzero")
            keep = (norms[:, 0] > 0).cpu().numpy()
            vals = vals / torch.clamp(norms, min=1e-30)
            return vals.to(self._val_dtype), keep
        return vals.to(self._val_dtype), keep_all

    def _query_rep(self, q):
        """GetScanValue (hnswscan.c:92-114): coerce + normalize queries —
        (Q, D) values, (Q, W) packed words, or sparse (q_idx, q_val)
        padded to the table's nnz_cap."""
        from .flat import (_coerce_bit_queries, _coerce_dense_queries,
                           _sparse_list, sparse_query_arrays)

        t = self.table
        if self.kind == "bit":
            return _coerce_bit_queries(q, t)
        if self.kind == "sparse":
            q = _sparse_list(q, t.dim)
            if any(sv.nnz > t.nnz_cap for sv in q):
                raise DataException(
                    f"sparsevec cannot have more than {t.nnz_cap} non-zero "
                    "elements for this table")
            return sparse_query_arrays(q, t.nnz_cap, self.device)
        qs = _coerce_dense_queries(q, t.dim, self.device)
        if self.metric is Metric.COSINE:
            norms = torch.sqrt(torch.sum(qs * qs, dim=1, keepdim=True))
            qs = qs / torch.clamp(norms, min=1e-30)
        return qs

    # ------------------------------------------------------- neighbor closures
    def _neighbors_of_level(self, elems: torch.Tensor, level: int) -> torch.Tensor:
        """A batch of elements' neighbor lists at ``level`` (2m wide at
        level 0, m above)."""
        safe = K._long(elems)
        if level == 0:
            out = self.nbr0[safe]
        else:
            self._sync_device_meta()
            slot = self._up_slot_dev[safe]
            out = self.nbr_up[K._long(slot), level - 1]
            out = torch.where(slot[:, None] >= 0, out, -1)
        return torch.where(elems[:, None] >= 0, out, -1)

    def _kept_of_level(self, elems: torch.Tensor, level: int) -> torch.Tensor:
        """The sticky kept flags matching _neighbors_of_level."""
        safe = K._long(elems)
        if level == 0:
            out = self.kept0[safe]
        else:
            self._sync_device_meta()
            slot = self._up_slot_dev[safe]
            out = self.kept_up[K._long(slot), level - 1]
            out = out & (slot[:, None] >= 0)
        return out & (elems[:, None] >= 0)

    # ------------------------------------------------------------------ build
    def build(self) -> None:
        t = self.table
        self.progress.set_phase("initializing")
        with self._reads_counted():
            host_read("build.live")
            live = np.flatnonzero(t.valid[: t.count].cpu().numpy())
            if len(live) == 0:
                return
            self.progress.set_phase("loading tuples", len(live))
            with timers.phase("hnsw.build"):
                self._insert_rows(live)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)

    def insert(self, rows) -> None:
        """aminsert analogue (hnswinsert.c:695-743) for a batch of new rows."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        with self._reads_counted():
            self._insert_rows(rows)

    @contextlib.contextmanager
    def _reads_counted(self):
        """Add the host reads made inside to ``stats.host_reads``."""
        r0 = timers.host_reads
        try:
            yield
        finally:
            self.stats.host_reads += timers.host_reads - r0

    # ------------------------------------------------------- core insert path
    def _insert_rows(self, rows: np.ndarray) -> None:
        """Insert table rows: duplicates attach heap TIDs, the rest become
        new elements (in freed slots first), then the wave schedule."""
        self._refresh_alias()
        # without dedup and with values aliasing the heap, forming values
        # would copy rows only for _write_values to discard them
        lazy = self._alias_values and not self.dedup
        if lazy:
            values, keep = None, np.ones(len(rows), bool)
        else:
            values, keep = self._form_values(rows)
            rows = rows[keep]
            if not keep.all():
                values = _take(values, torch.as_tensor(np.flatnonzero(keep),
                                                       device=self.device))
        if len(rows) == 0:
            return

        # duplicate merge (InsertTupleInMemory's duplicate path,
        # hnswbuild.c:342-364; FindDuplicateOnDisk, hnswinsert.c:641-663):
        # duplicates of existing elements attach a heap TID; duplicates
        # within the batch group into one new element (10 TIDs at most)
        new_rows: List[List[int]] = []  # rows per new element
        new_val_pos: List[int] = []
        new_keys: List[Optional[bytes]] = []
        if self.dedup:
            with timers.phase("hnsw.dedup_keys"):
                host_read("dedup.keys")
                keys = _dup_keys(_host_rows(values))
                batch_map: Dict[bytes, int] = {}
                for i, row in enumerate(rows.tolist()):
                    key = keys[i]
                    e = self._dup_index.get(key)
                    if e is not None and self._attach_tid(e, row):
                        continue
                    j = batch_map.get(key)
                    if j is not None and len(new_rows[j]) < HEAPTIDS:
                        new_rows[j].append(row)
                        continue
                    batch_map[key] = len(new_rows)
                    new_rows.append([row])
                    new_val_pos.append(i)
                    new_keys.append(key)
        else:
            new_rows = [[int(r)] for r in rows]
            new_val_pos = list(range(len(rows)))
            new_keys = [None] * len(rows)
        if not new_rows:
            return
        if new_val_pos != list(range(len(rows))):
            # only when dedup dropped or merged rows: the identity gather
            # would copy the whole value block for nothing
            values = _take(values, torch.as_tensor(
                np.asarray(new_val_pos, np.int64), device=self.device))

        elems = np.asarray(self._alloc_slots(len(new_rows)), np.int64)
        # levels = floor(-ln(U)·ml), drawn exactly as the reference draws
        # them (hnsw.py:540-543)
        lv = np.minimum(
            np.floor(-np.log(self._rng.random(len(new_rows))) * self.ml).astype(np.int32),
            self._l_unroll,
        )
        self.levels[elems] = lv
        self.elem_rows[elems, :] = -1
        lens = np.fromiter((len(g) for g in new_rows), np.int64, len(new_rows))
        if int(lens.max()) == 1:
            rows_flat = np.fromiter((g[0] for g in new_rows), np.int64,
                                    len(new_rows))
            self.elem_rows[elems, 0] = rows_flat
            self.row_to_elem.update(zip(rows_flat.tolist(), elems.tolist()))
        else:
            for j, e in enumerate(elems.tolist()):
                for t, row in enumerate(new_rows[j]):
                    self.elem_rows[e, t] = row
                    self.row_to_elem[row] = e
        if self.dedup:
            self._dup_index.update(zip(new_keys, elems.tolist()))
        need_up = (lv >= 1) & (self.up_slot[elems] < 0)
        if need_up.any():
            self.up_slot[elems[need_up]] = self._alloc_upper_bulk(int(need_up.sum()))
        self._dirty = True
        self._drop_packed()  # the graph is about to change
        if values is None:
            if np.array_equal(self.elem_rows[elems, 0], elems):
                self._refresh_alias()  # the heap rows are these values
            elif self._alias_values:
                # a non-identity mapping (freed slots reused): one private
                # gather by TID covers every element, this batch included
                self._materialize_values()
            else:
                # _grow() during _alloc_slots broke the alias: the padded
                # copy holds row e at slot e, so write this batch's values
                vals, _ = self._form_values(self.elem_rows[elems, 0]
                                            .astype(np.int64))
                self._write_values(elems, vals)
        else:
            self._write_values(elems, values)
            del values

        wave_size = self._effective_wave_size()
        # PGVECTOR_TPU_WAVE_SYNC_EVERY=N: wait for the graph every N waves
        # and write the build's progress to stderr (hnsw.py:596-618)
        sync_every = int(os.environ.get("PGVECTOR_TPU_WAVE_SYNC_EVERY", "0")
                         or 0)
        n_waves = -(-len(elems) // wave_size)
        t_wave0 = time.time()
        for wi, p in enumerate(range(0, len(elems), wave_size)):
            with timers.phase("hnsw.wave"):
                self._insert_wave(elems[p: p + wave_size], lv[p: p + wave_size])
            self.progress.advance(min(wave_size, len(elems) - p))
            if sync_every and (wi + 1) % sync_every == 0:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                rate = (wi + 1) / max(time.time() - t_wave0, 1e-9)
                print(f"hnsw build: wave {wi + 1}/{n_waves} "
                      f"({rate:.2f} waves/s, "
                      f"eta {(n_waves - wi - 1) / max(rate, 1e-9):.0f}s)",
                      file=sys.stderr, flush=True)

    def _wave_bytes(self, b: int) -> int:
        """Transient device bytes of one insert wave of ``b`` elements: the
        beam pools, the pairwise select block and the per-level output
        pools (builds run the visited set off, so no table), by kind
        (hnsw.py:624-660)."""
        ef = self.ef_construction
        c = ef + min(self.m, b)  # beam pool + intra-wave candidates
        pair = 4 * c * c  # pairwise select block
        if self.kind == "dense":
            rep = 4 * self.table.dim
        elif self.kind == "bit":
            rep = 4 * self.table.words
        else:
            rep = 8 * self.table.nnz_cap
            if self._pair_sdim():
                # the (c, sdim) f32 scatter block (×2 for its temps)
                pair += c * self.table.dim * 4 * 2
            else:  # merge-join (c, c, nnz lanes) idx + val gathers
                pair = c * c * self._nnz_lanes() * 8
        per_q = (pair
                 + (ef + c) * (rep + 9)        # pool values + dists + ids
                 + (self._l_unroll + 1) * ef * 8)  # stacked per-level pools
        return b * per_q

    def _nnz_lanes(self) -> int:
        return ((self.table.nnz_cap + 127) // 128) * 128

    def _pair_c(self) -> int:
        """The reference's lane-padded candidate count of a select row."""
        return ((self.ef_construction + min(self.m, self.wave_size) + 127)
                // 128) * 128

    def _pair_sdim(self) -> int:
        """Logical dim at which sparse pairwise-select blocks are
        densified, or 0 for the merge join: densify when the dense row is
        smaller than the merge join's per-candidate gathers, dim·4 <
        C·nnz_lanes·8 (hnsw.py:664-678).  L1 always merge-joins."""
        if self.kind != "sparse" or self.metric is Metric.L1:
            return 0
        dim = int(self.table.dim)
        return dim if dim * 4 < self._pair_c() * self._nnz_lanes() * 8 else 0

    def _scorer_sdim(self) -> int:
        """Logical dim of the densified-query scorer, or 0 for the merge
        join: any dim up to 32,768 (its dense block is (Q, dim + 1));
        L1 keeps the merge join (hnsw.py:680-694)."""
        if self.kind != "sparse" or self.metric is Metric.L1:
            return 0
        dim = int(self.table.dim)
        return dim if dim <= 32768 else 0

    def _sparse_pair_rows_cap(self) -> int:
        """The most rows of one sparse select or merge call: their
        densified blocks or merge-join gathers stay under
        ``hnsw.sparse_pair_bytes`` (hnsw.py:696-717); a power of two."""
        c = self._pair_c()
        if self._pair_sdim():
            per_row = c * self.table.dim * 4 * 2 + 4 * c * c
        else:
            per_row = c * c * self._nnz_lanes() * 8
        cap = max(1, int(config.get("hnsw.sparse_pair_bytes")) // per_row)
        p = 1
        while p * 2 <= cap:
            p *= 2
        return p

    def _effective_wave_size(self) -> int:
        """Shrink the wave until its working set fits maintenance_work_mem;
        NOTICE once per index when degraded (hnswbuild.c:530-549).  A
        sparse wave is first capped by _sparse_pair_rows_cap, a structural
        bound without a NOTICE (hnsw.py:720-740)."""
        budget = int(config.get("maintenance_work_mem"))
        wave = self.wave_size
        if self.kind == "sparse":
            wave = min(wave, self._sparse_pair_rows_cap())
        start = wave
        while wave > 8 and self._wave_bytes(wave) > budget:
            wave //= 2
        self._wave_eff = wave
        if wave < start and not self._mem_notice_fired:
            self._mem_notice_fired = True
            self.notice_hook(
                "hnsw build wave no longer fits into maintenance_work_mem\n"
                f"DETAIL:  Reduced insert wave size from {start} to "
                f"{wave}. Building will take significantly more time.\n"
                "HINT:  Increase maintenance_work_mem to speed up builds."
            )
        return wave

    def _attach_tid(self, elem: int, row: int) -> bool:
        """AddDuplicateOnDisk (hnswinsert.c:585-636): append a heap TID to
        an existing element, 10 at most."""
        if self.levels[elem] < 0:
            return False
        slots = self.elem_rows[elem]
        free = np.flatnonzero(slots < 0)
        if not len(free):
            return False
        slots[free[0]] = row
        self.row_to_elem[row] = elem
        self._dirty = True
        return True

    def _alloc_slots(self, n: int) -> List[int]:
        """Freed slots first, last freed first (the reference's order, so
        both packages put the same element in the same slot), then new
        slots past n_elems."""
        out = [self.free_slots.pop() for _ in range(min(len(self.free_slots), n))]
        rem = n - len(out)
        if rem:
            while self.n_elems + rem > self.cap_e:
                self._grow()
            out.extend(range(self.n_elems, self.n_elems + rem))
            self.n_elems += rem
        return out

    def _alloc_upper_bulk(self, n: int) -> np.ndarray:
        while self.n_upper + n > self.cap_u:
            self.nbr_up = torch.cat([self.nbr_up, torch.full_like(self.nbr_up, -1)])
            self.kept_up = torch.cat([self.kept_up, torch.zeros_like(self.kept_up)])
            self.cap_u *= 2
        out = np.arange(self.n_upper, self.n_upper + n, dtype=np.int32)
        self.n_upper += n
        return out

    def _grow(self) -> None:
        new_cap = self.cap_e * 2
        if new_cap > 2**30:
            raise DataException("hnsw index cannot hold more than 2^30 elements")
        self._ensure_unroll_depth(self._derive_l_unroll(new_cap))
        self._drop_packed()
        pad = new_cap - self.cap_e
        # growth pads the values past the table: the copy is private now
        self._refresh_alias()
        self._alias_values = False
        self._set_value_arrays([
            torch.cat([a, a.new_full((pad, a.shape[1]), f)])
            for a, f in zip(self._value_arrays(), self._value_fills())])
        self.nbr0 = torch.cat([self.nbr0, self.nbr0.new_full((pad, 2 * self.m), -1)])
        self.kept0 = torch.cat([self.kept0, self.kept0.new_zeros((pad, 2 * self.m))])
        self.up_slot = np.concatenate([self.up_slot, np.full(pad, -1, np.int32)])
        self.levels = np.concatenate([self.levels, np.full(pad, -1, np.int32)])
        self.elem_rows = np.concatenate(
            [self.elem_rows, np.full((pad, HEAPTIDS), -1, np.int32)])
        self.cap_e = new_cap
        self._dirty = True

    def _write_values(self, elems, values) -> None:
        e_np = np.asarray(elems, np.int64)
        if self._alias_values:
            if np.array_equal(self.elem_rows[e_np, 0], e_np):
                # identity alias: the heap rows are these elements' values
                self._refresh_alias()
                return
            self._materialize_values()
        e = torch.as_tensor(e_np, device=self.device)
        blocks = values if self.kind == "sparse" else (values,)
        for a, b in zip(self._value_arrays(), blocks):
            a[e] = b

    # ------------------------------------------------------------ wave insert
    def _search_wave_raw(self, elems: np.ndarray, lv: np.ndarray,
                         exclude_self: bool = False):
        """Batched Algorithm 1 search for a wave, padded to a power of two
        (at most the wave size) as in the reference.  Returns the stacked
        per-level pools (L+1, nq_pad, ef), nq and nq_pad."""
        self._sync_device_meta()
        nq = len(elems)
        nq_pad = min(_round_pow2(max(nq, 8)), _round_pow2(self.wave_size))
        if nq_pad < nq:
            nq_pad = _round_pow2(nq)
        e_pad = np.concatenate([elems, np.full(nq_pad - nq, elems[0], elems.dtype)])
        lv_pad = np.concatenate([lv, np.zeros(nq_pad - nq, lv.dtype)])
        e_dev = torch.as_tensor(e_pad.astype(np.int32), device=self.device)
        qs = K.elems_as_queries(self.kind, self.values, e_dev)
        mesh = self.build_mesh
        ndev = mesh.size if mesh is not None else 1
        # the mesh wave search (hnsw.py:857-873), at K.SHARD_MIN_QUERIES
        # queries a device or more
        wave_fn = (functools.partial(K.wave_search_sharded, mesh)
                   if ndev > 1 and nq_pad % ndev == 0
                   and nq_pad // ndev >= K.SHARD_MIN_QUERIES
                   else K.wave_search)
        out_d, out_i = wave_fn(
            self.kind, self.metric, self.values, self.nbr0, self.nbr_up,
            self._up_slot_dev, qs, lv_pad.astype(np.int32), self.entry,
            self.entry_level, ef=self.ef_construction,
            l_unroll=self._l_unroll, expand=self.beam_expand,
            self_ids=e_dev if exclude_self else None,
            sdim=self._scorer_sdim(), vmode=K.visited_mode())
        return out_d, out_i, nq, nq_pad

    def _search_wave(self, elems: np.ndarray, lv: np.ndarray,
                     exclude_self: bool):
        """The wave's pools by level, from the top level it reaches down."""
        out_d, out_i, nq, _ = self._search_wave_raw(elems, lv, exclude_self)
        return {lc: (out_d[lc, :nq], out_i[lc, :nq])
                for lc in range(min(self.entry_level, int(lv.max())), -1, -1)}

    def _insert_wave_fused(self, elems: np.ndarray, lv: np.ndarray,
                           exclude_self: bool = False) -> None:
        """Search + connect: one wave search, then one connect pass per
        level from the top eligible level down.  Phase timers read the host
        clock; ``PGVECTOR_TPU_PHASE_SYNC=1`` (with timers on) ends each
        phase with a device sync, so the search / connect split is the
        device's (hnsw.py:898-912)."""
        sync = os.environ.get("PGVECTOR_TPU_PHASE_SYNC", "0") == "1"
        with timers.phase("hnsw.wave.search"):
            out_d, out_i, nq, nq_pad = self._search_wave_raw(elems, lv,
                                                             exclude_self)
            if sync:
                self._sync()
        with timers.phase("hnsw.wave.connect"):
            dev = self.device
            e_conn = np.concatenate(
                [elems, np.full(nq_pad - nq, -1, elems.dtype)]).astype(np.int32)
            lv_conn = np.concatenate([lv, np.full(nq_pad - nq, -1, lv.dtype)])
            top = min(self.entry_level, int(lv.max()))
            for lc in range(top, -1, -1):
                elig = lv >= lc
                if not elig.any():
                    continue
                lm = 2 * self.m if lc == 0 else self.m
                if lc == 0:
                    e_lvl = torch.as_tensor(e_conn, device=dev)
                    elig_dev = torch.as_tensor(lv_conn >= 0, device=dev)
                    pd, pi = out_d[0], out_i[0]
                    b_lvl = nq_pad
                else:
                    # upper levels hold ~1/m of the wave — compact to a small
                    # block instead of a full-wave connect (the floor stays
                    # within the sparse pairwise cap)
                    floor = 64
                    if self.kind == "sparse":
                        floor = min(floor, self._sparse_pair_rows_cap())
                    idx_e = np.flatnonzero(elig)
                    b_lvl = _round_pow2(max(len(idx_e), floor))
                    pad_e = b_lvl - len(idx_e)
                    sel_idx = torch.as_tensor(np.concatenate(
                        [idx_e, np.zeros(pad_e, idx_e.dtype)]), device=dev)
                    e_lvl = torch.as_tensor(np.concatenate(
                        [elems[idx_e], np.full(pad_e, -1, elems.dtype)]
                    ).astype(np.int32), device=dev)
                    elig_dev = torch.as_tensor(np.arange(b_lvl) < len(idx_e),
                                               device=dev)
                    pd = out_d[lc][sel_idx]
                    pi = out_i[lc][sel_idx]
                # chunking only bounds the merge's (chunk, C, C) pairwise
                # block — targets are unique, so the graph does not depend
                # on it.  Larger than the reference's 2048: each chunk costs
                # a fixed run of small launches in eager PyTorch.
                chunk = min(16384, _round_pow2(b_lvl * lm))
                if self.kind == "sparse":
                    chunk = min(chunk, self._sparse_pair_rows_cap())
                mesh = self.build_mesh
                ndev = mesh.size if mesh is not None else 1
                # the mesh connect: select rows and backlink chunks split
                # over the devices (hnsw.py:959-981)
                connect = (functools.partial(K.connect_level_sharded, mesh)
                           if ndev > 1 and b_lvl % ndev == 0
                           and b_lvl >= ndev else K.connect_level)
                connect(
                    self.kind, self.metric, self.values, self.nbr0,
                    self.nbr_up, self.kept0, self.kept_up, self._up_slot_dev,
                    e_lvl, elig_dev, lc, pd, pi, m=self.m,
                    mi=min(self.m, b_lvl), smax=lm, chunk=chunk,
                    sdim=self._pair_sdim())
            if sync:
                self._sync()

    def _insert_wave(self, elems: np.ndarray, lv: np.ndarray) -> None:
        """One wave: batched search + neighbor selection + connection
        writes (InsertTupleInMemory/UpdateGraphInMemory, hnswbuild.c:437-480)."""
        if self.entry < 0:
            # the first element becomes the entry point with no neighbors
            self.entry = int(elems[0])
            self.entry_level = int(lv[0])
            elems, lv = elems[1:], lv[1:]
            if len(elems) == 0:
                return
        if self.backlink_mode == "incremental":
            with timers.phase("hnsw.wave.search"):
                pools = self._search_wave(elems, lv, exclude_self=False)
            with timers.phase("hnsw.wave.connect"):
                self._connect_from_pools(elems, lv, pools)
        else:
            self._insert_wave_fused(elems, lv)
        wave_max = int(lv.max()) if len(lv) else -1
        if wave_max > self.entry_level:
            j = int(np.argmax(lv))
            self.entry = int(elems[j])
            self.entry_level = wave_max

    def _connect_from_pools(self, elems: np.ndarray, lv: np.ndarray, pools) -> None:
        """Connect a searched wave level by level: intra-wave candidates,
        SelectNeighbors in fixed blocks, own-list writes, then backlinks
        folded into each target (incremental mode)."""
        dev = self.device
        e_dev = torch.as_tensor(elems.astype(np.int32), device=dev)
        for lc in sorted(pools.keys(), reverse=True):
            lm = 2 * self.m if lc == 0 else self.m
            mask_q = lv >= lc
            if not mask_q.any():
                continue
            q_sel = np.flatnonzero(mask_q)
            pd, pi = pools[lc]
            # intra-wave candidates: wave members never see each other in
            # their frozen-graph searches; fold the nearest wave-mates at
            # this level into the pools
            if len(elems) > 1:
                with timers.phase("hnsw.connect.select"):
                    intra_d, intra_i = K.intra_wave_candidates(
                        self.kind, self.metric, self.values, e_dev,
                        torch.as_tensor(lv >= lc, device=dev),
                        min(self.m, len(elems)), sdim=self._pair_sdim())
                    pd = torch.cat([pd, intra_d], dim=1)
                    pi = torch.cat([pi, intra_i], dim=1)
            block = _round_pow2(self._wave_eff)
            for start in range(0, len(q_sel), block):
                chunk = q_sel[start: start + block]
                pad = block - len(chunk)
                idx_dev = torch.as_tensor(np.concatenate(
                    [chunk, np.zeros(pad, chunk.dtype)]).astype(np.int64),
                    device=dev)
                pd_c, pi_c = pd[idx_dev], pi[idx_dev]
                if pad:
                    mask = (torch.arange(block, device=dev) < len(chunk))[:, None]
                    pi_c = torch.where(mask, pi_c, -1)
                    pd_c = torch.where(mask, pd_c, torch.inf)
                with timers.phase("hnsw.connect.select"):
                    sel_elems, sel_kept = self._select_for(pd_c, pi_c, lm)
                    sel_elems = sel_elems[: len(chunk)]
                    sel_kept = sel_kept[: len(chunk)]
                    self._write_own_lists(elems[chunk], lc, sel_elems, sel_kept)
                with timers.phase("hnsw.connect.backlinks"):
                    host_read("connect.selected")
                    sel_host = sel_elems.cpu().numpy()
                    self._apply_backlinks(elems[chunk], lc, sel_host, lm)

    def _select_for(self, pool_d, pool_i, lm: int):
        """SelectNeighbors over each base element's candidate pool."""
        return K.select_connections(self.kind, self.metric, self.values,
                                    pool_d, pool_i, lm,
                                    sdim=self._pair_sdim())

    def _write_own_lists(self, elems: np.ndarray, level: int,
                         sel: torch.Tensor, kept: torch.Tensor) -> None:
        e = torch.as_tensor(elems.astype(np.int64), device=self.device)
        if level == 0:
            self.nbr0[e] = sel
            self.kept0[e] = kept
        else:
            slots = torch.as_tensor(self.up_slot[elems].astype(np.int64),
                                    device=self.device)
            self.nbr_up[slots, level - 1] = sel
            self.kept_up[slots, level - 1] = kept

    def _apply_backlinks(self, src_elems: np.ndarray, level: int,
                         sel: np.ndarray, lm: int) -> None:
        """HnswUpdateConnection for every (new element → neighbor) edge:
        group by target with one stable argsort over the flattened edges,
        then fold up to 8 new sources a target per round
        (hnswutils.c:1181-1229)."""
        flat_t = np.asarray(sel).reshape(-1)
        flat_s = np.repeat(src_elems.astype(np.int32), sel.shape[1])
        mask = flat_t >= 0
        if not mask.any():
            return
        order = np.argsort(flat_t[mask], kind="stable")
        ts = flat_t[mask][order]
        ss = flat_s[mask][order]
        uniq, starts, counts = np.unique(ts, return_index=True, return_counts=True)
        SMAX = 8  # new sources folded per round; overflow runs extra rounds
        offs = np.arange(SMAX)
        rnd = 0
        while True:
            has = counts > rnd * SMAX
            if not has.any():
                break
            t_r = uniq[has].astype(np.int32)
            st = starts[has] + rnd * SMAX
            n_r = np.minimum(counts[has] - rnd * SMAX, SMAX)
            idx = st[:, None] + offs[None, :]
            ok = offs[None, :] < n_r[:, None]
            new_src = np.where(ok, ss[np.minimum(idx, len(ss) - 1)], -1).astype(np.int32)
            self._backlink_round(t_r, new_src, level, lm, SMAX)
            rnd += 1

    def _backlink_round(self, targets: np.ndarray, src_mat: np.ndarray,
                        level: int, lm: int, smax: int) -> None:
        """One round of backlink merges, in fixed blocks of targets."""
        dev = self.device
        block = _round_pow2(max(self._wave_eff, 1))
        merge = (K.merge_backlinks if self.backlink_mode == "incremental"
                 else K.merge_backlinks_wholesale)
        for start in range(0, len(targets), block):
            t_chunk = targets[start: start + block]
            pad = block - len(t_chunk)
            new_src = np.concatenate(
                [src_mat[start: start + block],
                 np.full((pad, smax), -1, np.int32)])
            t_dev = torch.as_tensor(
                np.concatenate([t_chunk, np.full(pad, -1, np.int32)]),
                device=dev)
            old = self._neighbors_of_level(t_dev, level)  # (T, lm)
            old_kept = self._kept_of_level(t_dev, level)
            new_lists, new_kept = merge(
                self.kind, self.metric, self.values, old, old_kept,
                torch.as_tensor(new_src, device=dev), t_dev, lm,
                sdim=self._pair_sdim())
            n = len(t_chunk)
            if level == 0:
                real = torch.as_tensor(t_chunk.astype(np.int64), device=dev)
                self.nbr0[real] = new_lists[:n]
                self.kept0[real] = new_kept[:n]
            else:
                slots = self.up_slot[t_chunk].astype(np.int64)
                ok = slots >= 0
                s_dev = torch.as_tensor(slots[ok], device=dev)
                ok_dev = torch.as_tensor(ok, device=dev)
                self.nbr_up[s_dev, level - 1] = new_lists[:n][ok_dev]
                self.kept_up[s_dev, level - 1] = new_kept[:n][ok_dev]

    # ------------------------------------------------------------------ search
    def search(self, q, k: int, ef_search: Optional[int] = None,
               filter_mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Algorithm 5 scan (hnswscan.c).  Returns (operator distances,
        row ids) as numpy arrays, -1/inf padded.  Without iterative scans
        the result count is capped at ef_search (README.md:933-935); with
        ``hnsw.iterative_scan`` on, exhausted searches resume from the best
        discarded candidates with a persistent visited set
        (ResumeScanItems, hnswscan.c:61-87) until k results pass the
        filter, ``hnsw.max_scan_tuples`` is reached, or the memory cap
        binds.

        The whole call is the span ``hnsw.search``; inside it,
        ``hnsw.search.query_in`` lasts until the queries are on the
        index's device (see ``utils.telemetry``)."""
        with timers.phase("hnsw.search"), self._reads_counted():
            with timers.phase("hnsw.search.query_in"):
                ef = int(config.validate("hnsw.ef_search", ef_search)
                         if ef_search is not None
                         else config.get("hnsw.ef_search"))
                mode = config.get("hnsw.iterative_scan")
                qs = self._query_rep(q)
            nq = K._nq(qs)
            if self.entry < 0:
                return (np.full((nq, k), np.inf, np.float32),
                        np.full((nq, k), -1, np.int64))
            fmask = (torch.as_tensor(np.asarray(filter_mask, dtype=bool),
                                     device=self.device)
                     if filter_mask is not None else None)
            if mode == "off":
                d, r = self._search_once(qs, k, ef, fmask)
                host_read("search.distances")
                d = d.cpu().numpy()
                host_read("search.rows")
                r = r.cpu().numpy()
                self.stats.count(nq, r)
                return d, r
            d, r = self._search_iterative(qs, k, ef, fmask, mode)
            self.stats.count(nq, r, rounds=self._last_scan_rounds)
            return d, r

    def _scan_bytes_per_query(self, ef: int) -> int:
        """Device bytes of one query's scan state at ``ef``: pool slots ×
        (value copy + distance + id + expanded flag) plus the visited
        table."""
        if self.kind == "sparse":
            vec_bytes = 4 * 2 * self.table.nnz_cap
        elif self.kind == "bit":
            vec_bytes = 4 * self.table.words
        else:
            vec_bytes = 4 * self.table.dim
        return ef * (vec_bytes + 9) + 4 * K.visited_capacity(ef)

    def _packed_plan(self):
        """Layer-0 value packing dtype (or None for row gathers), from
        PGVECTOR_TPU_PACKED_SCAN: ``auto``, ``off``, ``f32``, ``bf16``,
        ``int8``.  ``auto`` packs only on CUDA (as the reference packs
        only on a TPU), by :func:`auto_packed_dtype` over the card's
        memory."""
        mode = os.environ.get("PGVECTOR_TPU_PACKED_SCAN", "auto")
        if mode == "sketch":
            raise InvalidParameterValue(
                'PGVECTOR_TPU_PACKED_SCAN "sketch" is left out of the port '
                f"(one of {', '.join(PACKED_MODES)})")
        if mode not in PACKED_MODES:
            raise InvalidParameterValue(
                f'PGVECTOR_TPU_PACKED_SCAN "{mode}" is not a packed tier '
                f"(one of {', '.join(PACKED_MODES)})")
        if mode == "off" or self.kind != "dense":
            # only dense rows are value-packed (hnsw.py:1225-1229)
            return None
        if mode != "auto":
            return {"f32": torch.float32, "bf16": torch.bfloat16,
                    "int8": torch.int8}[mode]
        if self.device.type != "cuda":
            return None
        total = torch.cuda.get_device_properties(self.device).total_memory
        return auto_packed_dtype(self.cap_e, self.m, self.table.dim,
                                 self.metric, total)

    def _drop_packed(self) -> None:
        """Forget the slab and, with it, an int8 slab's scale and norms: a
        later scan rebuilds them over the current values and lists."""
        self._nbr_vals = self._nbr_scale = self._nbr_norm2 = None

    def _ensure_nbr_vals(self, dtype) -> torch.Tensor:
        """nbr_vals[cap, 2m, D] = values[nbr0]: each element's neighbor
        values as one contiguous slab (the scan then gathers Q·expand slabs
        per hop instead of Q·expand·2m rows).  Filled chunk by chunk, in
        place, so the (up to 8.6 GB at 1M×128 bf16) copy is never
        transiently doubled.

        int8 (hnsw.py:1296-1316): symmetric per-dim quantization, scale
        ``max|values| / 127`` over every value row (floored at 1e-30),
        rows ``clip(round(v / scale), -127, 127)`` (round half to even,
        as ``jnp.round``), and each row's dequantized squared norm kept
        by element id for the L2 close of the hop's dot form."""
        if self._nbr_vals is not None and self._nbr_vals.dtype == dtype:
            return self._nbr_vals
        self._drop_packed()
        with timers.phase("hnsw.slab_pack"):
            vecs = self.values
            if dtype == torch.int8:
                scale = torch.clamp(torch.amax(torch.abs(vecs.float()), dim=0),
                                    min=1e-30) / 127.0
                q8 = torch.empty(vecs.shape, dtype=torch.int8,
                                 device=self.device)
                norm2 = torch.empty(vecs.shape[0], device=self.device)
                for s in range(0, vecs.shape[0], 1 << 18):
                    v = vecs[s: s + (1 << 18)].float()
                    c = torch.clamp(torch.round(v / scale), -127, 127)
                    q8[s: s + (1 << 18)] = c.to(torch.int8)
                    norm2[s: s + (1 << 18)] = torch.sum(
                        torch.square(c * scale), dim=1)
                vecs, self._nbr_scale, self._nbr_norm2 = q8, scale, norm2
            out = torch.empty((self.cap_e, 2 * self.m, self.table.dim),
                              dtype=dtype, device=self.device)
            chunk = min(1 << 16, self.cap_e)
            for s in range(0, self.cap_e, chunk):
                nb = self.nbr0[s: s + chunk]
                # bf16: round to nearest even, as JAX's astype
                out[s: s + chunk] = vecs[K._long(nb)].to(dtype)
            self._sync()  # with timers on, the span is the device's time
        self._nbr_vals = out
        return out

    def _search_once(self, qs, k: int, ef: int, fmask):
        self._sync_device_meta()
        pdt = self._packed_plan()
        packed_vals = self._ensure_nbr_vals(pdt) if pdt is not None else None
        stats = {}
        d, r, steps = K.query_search(
            self.kind, self.metric, self.values, self.nbr0, self.nbr_up,
            self._up_slot_dev, self._elem_rows_dev, self.table.valid, fmask,
            qs, self.entry, self.entry_level, ef=ef, k=k, heaptids=HEAPTIDS,
            expand=self.beam_expand, packed_vals=packed_vals,
            packed_scale=self._nbr_scale, packed_norm2=self._nbr_norm2,
            rerank=(pdt is not None and pdt != torch.float32),
            sdim=self._scorer_sdim(), vmode=K.visited_mode(),
            # a straggler cap on layer-0 hops (a recall trade; 0 = none)
            max_steps=int(os.environ.get("PGVECTOR_TPU_QUERY_MAX_STEPS",
                                         "0") or 0), stats=stats)
        #: layer-0 hop count of the last scan (the reference's), and the
        #: hops launched: the beam loop reads the device every few hops
        self._last_scan_steps = steps
        self._last_scan_launches = stats["launches"]
        self.stats.query_hops += stats["query_hops"]
        return stored_to_user(self.metric, d), r

    def _search_iterative(self, qs, k: int, ef: int, fmask, mode: str):
        """The iterative scan: the first search keeps a discarded pool;
        each resume re-seeds layer 0 from it with the visited set intact
        (hnswscan.c:61-87).  ``strict_order`` suppresses results whose
        distance regressed below an earlier batch's maximum (the
        previousDistance filter, hnswscan.c:313-319); relaxed keeps them.
        Stops at hnsw.max_scan_tuples, the work_mem × scan_mem_multiplier
        memory cap (hnswscan.c:149-156, 255-266) or 64 batches."""
        self._sync_device_meta()
        nq = K._nq(qs)
        max_tuples = int(config.get("hnsw.max_scan_tuples"))
        mem_budget = (config.get("work_mem")
                      * config.get("hnsw.scan_mem_multiplier"))
        dk = max(4 * ef, 64)
        graph = (self.kind, self.metric, self.values, self.nbr0, self.nbr_up,
                 self._up_slot_dev)
        sdim = self._scorer_sdim()
        pool_d, pool_i, visited, disc_d, disc_i, sc_dev = K.query_search_first(
            *graph, qs, self.entry, self.entry_level, ef=ef, dk=dk,
            expand=self.beam_expand, sdim=sdim)
        heap = (self._elem_rows_dev, self.table.valid, fmask)
        acc_d: List[np.ndarray] = []
        acc_r: List[np.ndarray] = []
        prev_max = np.full(nq, -np.inf, np.float32)
        scanned = np.zeros(nq, np.int64)
        batches = 0
        while True:
            batches += 1
            d_dev, r_dev = K._expand_topk(pool_d, pool_i, *heap, ef,
                                          HEAPTIDS)
            host_read("iterative.batch")
            d = self._user_dist(d_dev).cpu().numpy()
            host_read("iterative.batch")
            r = r_dev.cpu().numpy()
            # meter every scored candidate (the so->tuples contract of
            # hnsw.max_scan_tuples, hnswscan.c:255-266)
            host_read("iterative.scanned")
            scanned += sc_dev.cpu().numpy().astype(np.int64)
            if mode == "strict_order" and batches > 1:
                bad = d < prev_max[:, None]
                d = np.where(bad, np.inf, d)
                r = np.where(bad, -1, r)
            finite = np.isfinite(d)
            batch_max = np.where(finite.any(axis=1),
                                 np.max(np.where(finite, d, -np.inf), axis=1),
                                 prev_max)
            prev_max = np.maximum(prev_max, batch_max.astype(np.float32))
            acc_d.append(d)
            acc_r.append(r)
            found = _count_found(acc_r, nq)
            host_read("iterative.discarded")
            disc_live = (~torch.all(torch.isinf(disc_d), dim=1)).cpu().numpy()
            active = (found < k) & (scanned < max_tuples) & disc_live
            state_bytes = (self._scan_bytes_per_query(ef)
                           + 4 * dk + batches * ef * 16)
            if not active.any() or state_bytes > mem_budget or batches >= 64:
                # the reference's "return remaining tuples" branch
                # (hnswscan.c:258-266): when a cap binds with fewer than k
                # results, emit from the (distance-sorted) discarded pool
                if ((found < k) & disc_live).any():
                    dd_dev, dr_dev = K._expand_topk(
                        disc_d, disc_i, *heap, min(dk, 4 * ef), HEAPTIDS)
                    host_read("iterative.remaining")
                    dd = self._user_dist(dd_dev).cpu().numpy()
                    host_read("iterative.remaining")
                    dr = dr_dev.cpu().numpy()
                    if mode == "strict_order":
                        bad = dd < prev_max[:, None]
                        dd = np.where(bad, np.inf, dd)
                        dr = np.where(bad, -1, dr)
                    acc_d.append(dd)
                    acc_r.append(dr)
                break
            pool_d, pool_i, visited, disc_d, disc_i, sc_dev = \
                K.query_search_resume(*graph, qs, visited, disc_d, disc_i,
                                      ef=ef, expand=self.beam_expand,
                                      sdim=sdim)
        #: iterative resume rounds of the last scan — stats.searches input
        self._last_scan_rounds = batches
        #: candidates each query of the last iterative scan scored
        self._last_scan_scanned = scanned
        all_d = np.concatenate(acc_d, axis=1)
        all_r = np.concatenate(acc_r, axis=1)
        kc = min(k, all_r.shape[1])
        m_d, m_r = K.merge_scan_batches(
            torch.as_tensor(all_d, dtype=torch.float32, device=self.device),
            torch.as_tensor(all_r, device=self.device), kc)
        out_d = np.full((nq, k), np.inf, np.float32)
        out_r = np.full((nq, k), -1, np.int64)
        host_read("search.distances")
        out_d[:, :kc] = m_d.cpu().numpy()
        host_read("search.rows")
        out_r[:, :kc] = m_r.cpu().numpy()
        return out_d, out_r

    def _user_dist(self, stored: torch.Tensor) -> torch.Tensor:
        return stored_to_user(self.metric, stored)

    # ------------------------------------------------------------------ vacuum
    def vacuum(self) -> None:
        """hnswbulkdelete's 4 passes (hnswvacuum.c:777-797), wave-batched.
        Each pass is a ``timers`` phase (``hnsw.vacuum.*``); ``last_vacuum``
        counts the elements freed and re-linked."""
        self._drop_packed()  # repair rewrites neighbor lists
        self.last_vacuum = {"deleted": 0, "repaired": 0}
        dev = self.device
        # pass 1: RemoveHeapTids (hnswvacuum.c:35-173): drop dead TIDs and
        # left-compact each element's TID row
        with timers.phase("hnsw.vacuum.remove_tids"):
            valid_rows = self.table.valid.cpu().numpy()
            live_elems = np.flatnonzero(self.levels >= 0)
            er = self.elem_rows[live_elems]  # (L, 10)
            keep = (er >= 0) & valid_rows[np.maximum(er, 0)]
            order = np.argsort(~keep, axis=1, kind="stable")
            self.elem_rows[live_elems] = np.take_along_axis(
                np.where(keep, er, -1), order, axis=1)
            self._dirty = True
            deleting = live_elems[~keep.any(axis=1)]
        if not len(deleting):
            return
        dead_mask = np.zeros(self.cap_e, bool)
        dead_mask[deleting] = True
        dead_dev = torch.as_tensor(dead_mask, device=dev)

        def refs_dead(nb):
            return dead_dev[K._long(nb)] & (nb >= 0)

        # pass 2: RepairGraph (hnswvacuum.c:378-502)
        with timers.phase("hnsw.vacuum.strip"):
            # which live elements reference a deleting element at any layer,
            # before the strip: the NeedsUpdated condition
            # (hnswvacuum.c:178-220 checks every layer)
            n = self.n_elems
            ref_any = refs_dead(self.nbr0).any(dim=1)[:n].cpu().numpy()
            ref_up_slot = refs_dead(self.nbr_up).any(dim=2).any(dim=1) \
                .cpu().numpy()
            ups = self.up_slot[:n]
            has_up = ups >= 0
            ref_any[has_up] |= ref_up_slot[ups[has_up]]
            # entry point replacement (RepairGraphEntryPoint :279-373)
            if self.entry >= 0 and dead_mask[self.entry]:
                survivors = live_elems[~dead_mask[live_elems]]
                if len(survivors):
                    j = int(np.argmax(self.levels[survivors]))
                    self.entry = int(survivors[j])
                    self.entry_level = int(self.levels[survivors[j]])
                else:
                    self.entry, self.entry_level = -1, -1
            # strip dead ids from every neighbor list
            _strip_dead(self.nbr0, self.kept0, dead_dev)
            _strip_dead(self.nbr_up, self.kept_up, dead_dev)
            self._sync()
        # re-link affected elements: NeedsUpdated = any layer's list
        # referenced a deleting element, or the level-0 list is not full
        # (:211-215).  The repair re-searches each element's whole level
        # range, so upper-level lists are repaired too.
        with timers.phase("hnsw.vacuum.repair"):
            if self.entry >= 0:
                lens = (self.nbr0[:n] >= 0).sum(dim=1).cpu().numpy()
                affected = np.flatnonzero(
                    (self.levels[:n] >= 0) & ~dead_mask[:n]
                    & (ref_any | (lens < 2 * self.m)))
                if len(affected):
                    self._repair_elements(affected)
                self.last_vacuum["repaired"] = len(affected)
            self._sync()

        # pass 3: ConfirmRepaired (hnswvacuum.c:507-589)
        with timers.phase("hnsw.vacuum.confirm"):
            if bool(refs_dead(self.nbr0).any()) or \
                    bool(refs_dead(self.nbr_up).any()):
                raise InternalError("hnsw graph not repaired")

        # pass 4: MarkDeleted (hnswvacuum.c:594-729): free the slots
        with timers.phase("hnsw.vacuum.mark_deleted"):
            for e in deleting.tolist():
                for r in self.elem_rows[e]:
                    if r >= 0:
                        self.row_to_elem.pop(int(r), None)
                self.free_slots.append(e)
            self.levels[deleting] = -1
            self.elem_rows[deleting, :] = -1
            # zero their values so dedup keys cannot match (MarkDeleted
            # zeroes vector data, hnswvacuum.c:694-699) — in a private
            # copy: an aliased tensor is the heap itself
            if self._alias_values:
                self._refresh_alias()
                self._set_value_arrays([a.clone()
                                        for a in self._value_arrays()])
                self._alias_values = False
            dele = torch.as_tensor(deleting.astype(np.int64), device=dev)
            for a, f in zip(self._value_arrays(), self._value_fills()):
                a[dele] = f
            self.nbr0[dele] = -1
            self.kept0[dele] = False
            up = self.up_slot[deleting]
            up = up[up >= 0].astype(np.int64)
            if len(up):
                up_dev = torch.as_tensor(up, device=dev)
                self.nbr_up[up_dev] = -1
                self.kept_up[up_dev] = False
            if self.dedup:
                self._dup_index = {key: e for key, e in self._dup_index.items()
                                   if not dead_mask[e]}
            self._dirty = True
            self.last_vacuum["deleted"] = len(deleting)
            self._sync()

    def _repair_elements(self, elems: np.ndarray) -> None:
        """RepairGraphElement (hnswvacuum.c:225-274): recompute neighbors
        from scratch with a fresh search wave and overwrite the lists."""
        lv = self.levels[elems]
        wave = self._effective_wave_size()
        for start in range(0, len(elems), wave):
            self._insert_wave_repair(elems[start: start + wave],
                                     lv[start: start + wave])

    def _insert_wave_repair(self, elems: np.ndarray, lv: np.ndarray) -> None:
        """Like _insert_wave, for elements already in the graph (the
        existing=true search, hnswutils.c:1278): self-links are excluded
        from the candidate pools."""
        if self.entry < 0 or len(elems) == 0:
            return
        if self.backlink_mode == "incremental":
            pools = self._search_wave(elems, lv, exclude_self=True)
            self._connect_from_pools(elems, lv, pools)
        else:
            self._insert_wave_fused(elems, lv, exclude_self=True)

    # ------------------------------------------------------------- statistics
    @property
    def live_elements(self) -> int:
        return int((self.levels >= 0).sum())


def _strip_dead(nbr: torch.Tensor, kept: torch.Tensor,
                dead: torch.Tensor) -> None:
    """Blank, in place, every id in the neighbor lists ``nbr`` that
    ``dead`` (a bool per element) marks, and the kept flags of its slot."""
    nbr.masked_fill_(dead[K._long(nbr)] & (nbr >= 0), -1)
    kept &= nbr >= 0


def _count_found(acc_r: List[np.ndarray], nq: int) -> np.ndarray:
    """Distinct result rows collected so far per query (one sort over the
    whole batch)."""
    s = np.sort(np.concatenate(acc_r, axis=1), axis=1)
    new = np.concatenate(
        [s[:, :1] >= 0, (s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)], axis=1)
    return new.sum(axis=1, dtype=np.int64)


def _take(values, idx: torch.Tensor):
    """Rows ``idx`` of a value block (a tensor or a sparse (idx, val)
    pair)."""
    if isinstance(values, tuple):
        return tuple(a[idx] for a in values)
    return values[idx]


def _host_rows(values) -> np.ndarray:
    """The bytes of each row of a value block (a tensor or a sparse (idx,
    val) pair, whose row keys are its index bytes then its value bytes),
    as one host (n, bytes) uint8 array."""
    arrays = values if isinstance(values, tuple) else (values,)
    parts = [np.ascontiguousarray(_host_array(a)) for a in arrays]
    n = parts[0].shape[0]
    return np.concatenate([p.reshape(n, -1).view(np.uint8) for p in parts],
                          axis=1)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` with the same bytes (bfloat16 as its uint16
    bit pattern: numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dup_keys(host_vals: np.ndarray) -> List[bytes]:
    """Per row, the bytes of its values: rows with equal keys are
    duplicates.  One host buffer, sliced by row."""
    n = len(host_vals)
    buf = np.ascontiguousarray(host_vals).tobytes()
    w = host_vals[0].nbytes if n else 0
    return [buf[i * w:(i + 1) * w] for i in range(n)]


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
