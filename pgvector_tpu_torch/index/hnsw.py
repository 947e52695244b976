"""HNSW index over a dense table — counterpart of
``pgvector_tpu.index.hnsw`` (dense build in ``wholesale`` backlink mode,
and search with ``hnsw.iterative_scan = off``).

Graph layout, as in the reference:

- ``values``    — the index's vector copies (normalized for cosine); they
                  alias the table's tensor when rows map 1:1 to elements
- ``nbr0``      — int32[cap, 2m] level-0 neighbors
- ``nbr_up``    — int32[cap_up, L, m] upper-level neighbors of the ~1/m
                  elements with level ≥ 1 (``up_slot`` maps element → row)
- ``kept0`` / ``kept_up`` — sticky heuristic-kept flags per neighbor slot
- ``levels``, ``elem_rows`` — host numpy bookkeeping (level per element,
                  up to 10 heap TIDs per element)

Build is wave-parallel: batches of elements search the frozen graph
together (``wave_search``), select neighbors together and merge backlinks
grouped by target (``connect_level``).  Levels come from
``np.random.default_rng(seed)`` exactly as the reference draws them, so
both packages give every element the same level.

Search is Algorithm 5 (hnswscan.c:25-56).  On CUDA tables the layer-0 scan
reads an adjacency-packed copy of the neighbor values (f32 or bf16, sized
to the card's memory) and runs each hop's tail in K2.

Not ported yet: heap-TID dedup (``dedup=True``), inserts after the build,
vacuum, iterative scans, the int8 and sketch packed tiers, and the bit and
sparse kinds.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..errors import DataException, FeatureNotSupported, InvalidParameterValue
from ..ops.metric import Metric, stored_to_user
from ..store.table import DenseTable
from ..utils.stats import ScanStats
from ..utils.telemetry import Progress, timers
from . import hnsw_kernels as K

# reloption bounds — src/hnsw.h:53-62
DEFAULT_M = 16
MIN_M, MAX_M = 2, 100
DEFAULT_EF_CONSTRUCTION = 64
MIN_EF_CONSTRUCTION, MAX_EF_CONSTRUCTION = 4, 1000

#: per-type dimension caps (hnswutils.c:1375-1431, hnsw.h:33-34)
MAX_DIM_F32 = 2000
MAX_DIM_F16 = 4000

#: heap TIDs per element (hnsw.h:69)
HEAPTIDS = 10

#: static upper-level array depth; P(level ≥ 12) = m^-12 — unreachable
L_MAX = 12

DENSE_OPCLASSES = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)

#: PGVECTOR_TPU_PACKED_SCAN modes of the reference that the port takes
PACKED_MODES = ("auto", "off", "f32", "bf16")


class HNSWIndex:
    """An HNSW access method over a DenseTable, on the table's device."""

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
        progress=None,
        capacity: Optional[int] = None,
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
        if not isinstance(table, DenseTable):
            raise FeatureNotSupported(
                f"hnsw over {type(table).__name__} is not ported yet")
        if metric not in DENSE_OPCLASSES:
            raise FeatureNotSupported(
                f"operator {metric.op} is not supported by hnsw for vectors")
        cap = MAX_DIM_F16 if table.dtype != torch.float32 else MAX_DIM_F32
        if table.dim > cap:
            raise DataException(
                f"column cannot have more than {cap} dimensions for hnsw index")
        if backlink_mode != "wholesale":
            raise FeatureNotSupported(
                f'backlink_mode "{backlink_mode}" is not ported yet')
        if dedup:
            raise FeatureNotSupported(
                "hnsw heap-TID dedup is not ported yet; pass dedup=False")
        self.table = table
        self.device = table.device
        self.metric = metric
        self.m = m
        self.ef_construction = ef_construction
        self.seed = seed
        self.wave_size = wave_size
        #: candidates expanded per beam hop (1 = exact Algorithm 2 order)
        self.beam_expand = beam_expand
        self.backlink_mode = backlink_mode
        self.dedup = dedup
        self.progress = progress or Progress()
        #: pg_stat_user_indexes / nsearches analogue (utils/stats.py)
        self.stats = ScanStats()
        self.ml = 1.0 / math.log(m)  # hnsw.h:130
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
        (E[count at L] = n·m^-L), as the reference derives it."""
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
        self._val_dtype = (t.dtype if t.dtype in (torch.bfloat16, torch.float16)
                           else torch.float32)
        # the index's vector copy aliases the table's tensor while rows map
        # 1:1 to elements and values are stored unmodified (not cosine)
        self._alias_values = (self.metric is not Metric.COSINE
                              and self._val_dtype == t.dtype
                              and self._table_rows() >= capacity)
        if self._alias_values:
            self._refresh_alias()
        else:
            self.values = torch.zeros((capacity, t.dim), dtype=self._val_dtype,
                                      device=dev)
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
        self._up_slot_dev: Optional[torch.Tensor] = None
        self._elem_rows_dev: Optional[torch.Tensor] = None
        self._dirty = True
        #: adjacency-packed neighbor values for the scan (built lazily,
        #: dropped by any graph change)
        self._nbr_vals: Optional[torch.Tensor] = None
        self._last_scan_steps = 0

    def _table_rows(self) -> int:
        return int(self.table.data.shape[0])

    def _refresh_alias(self) -> None:
        """Re-point aliased values at the table's current tensor (growth
        replaces it)."""
        if self._alias_values:
            self.values = self.table.data

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

    # ----------------------------------------------------------- index values
    def _form_values(self, rows: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """HnswFormIndexValue (hnswutils.c:406-428): fetch and normalize
        (cosine) the rows' values.  Returns (values, keep mask) — zero-norm
        rows are not indexed for cosine (hnswutils.c:417-423)."""
        r = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        vals = self.table.data[r]
        if self.metric is Metric.COSINE:
            vals = vals.float()
            norms = torch.sqrt(torch.sum(vals * vals, dim=1, keepdim=True))
            keep = (norms[:, 0] > 0).cpu().numpy()
            vals = vals / torch.clamp(norms, min=1e-30)
            return vals.to(self._val_dtype), keep
        return vals.to(self._val_dtype), np.ones(len(rows), bool)

    def _query_rep(self, q) -> torch.Tensor:
        """GetScanValue (hnswscan.c:92-114): coerce + normalize queries."""
        from .flat import _coerce_dense_queries

        qs = _coerce_dense_queries(q, self.table.dim, self.device)
        if self.metric is Metric.COSINE:
            norms = torch.sqrt(torch.sum(qs * qs, dim=1, keepdim=True))
            qs = qs / torch.clamp(norms, min=1e-30)
        return qs

    # ------------------------------------------------------------------ build
    def build(self) -> None:
        t = self.table
        self.progress.set_phase("initializing")
        live = np.flatnonzero(t.valid[: t.count].cpu().numpy())
        if len(live) == 0:
            return
        self.progress.set_phase("loading tuples", len(live))
        with timers.phase("hnsw.build"):
            self._insert_rows(live)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _insert_rows(self, rows: np.ndarray) -> None:
        """Insert table rows as new elements (dedup=False: one element per
        row), then run the wave schedule."""
        self._refresh_alias()
        if self._alias_values:
            values, keep = None, np.ones(len(rows), bool)
        else:
            values, keep = self._form_values(rows)
            rows = rows[keep]
            if not keep.all():
                values = values[torch.as_tensor(np.flatnonzero(keep),
                                                device=self.device)]
        if len(rows) == 0:
            return
        elems = np.asarray(self._alloc_slots(len(rows)), np.int64)
        # levels = floor(-ln(U)·ml), drawn exactly as the reference draws
        # them (hnsw.py:540-543)
        lv = np.minimum(
            np.floor(-np.log(self._rng.random(len(rows))) * self.ml).astype(np.int32),
            self._l_unroll,
        )
        self.levels[elems] = lv
        self.elem_rows[elems, :] = -1
        self.elem_rows[elems, 0] = rows
        need_up = (lv >= 1) & (self.up_slot[elems] < 0)
        if need_up.any():
            self.up_slot[elems[need_up]] = self._alloc_upper_bulk(int(need_up.sum()))
        self._dirty = True
        self._nbr_vals = None  # the graph is about to change
        if values is None:
            if not np.array_equal(rows, elems):
                # rows that do not map 1:1 to elements (deleted rows) break
                # the alias: gather every element its own copy by TID
                self._alias_values = False
                live = np.flatnonzero(self.elem_rows[:, 0] >= 0)
                src = torch.as_tensor(self.elem_rows[live, 0].astype(np.int64),
                                      device=self.device)
                self.values = torch.zeros(
                    (self.cap_e, self.table.dim), dtype=self._val_dtype,
                    device=self.device)
                self.values[torch.as_tensor(live, device=self.device)] = \
                    self.table.data[src].to(self._val_dtype)
        else:
            # in place into the index's own value tensor
            self.values[torch.as_tensor(elems, device=self.device)] = values
            del values
        wave_size = self._effective_wave_size()
        for p in range(0, len(elems), wave_size):
            with timers.phase("hnsw.wave"):
                self._insert_wave(elems[p: p + wave_size], lv[p: p + wave_size])
            self.progress.advance(min(wave_size, len(elems) - p))

    def _wave_bytes(self, b: int) -> int:
        """Transient device bytes of one insert wave of ``b`` elements: the
        beam pools, the pairwise select block and the per-level output
        pools (the visited table of the reference is mode ``off`` here)."""
        ef = self.ef_construction
        c = ef + min(self.m, b)  # beam pool + intra-wave candidates
        rep = 4 * self.table.dim
        per_q = (4 * c * c                     # pairwise select block
                 + (ef + c) * (rep + 9)        # pool vectors + dists + ids
                 + (self._l_unroll + 1) * ef * 8)  # stacked per-level pools
        return b * per_q

    def _effective_wave_size(self) -> int:
        """Shrink the wave until its working set fits maintenance_work_mem
        (hnswbuild.c:530-549)."""
        budget = int(config.get("maintenance_work_mem"))
        wave = self.wave_size
        while wave > 8 and self._wave_bytes(wave) > budget:
            wave //= 2
        return wave

    def _alloc_slots(self, n: int) -> np.ndarray:
        while self.n_elems + n > self.cap_e:
            self._grow()
        out = np.arange(self.n_elems, self.n_elems + n, dtype=np.int64)
        self.n_elems += n
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
        self._nbr_vals = None
        pad = new_cap - self.cap_e
        # growth pads the values past the table: the copy is private now
        self._refresh_alias()
        self._alias_values = False
        self.values = torch.cat([self.values, self.values.new_zeros(
            (pad, self.values.shape[1]))])
        self.nbr0 = torch.cat([self.nbr0, self.nbr0.new_full((pad, 2 * self.m), -1)])
        self.kept0 = torch.cat([self.kept0, self.kept0.new_zeros((pad, 2 * self.m))])
        self.up_slot = np.concatenate([self.up_slot, np.full(pad, -1, np.int32)])
        self.levels = np.concatenate([self.levels, np.full(pad, -1, np.int32)])
        self.elem_rows = np.concatenate(
            [self.elem_rows, np.full((pad, HEAPTIDS), -1, np.int32)])
        self.cap_e = new_cap
        self._dirty = True

    # ------------------------------------------------------------ wave insert
    def _search_wave_raw(self, elems: np.ndarray, lv: np.ndarray):
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
        qs = K.elems_as_queries(self.values, e_dev)
        out_d, out_i = K.wave_search(
            self.metric, self.values, self.nbr0, self.nbr_up,
            self._up_slot_dev, qs, lv_pad.astype(np.int32), self.entry,
            self.entry_level, ef=self.ef_construction,
            l_unroll=self._l_unroll, expand=self.beam_expand)
        return out_d, out_i, nq, nq_pad

    def _insert_wave_fused(self, elems: np.ndarray, lv: np.ndarray) -> None:
        """Search + connect: one wave search, then one connect pass per
        level from the top eligible level down."""
        with timers.phase("hnsw.wave.search"):
            out_d, out_i, nq, nq_pad = self._search_wave_raw(elems, lv)
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
                    # block instead of a full-wave connect
                    idx_e = np.flatnonzero(elig)
                    b_lvl = _round_pow2(max(len(idx_e), 64))
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
                K.connect_level(
                    self.metric, self.values, self.nbr0, self.nbr_up,
                    self.kept0, self.kept_up, self._up_slot_dev, e_lvl,
                    elig_dev, lc, pd, pi, m=self.m, mi=min(self.m, b_lvl),
                    smax=lm, chunk=chunk)

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
        self._insert_wave_fused(elems, lv)
        wave_max = int(lv.max()) if len(lv) else -1
        if wave_max > self.entry_level:
            j = int(np.argmax(lv))
            self.entry = int(elems[j])
            self.entry_level = wave_max

    # ------------------------------------------------------------------ search
    def search(self, q, k: int, ef_search: Optional[int] = None,
               filter_mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Algorithm 5 scan (hnswscan.c).  Returns (operator distances,
        row ids) as numpy arrays, -1/inf padded; the result count is capped
        at ef_search (README.md:933-935)."""
        ef = int(config.validate("hnsw.ef_search", ef_search)
                 if ef_search is not None else config.get("hnsw.ef_search"))
        if config.get("hnsw.iterative_scan") != "off":
            raise FeatureNotSupported("hnsw.iterative_scan is not ported yet")
        qs = self._query_rep(q)
        nq = qs.shape[0]
        if self.entry < 0:
            return (np.full((nq, k), np.inf, np.float32),
                    np.full((nq, k), -1, np.int32))
        fmask = (torch.as_tensor(np.asarray(filter_mask, dtype=bool),
                                 device=self.device)
                 if filter_mask is not None else None)
        d, r = self._search_once(qs, k, ef, fmask)
        d, r = d.cpu().numpy(), r.cpu().numpy()
        self.stats.count(nq, r)
        return d, r

    def _packed_plan(self):
        """Layer-0 value packing dtype (or None for row gathers), from
        PGVECTOR_TPU_PACKED_SCAN: ``auto``, ``off``, ``f32``, ``bf16``.

        ``auto`` packs only on CUDA (as the reference packs only on a TPU):
        f32 while the (cap, 2m, D) copy is at most 1/8 of the device
        memory, bf16 while its bf16 half is at most 9/16 — the reference's
        2 GB / 9 GB thresholds on a 16 GB chip, in the same ratio."""
        mode = os.environ.get("PGVECTOR_TPU_PACKED_SCAN", "auto")
        if mode not in PACKED_MODES:
            raise InvalidParameterValue(
                f'PGVECTOR_TPU_PACKED_SCAN "{mode}" is not ported yet '
                f"(one of {', '.join(PACKED_MODES)})")
        if mode == "off":
            return None
        if mode == "f32":
            return torch.float32
        if mode == "bf16":
            return torch.bfloat16
        if self.device.type != "cuda":
            return None
        total = torch.cuda.get_device_properties(self.device).total_memory
        f32_bytes = self.cap_e * 2 * self.m * self.table.dim * 4
        if f32_bytes <= total // 8:
            return torch.float32
        if f32_bytes // 2 <= total * 9 // 16:
            return torch.bfloat16
        return None

    def _ensure_nbr_vals(self, dtype) -> torch.Tensor:
        """nbr_vals[cap, 2m, D] = values[nbr0]: each element's neighbor
        values as one contiguous slab (the scan then gathers Q·expand slabs
        per hop instead of Q·expand·2m rows).  Filled chunk by chunk, in
        place, so the (up to 8.6 GB at 1M×128 bf16) copy is never
        transiently doubled."""
        if self._nbr_vals is not None and self._nbr_vals.dtype == dtype:
            return self._nbr_vals
        self._nbr_vals = None
        out = torch.empty((self.cap_e, 2 * self.m, self.table.dim),
                          dtype=dtype, device=self.device)
        chunk = min(1 << 16, self.cap_e)
        for s in range(0, self.cap_e, chunk):
            nb = self.nbr0[s: s + chunk]
            # bf16: round to nearest even, as JAX's astype
            out[s: s + chunk] = self.values[K._long(nb)].to(dtype)
        self._nbr_vals = out
        return out

    def _search_once(self, qs, k: int, ef: int, fmask):
        self._sync_device_meta()
        pdt = self._packed_plan()
        packed_vals = self._ensure_nbr_vals(pdt) if pdt is not None else None
        d, r, steps = K.query_search(
            self.metric, self.values, self.nbr0, self.nbr_up,
            self._up_slot_dev, self._elem_rows_dev, self.table.valid, fmask,
            qs, self.entry, self.entry_level, ef=ef, k=k, heaptids=HEAPTIDS,
            expand=self.beam_expand, packed_vals=packed_vals,
            rerank=(pdt is not None and pdt != torch.float32))
        #: layer-0 hop count of the last scan
        self._last_scan_steps = steps
        return stored_to_user(self.metric, d), r


def _round_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
