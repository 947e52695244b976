"""IVFFlat index — counterpart of ``pgvector_tpu.index.ivfflat``: a
``DenseTable`` of f32, bf16 or f16 values under the L2, inner-product and
cosine opclasses, or a ``BitTable`` under ``bit_hamming_ops`` (k-means on
the unpacked 0/1 bits with binary centers; Hamming order equals L2 order
on unpacked bits against binary centers).

Layout, as in the reference: centroids are an f32 ``(lists, D)`` tensor;
posting lists are laid out in *compact blocks*: each list occupies
``ceil(len / cs)`` consecutive blocks of ``cs`` slots of one flat slot
array (``postings_flat``), and the index keeps its own value copy in that
order (``post_values``, ``(blocks, cs, D)`` in the table's dtype, formed:
normalized for cosine) with each slot's squared norm (``post_vsq``).
Build phases mirror the reference's four (ivfflat.c:64-80): sampling,
k-means (:mod:`.ivf_kmeans`), assigning tuples (one product per chunk of
rows), loading tuples (one stable sort by list on the host).  With a
``mesh`` of more than one device, k-means runs sample-sharded over it
(``parallel.sharded.train_centers_sharded``).

Search (ivfscan.c): distances to all centers → the ``probes`` nearest
lists → exact distances over their postings → top-k, with iterative
scans (``ivfflat.iterative_scan = relaxed_order``) fetching further probe
batches until k results pass the filter or ``ivfflat.max_probes`` is
reached.  Two formulations of one probe batch, picked by coverage:

- *inverted*: the (query → probed list) edges are cut on the host into
  fixed-shape work items (one list, ≤ Qc of its probing queries, one
  window of ≤ Wb blocks); each item is one batched product of its queries
  against its window, then a per-query merge.  Deletes and filters are a
  mask in posting-slot space; row ids appear only at the end.
- *blocks*: each query gathers the blocks of its own probed lists.

A bit index keeps packed words in posting order and always takes the
block route, its popcounts in K5 (:func:`..ops.bit_scan.bit_point_scores`).
Selections keep the reference's tie rule (``lax.top_k``: the lower
position first) through the stable sort of :func:`..ops.topk.topk_smallest`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..errors import DataException, FeatureNotSupported
from ..ops import distance as D
from ..ops.bit_scan import bit_point_scores
from ..ops.metric import Metric, stored_to_user
from ..ops.topk import merge_topk, topk_smallest
from ..store.table import BitTable, DenseTable
from ..utils.stats import ScanStats
from ..utils.telemetry import Progress, timers
from .flat import _coerce_dense_queries
from .ivf_kmeans import train_centers

#: reloption bounds — src/ivfflat.h:54-58
DEFAULT_LISTS = 100
MIN_LISTS, MAX_LISTS = 1, 32768

#: per-type dimension caps (IvfflatTypeInfo, src/ivfutils.c:282-423)
MAX_DIM_F32 = 2000
MAX_DIM_F16 = 4000
MAX_DIM_BIT = 64000

DENSE_OPCLASSES = (Metric.L2, Metric.IP, Metric.COSINE)
BIT_OPCLASSES = (Metric.HAMMING,)

#: finite "masked" score of the inverted scan, turned into +inf / −1 after
#: the selection (the reference's sentinel; any real score is far below)
_IVF_BIG = 3.0e38


def _sync(device: torch.device) -> None:
    """End a timed build phase on the device's clock, not the enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class IVFFlatIndex:
    """An IVFFlat access method over a DenseTable or BitTable, on the
    table's device."""

    #: rows per contiguous value block — the probe scan's gather unit
    POST_BLOCK = 512

    #: take the inverted scan when Q · probes · INVERT_COVERAGE ≥ lists
    INVERT_COVERAGE = 32

    #: work-item floors of the inverted scan: ≤ WORK_QC queries against a
    #: window of ≈ WORK_SLOTS posting slots (adapted per batch)
    WORK_QC = 64
    WORK_SLOTS = 1024

    def __init__(self, table: DenseTable, metric: Metric,
                 lists: int = DEFAULT_LISTS, seed: int = 0,
                 build: bool = True, notice_hook=None, progress=None,
                 mesh=None):
        if not MIN_LISTS <= lists <= MAX_LISTS:
            raise DataException(
                f'value {lists} out of bounds for option "lists"')
        self._is_bit = isinstance(table, BitTable)
        if self._is_bit:
            if metric not in BIT_OPCLASSES:
                raise FeatureNotSupported(
                    f"operator class bit_{metric.name.lower()}_ops does not "
                    "exist for ivfflat")
            if table.dim > MAX_DIM_BIT:
                raise DataException(
                    f"column cannot have more than {MAX_DIM_BIT} dimensions "
                    "for ivfflat index")
        else:
            if metric not in DENSE_OPCLASSES:
                raise FeatureNotSupported(
                    f"operator {metric.op} is not supported by ivfflat")
            if not isinstance(table, DenseTable):
                raise FeatureNotSupported(
                    f"ivfflat does not support {type(table).__name__}")
            cap = MAX_DIM_F16 if table.dtype != torch.float32 else MAX_DIM_F32
            if table.dim > cap:
                raise DataException(
                    f"column cannot have more than {cap} dimensions for "
                    "ivfflat index")
        self.table = table
        self.device = table.device
        self.metric = metric
        #: optional ``parallel.Mesh``: with more than one device, k-means
        #: trains data-parallel over it (sample-sharded Lloyd's rounds,
        #: the reference's parallel k-means phase, ivfbuild.c:829-966)
        self.mesh = mesh
        self.lists = lists
        self.seed = seed
        self.notice_hook = notice_hook or (lambda msg: None)
        #: pg_stat_user_indexes / nsearches analogue (utils/stats.py)
        self.stats = ScanStats()
        self.progress = progress or Progress()
        #: (lists, D) f32 centers (0/1 floats for bit)
        self.centroids: Optional[torch.Tensor] = None
        self.postings: Optional[np.ndarray] = None  # host (lists, cap)
        self.postings_flat: Optional[torch.Tensor] = None  # compact slots
        self.post_values: Optional[torch.Tensor] = None
        self.post_vsq: Optional[torch.Tensor] = None
        self.list_lens: Optional[np.ndarray] = None
        self.assignments: Optional[np.ndarray] = None
        self.indexed_mask: Optional[np.ndarray] = None
        #: Lloyd's iterations of the last build
        self.kmeans_iters = 0
        #: probe route of the last probe batch ("inverted" or "blocks")
        self.last_path = ""
        if build:
            self.build()

    # ------------------------------------------------------------------ build
    @property
    def _normalized(self) -> bool:
        return self.metric is Metric.COSINE

    @property
    def _spherical(self) -> bool:
        """IP and cosine both train spherical k-means (sql/vector.sql:412-425)."""
        return self.metric in (Metric.IP, Metric.COSINE)

    def _index_values(self, rows: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        """Formed f32 values of table rows (normalized for cosine, unpacked
        0/1 bits for bit) and the keep mask: zero-norm rows are not indexed
        for cosine (ivfbuild.c:174-179)."""
        r = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        if self._is_bit:
            return (D.unpack_bits(self.table.data[r], self.table.dim),
                    np.ones(len(rows), bool))
        vals = self.table.data[r].float()
        if self._normalized:
            norms = torch.sqrt(torch.sum(vals * vals, dim=1))
            keep = (norms > 0).cpu().numpy()
            return vals / torch.clamp(norms, min=1e-30)[:, None], keep
        return vals, np.ones(len(rows), bool)

    def build(self) -> None:
        """BuildIndex (ivfbuild.c:1040-1060) in the four progress phases."""
        t = self.table
        self.progress.set_phase("initializing")
        live = np.flatnonzero(t.valid[: t.count].cpu().numpy())
        n_live = len(live)
        rng = np.random.default_rng(self.seed)

        # phase 1: sample (the reservoir of ivfbuild.c:132-156); the same
        # numpy draw as the reference, so both sample the same rows
        with timers.phase("ivfflat.sample"):
            target = max(50 * self.lists, 10000)
            if n_live <= target:
                sample_rows = live
            else:
                sample_rows = rng.choice(live, size=target, replace=False)
            if n_live < self.lists:
                self.notice_hook(
                    "ivfflat index created with little data\n"
                    "DETAIL:  This will cause low recall.\n"
                    "HINT:  Drop the index until the table has more data.")
            samples = None
            if len(sample_rows):
                samples, keep = self._index_values(sample_rows)
                if not keep.all():
                    samples = samples[torch.as_tensor(
                        np.flatnonzero(keep), device=self.device)]
            _sync(self.device)

        # phase 2: k-means
        self.progress.set_phase("performing k-means")
        with timers.phase("ivfflat.kmeans"):
            if samples is None:
                # RandomCenters on an empty table (ivfkmeans.c:110-133)
                c = rng.random((self.lists, t.dim)).astype(np.float32)
                if self._is_bit:
                    c = (c > 0.5).astype(np.float32)
                elif self._normalized:
                    c = c / np.maximum(
                        np.linalg.norm(c, axis=1, keepdims=True), 1e-30)
                centers = torch.as_tensor(c, device=self.device)
                self.kmeans_iters = 0
            elif self.mesh is not None and self.mesh.size > 1:
                from ..parallel.sharded import _train_centers_sharded

                s = samples.float()
                if self._normalized:
                    s = s / torch.clamp(torch.sqrt(torch.sum(
                        s * s, dim=1, keepdim=True)), min=1e-30)
                centers, self.kmeans_iters = _train_centers_sharded(
                    self.mesh, s, self.lists, spherical=self._spherical,
                    binary=self._is_bit, seed=self.seed)
                centers = centers.to(self.device)
            else:
                centers, self.kmeans_iters = train_centers(
                    samples, self.lists, spherical=self._spherical,
                    binary=self._is_bit, normalize_data=self._normalized,
                    seed=self.seed)
        self.centroids = centers

        # phases 3 and 4: assign, load
        self.progress.set_phase("assigning tuples", len(live))
        with timers.phase("ivfflat.assign"):
            assignments = self._assign_all(live)
        self.progress.set_phase("loading tuples", len(live))
        with timers.phase("ivfflat.load"):
            self._load_postings(assignments)
            _sync(self.device)
        if os.environ.get("PGVECTOR_TPU_KMEANS_DEBUG", "0") == "1":
            m = self.kmeans_metrics()
            self.notice_hook(f"inertia: {m['inertia']:.3e}")
            if m["davies_bouldin"] is not None:
                self.notice_hook(f"davies-bouldin: {m['davies_bouldin']:.3f}")

    def _assign_all(self, rows: np.ndarray) -> np.ndarray:
        """Every row's list (−1: not indexed), over the table's capacity."""
        assignments = np.full(self.table.capacity, -1, np.int64)
        chunk = 65536
        for s in range(0, len(rows), chunk):
            rs = rows[s: s + chunk]
            vals, keep = self._index_values(rs)
            a = self._nearest_center(vals).cpu().numpy()
            a[~keep] = -1  # zero-norm cosine rows are not indexed
            assignments[rs] = a
        return assignments

    def _nearest_center(self, vals: torch.Tensor) -> torch.Tensor:
        c = self.centroids
        D.dot_precision()
        ip = vals @ c.T
        if self._spherical:
            return torch.argmax(ip, dim=1)
        c_sq = torch.sum(c * c, dim=1)
        return torch.argmin(c_sq[None, :] - 2.0 * ip, dim=1)

    def _load_postings(self, assignments: np.ndarray) -> None:
        """Lay row ids out in compact blocks: one stable sort by list, one
        scatter (the array form of the reference's per-list page chains,
        ivfbuild.c:271-331).  ``postings`` is the host (lists, cap) view."""
        rows = np.flatnonzero(assignments >= 0)
        a = assignments[rows].astype(np.int64)
        counts = np.bincount(a, minlength=self.lists) if len(rows) else \
            np.zeros(self.lists, np.int64)
        cap = max(8, _next_pow2(int(counts.max()) if len(rows) else 1))
        postings = np.full((self.lists, cap), -1, np.int32)
        cs = min(self.POST_BLOCK, cap)
        occ = (counts + cs - 1) // cs  # blocks per list
        bs = np.zeros(self.lists + 1, np.int64)
        bs[1:] = np.cumsum(occ)
        flat = np.full(max(int(bs[-1]), 1) * cs, -1, np.int32)
        if len(rows):
            order = np.argsort(a, kind="stable")
            sr, sa = rows[order], a[order]
            starts = np.zeros(self.lists, np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            pos = np.arange(len(sr)) - starts[sa]
            postings[sa, pos] = sr
            flat[bs[sa] * cs + pos] = sr
        dev = self.device
        self.postings = postings
        self._post_cs = cs
        self._blk_start = bs          # host (lists+1,) block offsets
        self._blk_occ = occ           # host (lists,) blocks per list
        self.postings_flat = torch.as_tensor(flat, device=dev)
        self._blk_start_dev = torch.as_tensor(bs[:-1].astype(np.int32),
                                              device=dev)
        self._blk_occ_dev = torch.as_tensor(occ.astype(np.int32), device=dev)
        self.list_lens = counts.astype(np.int64)
        self.assignments = assignments
        self.indexed_mask = assignments >= 0
        self._refresh_post_values()

    def _refresh_post_values(self) -> None:
        """The index's value copy in posting order, with per-slot |v|²,
        filled chunk by chunk in place: no second table-sized transient."""
        self.post_values = self.post_vsq = None  # free the old copy first
        flat = self.postings_flat
        data = self.table.data
        dim, cs = data.shape[1], self._post_cs
        pv = torch.empty((flat.numel(), dim), dtype=data.dtype,
                         device=self.device)
        if self._is_bit:  # packed words; no norms
            for s in range(0, flat.numel(), 1 << 20):
                f = flat[s: s + (1 << 20)]
                pv[s: s + (1 << 20)] = torch.where(
                    (f >= 0)[:, None], data[torch.clamp(f, min=0).long()], 0)
            self.post_values = pv.view(-1, cs, dim)
            return
        vsq = torch.empty(flat.numel(), dtype=torch.float32,
                          device=self.device)
        chunk = max(1, (1 << 27) // (4 * dim))  # ≤ 128 MB of f32 a chunk
        zero = torch.zeros((), dtype=data.dtype, device=self.device)
        for s in range(0, flat.numel(), chunk):
            f = flat[s: s + chunk]
            v = torch.where((f >= 0)[:, None], data[torch.clamp(f, min=0).long()],
                            zero)
            if self._normalized:
                vf = v.float()
                nrm = torch.sqrt(torch.sum(vf * vf, dim=-1, keepdim=True))
                v = (vf / torch.clamp(nrm, min=1e-30)).to(data.dtype)
            vf = v.float()
            pv[s: s + chunk] = v
            vsq[s: s + chunk] = torch.sum(vf * vf, dim=-1)
        self.post_values = pv.view(-1, cs, dim)
        self.post_vsq = vsq.view(-1, cs)

    # ----------------------------------------------------------------- insert
    def insert(self, rows) -> None:
        """aminsert: assign new rows to their nearest list (FindInsertPage,
        ivfinsert.c:19-67) and append them in place, or re-lay the blocks
        when a list outgrows its allocated blocks."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if self.postings is None:
            raise DataException("index has not been built")
        vals, keep = self._index_values(rows)
        a = self._nearest_center(vals).cpu().numpy().astype(np.int64)
        a[~keep] = -1
        if len(self.assignments) < self.table.capacity:
            grown = np.full(self.table.capacity, -1, np.int64)
            grown[: len(self.assignments)] = self.assignments
            self.assignments = grown
        self.assignments[rows] = a
        self.indexed_mask = self.assignments >= 0
        live = a >= 0
        if not live.any():
            return
        cs = self._post_cs
        extra = np.bincount(a[live], minlength=self.lists)
        if ((self.list_lens + extra) > self._blk_occ * cs).any():
            self._load_postings(self.assignments)
            return
        ins_rows, ins_a = rows[live], a[live]
        # slot = current fill + rank within the batch
        order = np.argsort(ins_a, kind="stable")
        sr, sa = ins_rows[order], ins_a[order]
        batch_counts = np.bincount(sa, minlength=self.lists)
        starts = np.zeros(self.lists, np.int64)
        starts[1:] = np.cumsum(batch_counts)[:-1]
        pos = self.list_lens[sa] + (np.arange(len(sr)) - starts[sa])
        self.postings[sa, pos] = sr
        self.list_lens = self.list_lens + batch_counts
        dev = self.device
        self.postings_flat[torch.as_tensor(self._blk_start[sa] * cs + pos,
                                           device=dev)] = \
            torch.as_tensor(sr.astype(np.int32), device=dev)
        blk = torch.as_tensor(self._blk_start[sa] + pos // cs, device=dev)
        off_in = torch.as_tensor(pos % cs, device=dev)
        v = self.table.data[torch.as_tensor(sr, device=dev)]
        if self._is_bit:
            self.post_values[blk, off_in] = v
            return
        if self._normalized:
            vf = v.float()
            nrm = torch.sqrt(torch.sum(vf * vf, dim=-1, keepdim=True))
            v = (vf / torch.clamp(nrm, min=1e-30)).to(v.dtype)
        self.post_values[blk, off_in] = v
        vf = v.float()
        self.post_vsq[blk, off_in] = torch.sum(vf * vf, dim=-1)

    # ----------------------------------------------------------------- vacuum
    def vacuum(self) -> None:
        """ivfflatbulkdelete: drop dead ids; centers are never retrained
        (ivfvacuum.c:18-143)."""
        valid = self.table.valid.cpu().numpy()
        assignments = self.assignments.copy()
        dead = ~valid[: len(assignments)]
        assignments[: len(dead)][dead] = -1
        self._load_postings(assignments)

    # ------------------------------------------------------------ diagnostics
    def kmeans_metrics(self) -> dict:
        """IVFFLAT_KMEANS_DEBUG analogue (PrintKmeansMetrics,
        ivfbuild.c:558-601): ``inertia`` (Σ of each indexed tuple's opclass
        distance to its center) and ``davies_bouldin`` (None for one list)."""
        lists = self.lists
        assigns = self.assignments[: self.table.capacity]
        valid = self.table.valid.cpu().numpy()[: len(assigns)]
        rows = np.flatnonzero((assigns[: len(valid)] >= 0) & valid)
        cent = self.centroids

        def proc_scores(a, b):
            # spherical opclasses: acos(ip)/π (vector_spherical_distance,
            # src/vector.c:703-721); L2: the squared distance
            if self._spherical:
                ip = (a.cpu().double().numpy()
                      @ b.cpu().double().numpy().T)
                return np.arccos(np.clip(ip, -1.0, 1.0)) / np.pi
            return D.dense_scores(Metric.L2, a, b).cpu().numpy().astype(
                np.float64)

        inertia = 0.0
        sums = np.zeros(lists, np.float64)
        counts = np.zeros(lists, np.int64)
        for s in range(0, len(rows), 65536):
            rs = rows[s: s + 65536]
            vals, keep = self._index_values(rs)
            a = assigns[rs]
            d = proc_scores(vals, cent)[np.arange(len(rs)), a][keep]
            inertia += float(d.sum())
            sums += np.bincount(a[keep], weights=d, minlength=lists)
            counts += np.bincount(a[keep], minlength=lists)
        db = None
        if lists > 1:
            s_mean = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
            cd = proc_scores(cent, cent)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = (s_mean[:, None] + s_mean[None, :]) / cd
            np.fill_diagonal(ratio, -np.inf)
            db = float(np.nanmax(ratio, axis=1).mean())
        return {"inertia": inertia, "davies_bouldin": db}

    # ----------------------------------------------------------------- search
    def _form_queries(self, q) -> torch.Tensor:
        """(Q, D) f32 queries: normalized for cosine, unpacked 0/1 bits for
        bit."""
        if self._is_bit:
            from .flat import _coerce_bit_queries

            return D.unpack_bits(_coerce_bit_queries(q, self.table),
                                 self.table.dim)
        qs = _coerce_dense_queries(q, self.table.dim, self.device)
        if self._normalized:
            norms = torch.sqrt(torch.sum(qs * qs, dim=1, keepdim=True))
            qs = qs / torch.clamp(norms, min=1e-30)  # GetScanValue
        return qs

    def search(self, q, k: int, probes: Optional[int] = None,
               filter_mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k scan.  Returns (operator distances, row ids) as numpy
        arrays, −1/inf padded.  ``probes`` defaults to ``ivfflat.probes``;
        with ``ivfflat.iterative_scan = relaxed_order`` further probe
        batches run until k results pass the filter or
        ``ivfflat.max_probes`` is reached (ivfscan.c:268-277, 400-406)."""
        if self.postings is None:
            raise DataException("index has not been built")
        probes = int(config.validate("ivfflat.probes", probes)
                     if probes is not None else config.get("ivfflat.probes"))
        iterative = config.get("ivfflat.iterative_scan") != "off"
        max_probes = (max(int(config.get("ivfflat.max_probes")), probes)
                      if iterative else probes)
        probes = min(probes, self.lists)
        max_probes = min(max_probes, self.lists)

        qs = self._form_queries(q)
        nq = qs.shape[0]
        order = self._probe_order(qs, max_probes)  # (Q, max_probes)
        valid = self.table.valid
        fmask = (torch.as_tensor(np.asarray(filter_mask, dtype=bool),
                                 device=self.device)
                 if filter_mask is not None else None)
        # one host read a call: the any-dead bit holds while this runs
        any_dead = bool(torch.any(~valid[: self.table.count]))

        best_d = torch.full((nq, k), torch.inf, device=self.device)
        best_i = torch.full((nq, k), -1, dtype=torch.int32, device=self.device)
        off = 0
        while off < max_probes:
            batch = min(probes, max_probes - off)
            d, i = self._probe_batch(qs, order, off, batch, k, valid, fmask,
                                     any_dead)
            best_d, best_i = merge_topk(best_d, best_i, d, i, k)
            off += batch
            if not iterative:
                break
            if int(torch.min(torch.sum(torch.isfinite(best_d), dim=1))) >= k:
                break
        best_i = torch.where(torch.isinf(best_d), -1, best_i)
        d = stored_to_user(self.metric, best_d).cpu().numpy()
        r = best_i.cpu().numpy()
        # nsearches counts probe batches (one "Index Search" per re-probe)
        self.stats.count(nq, r, rounds=(off + probes - 1) // probes)
        return d, r

    def _probe_order(self, qs: torch.Tensor, max_probes: int) -> torch.Tensor:
        """GetScanLists (ivfscan.c:47-118): lists nearest-first, ties to the
        lower list id.  Spherical opclasses order by −ip (unit centers);
        bit by L2 on the unpacked bits."""
        metric = (Metric.IP if self._spherical
                  else Metric.L2 if self._is_bit else self.metric)
        scores = D.dense_scores(metric, qs, self.centroids)
        return topk_smallest(scores, max_probes)[1]

    def _probe_batch(self, qs, order, off, batch, k, valid, fmask,
                     any_dead: bool = True):
        """GetScanItems for one probe window (ivfscan.c:123-187), by the
        inverted scan at high coverage and by block gathers below it."""
        if (not self._is_bit
                and qs.shape[0] * batch * self.INVERT_COVERAGE >= self.lists):
            self.last_path = "inverted"
            return self._probe_batch_inverted(qs, order, off, batch, k,
                                              valid, fmask, any_dead)
        self.last_path = "blocks"
        return self._probe_batch_blocks(qs, order, off, batch, k, valid,
                                        fmask)

    def _probe_batch_inverted(self, qs, order, off, batch, k, valid, fmask,
                              any_dead: bool = True):
        """Each probed list's slab is read once per work item and scored
        against all of the item's queries; results map back per query."""
        nq = qs.shape[0]
        sel_np = order[:, off: off + batch].cpu().numpy()
        cs = self._post_cs
        Qc, Wb = _adaptive_item_shape(sel_np.reshape(-1), self._blk_occ, cs,
                                      self.WORK_QC, self.WORK_SLOTS)
        work = _build_work_items(sel_np, self._blk_start, self._blk_occ,
                                 Qc, Wb)
        if work is None:  # every probed list is empty
            return (torch.full((nq, k), torch.inf, device=self.device),
                    torch.full((nq, k), -1, dtype=torch.int32,
                               device=self.device))
        # slot-space validity: nothing dead and no filter → occupied slots
        if fmask is None and not any_dead:
            ok_post = self.postings_flat >= 0
        else:
            fm = fmask if fmask is not None else torch.ones(
                self.table.capacity, dtype=torch.bool, device=self.device)
            safe = torch.clamp(self.postings_flat, min=0).long()
            ok_post = (self.postings_flat >= 0) & valid[safe] & fm[safe]
        eq, blkbase, wlen, qmap = (torch.as_tensor(a, device=self.device)
                                   for a in work)
        d, vids = _workitem_probe_topk(
            self.metric, self.post_values, self.post_vsq,
            ok_post.view(-1, cs), qs, eq, blkbase, wlen, qmap, k=k, Qc=Qc,
            Wb=Wb, cs=cs)
        # compact slot → row id, one (Q, k) gather at the end
        rows = self.postings_flat[torch.clamp(vids, min=0).long()]
        return d, torch.where(vids >= 0, rows, -1)

    def _probe_batch_blocks(self, qs, order, off, batch, k, valid, fmask):
        """Gather whole (cs, D) value blocks of each query's probed lists,
        score, keep a running top-k."""
        t = self.table
        nq = qs.shape[0]
        sel = order[:, off: off + batch]  # (Q, batch) list ids
        cs = self._post_cs
        ncs = max(int(self._blk_occ.max()), 1)
        # list ids → compact block ids (−1 past a list's last block)
        j = torch.arange(ncs, device=self.device)
        selb = self._blk_start_dev[sel][:, :, None] + j
        selb = torch.where(j < self._blk_occ_dev[sel][:, :, None], selb,
                           -1).reshape(nq, batch * ncs)
        # blocks per chunk: a gathered chunk of ≤ 64 MB
        width = t.words if self._is_bit else t.dim
        bc = max(1, (1 << 26) // max(nq * cs * width * 4, 1))
        nb = selb.shape[1]
        n_chunks = max(1, -(-nb // bc))
        bc = -(-nb // n_chunks)
        if n_chunks * bc != nb:
            selb = torch.cat([selb, selb.new_full((nq, n_chunks * bc - nb),
                                                  -1)], dim=1)
        if fmask is None:
            fmask = torch.ones(t.capacity, dtype=torch.bool,
                               device=self.device)
        qrep = D.pack_bits(qs > 0.5) if self._is_bit else qs
        return _probe_topk(self.metric, self.post_values,
                           self.postings_flat.view(-1, cs), qrep, selb, valid,
                           fmask, k, n_chunks)


def _adaptive_item_shape(sel_flat, blk_occ, cs: int, qc_floor: int,
                         slots_floor: int):
    """(Qc, Wb) of the work items from the probed-edge statistics,
    quantized to powers of two: Qc tracks the mean probing-query count per
    list, Wb the mean blocks per probed list."""
    wb_floor = max(1, slots_floor // cs)
    probed = sel_flat[blk_occ[sel_flat] > 0]
    if len(probed) == 0:
        return qc_floor, wb_floor
    mean_q = len(probed) / max(len(np.unique(probed)), 1)
    qc = int(min(max(_next_pow2(int(mean_q * 1.25) + 1), qc_floor), 512))
    occ_mean = float(blk_occ[probed].mean())
    wb = int(min(max(_next_pow2(int(np.ceil(occ_mean / 2))), wb_floor), 8))
    return qc, wb


def _build_work_items(sel_np, blk_start, blk_occ, Qc: int, Wb: int):
    """Cut the (query → probed list) edges into fixed-shape work items on
    the host: (one list, ≤ Qc of its probing queries, one window of ≤ Wb
    consecutive blocks).  Returns ``(eq, blkbase, wlen, qmap)``:

    - ``eq``      (R, Qc) int32: query ids per item, −1 padded
    - ``blkbase`` (R,) int32: first compact block of the window
    - ``wlen``    (R,) int32: valid blocks in the window (a list's last
      window may be short; blocks past it belong to the next list)
    - ``qmap``    (Q, emax) int32: each query's flat ``row·Qc + slot``
      result positions, −1 padded

    with R padded to a power of two, or None when no probed list has any
    postings."""
    nq, batch = sel_np.shape
    occ = blk_occ
    win = (occ + Wb - 1) // Wb  # windows per list (0 for empty lists)
    qid = np.repeat(np.arange(nq, dtype=np.int64), batch)
    lid = sel_np.reshape(-1).astype(np.int64)
    keep = win[lid] > 0
    qid, lid = qid[keep], lid[keep]
    if len(lid) == 0:
        return None
    order = np.argsort(lid, kind="stable")
    qid_s, lid_s = qid[order], lid[order]
    ulist, inv, ucount = np.unique(lid_s, return_inverse=True,
                                   return_counts=True)
    nu = len(ulist)
    uwin = win[ulist]
    qch = (ucount + Qc - 1) // Qc
    rows_per = qch * uwin
    row0 = np.zeros(nu + 1, np.int64)
    row0[1:] = np.cumsum(rows_per)
    R = int(row0[-1])
    # rows are (query-chunk major, window minor) within a list
    uidx_of_row = np.repeat(np.arange(nu), rows_per)
    within = np.arange(R) - row0[uidx_of_row]
    wrow = within % uwin[uidx_of_row]
    Rp = _next_pow2(R)
    blkbase = np.full(Rp, -1, np.int32)
    blkbase[:R] = (blk_start[ulist[uidx_of_row]] + wrow * Wb).astype(np.int32)
    wlen = np.zeros(Rp, np.int32)
    wlen[:R] = np.minimum(Wb, occ[ulist[uidx_of_row]] - wrow * Wb)
    # edge at rank r within its list: query-chunk r // Qc, slot r % Qc,
    # repeated across the list's windows
    estart = np.zeros(nu, np.int64)
    estart[1:] = np.cumsum(ucount)[:-1]
    rank = np.arange(len(lid_s)) - estart[inv]
    rep = uwin[inv]
    tot = int(rep.sum())
    eidx = np.repeat(np.arange(len(lid_s)), rep)
    w_off = np.arange(tot) - np.repeat(np.cumsum(rep) - rep, rep)
    rows_e = (row0[inv[eidx]] + (rank[eidx] // Qc) * rep[eidx] + w_off)
    slot_e = rank[eidx] % Qc
    eq = np.full((Rp, Qc), -1, np.int32)
    eq[rows_e, slot_e] = qid_s[eidx]
    # qmap: every (edge × window) result position, grouped per query
    flat_pos = rows_e * Qc + slot_e
    qe = qid_s[eidx]
    o2 = np.argsort(qe, kind="stable")
    qe_s, fp_s = qe[o2], flat_pos[o2]
    cnt_q = np.bincount(qe_s, minlength=nq)
    emax = _next_pow2(max(int(cnt_q.max()), 1))
    qmap = np.full((nq, emax), -1, np.int32)
    st = np.zeros(nq, np.int64)
    st[1:] = np.cumsum(cnt_q)[:-1]
    qmap[qe_s, np.arange(len(qe_s)) - st[qe_s]] = fp_s.astype(np.int32)
    return eq, blkbase, wlen, qmap


def _workitem_scan(metric, post_blocks, post_bsq, ok_blocks, qs, eq, blkbase,
                   wlen, k: int, Qc: int, Wb: int, cs: int):
    """Score every work item and keep each (item, query slot)'s smallest
    kk = min(k, Wb·cs): (Rp·Qc, kk) distances and compact slots.  Steps of
    ``rc`` items: gather the items' Wb blocks, gather their ≤ Qc query
    rows, one batched product, mask, select."""
    Rp = eq.shape[0]
    NB, _, w = post_blocks.shape
    C = Wb * cs
    kk = min(k, C)
    # items a step: the (rc, C, w) f32 value block stays under 128 MB
    rc = 128
    while rc > 8 and rc * C * w * 4 > (1 << 27):
        rc //= 2
    rc = min(Rp, rc)
    dev = qs.device
    qf = qs.float()
    qsq = torch.sum(qf * qf, dim=1) if metric is Metric.L2 else None
    woff = torch.arange(Wb, dtype=torch.int32, device=dev)
    col = torch.arange(C, dtype=torch.int32, device=dev)
    out_d = torch.empty((Rp, Qc, kk), dtype=torch.float32, device=dev)
    out_v = torch.empty((Rp, Qc, kk), dtype=torch.int32, device=dev)
    D.dot_precision()
    for base in range(0, Rp, rc):
        eqc = eq[base: base + rc]
        bbc = blkbase[base: base + rc]
        wlc = wlen[base: base + rc]
        bids = torch.clamp(torch.clamp(bbc, min=0)[:, None] + woff,
                           max=NB - 1).long()  # (rc, Wb)
        vals = post_blocks[bids].reshape(rc, C, w).float()
        # mask dead slots, padding items, and blocks past a short window
        # (they belong to the next list)
        okc = (ok_blocks[bids].reshape(rc, C) & (bbc >= 0)[:, None]
               & (col[None, :] < wlc[:, None] * cs))
        qi = torch.clamp(eqc, min=0).long()
        ip = torch.bmm(qf[qi], vals.transpose(1, 2))  # (rc, Qc, C)
        if metric is Metric.L2:
            bsq = post_bsq[bids].reshape(rc, C)
            s = torch.clamp(qsq[qi][:, :, None] - 2.0 * ip + bsq[:, None, :],
                            min=0.0)
        else:  # IP / normalized cosine order by −ip
            s = -ip
        s = torch.where(okc[:, None, :], s, _IVF_BIG)
        d_sel, p = topk_smallest(s.reshape(rc * Qc, C), kk)
        d_sel = torch.where(d_sel >= _IVF_BIG, torch.inf, d_sel)
        # compact slot = window's first slot + position in the window
        vslot = (bbc.repeat_interleave(Qc)[:, None] * cs + p).to(torch.int32)
        out_d[base: base + rc] = d_sel.view(rc, Qc, kk)
        out_v[base: base + rc] = vslot.view(rc, Qc, kk)
    return out_d.view(Rp * Qc, kk), out_v.view(Rp * Qc, kk)


def _regroup_topk(flat_d, flat_v, qmap, k: int):
    """Per query: gather its items' kk-wide results through ``qmap`` and
    merge them into the smallest k (ties to the lower position of the
    emax·kk concatenation); −1 where the distance is +inf."""
    nq, emax = qmap.shape
    kk = flat_d.shape[1]
    qm = torch.clamp(qmap, min=0).long()
    dm = torch.where((qmap >= 0)[:, :, None], flat_d[qm], torch.inf)
    dmf = dm.reshape(nq, emax * kk)
    vmf = flat_v[qm].reshape(nq, emax * kk)
    if emax * kk < k:
        pad = k - emax * kk
        dmf = torch.cat([dmf, dmf.new_full((nq, pad), torch.inf)], dim=1)
        vmf = torch.cat([vmf, vmf.new_full((nq, pad), -1)], dim=1)
    d_out, v_out = topk_smallest(dmf, k, ids=vmf)
    return d_out, torch.where(torch.isinf(d_out), -1, v_out)


def _workitem_probe_topk(metric, post_blocks, post_bsq, ok_blocks, qs, eq,
                         blkbase, wlen, qmap, k: int, Qc: int, Wb: int,
                         cs: int):
    """The inverted probe scan: per-query smallest k (stored distances,
    compact slots; −1 where none)."""
    flat_d, flat_v = _workitem_scan(metric, post_blocks, post_bsq, ok_blocks,
                                    qs, eq, blkbase, wlen, k, Qc, Wb, cs)
    return _regroup_topk(flat_d, flat_v, qmap, k)


def _probe_topk(metric, post_values, post_blocks, qs, selb, valid, fmask,
                k: int, n_chunks: int):
    """(Q, NB) compact block ids → smallest-k (stored distances, row ids):
    each step gathers (Q, Bc) whole blocks, scores them and merges them
    into a running top-k.  Hamming (``qs`` packed words) scores the
    blocks' slots in K5."""
    nq, nb = selb.shape
    bc = nb // n_chunks
    cs = post_blocks.shape[1]
    qf = qs.float()
    qsq = torch.sum(qf * qf, dim=-1)[:, None]
    slot = torch.arange(cs, dtype=torch.int32, device=qs.device)
    best_d = torch.full((nq, k), torch.inf, device=qs.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=qs.device)
    D.dot_precision()
    for c in range(n_chunks):
        blk_c = selb[:, c * bc: (c + 1) * bc]
        safeb = torch.clamp(blk_c, min=0).long()
        ids = torch.where(blk_c[:, :, None] >= 0, post_blocks[safeb],
                          -1).reshape(nq, -1)
        safe = torch.clamp(ids, min=0).long()
        ok = (ids >= 0) & valid[safe] & fmask[safe]
        if metric is Metric.HAMMING:  # the blocks' slots through K5
            slots = torch.where(blk_c[:, :, None] >= 0,
                                blk_c[:, :, None] * cs + slot, -1)
            s = bit_point_scores(metric, qs, post_values.view(
                -1, post_values.shape[2]), slots.reshape(nq, -1))
        else:
            v = post_values[safeb].reshape(nq, ids.shape[1], -1).float()
            ip = torch.bmm(v, qf[:, :, None])[:, :, 0]  # (Q, C)
            if metric is Metric.L2:
                vsq = torch.sum(v * v, dim=-1)
                s = torch.clamp(qsq - 2.0 * ip + vsq, min=0.0)
            else:  # IP / normalized cosine order by −ip
                s = -ip
        s = torch.where(ok, s, torch.inf)
        d, i = merge_topk(best_d, best_i, s, ids, k)
        best_d, best_i = d, torch.where(torch.isinf(d), -1, i)
    return best_d, best_i


def _next_pow2(n: int) -> int:
    p = 1
    while p < max(n, 1):
        p *= 2
    return p
