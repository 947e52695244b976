"""Sharded search primitives and index wrappers — counterpart of
``pgvector_tpu.parallel.sharded``.

The vector store shards by row range over the mesh's ``axis``; the query
batch is replicated; each shard computes a partial top-k over its rows
with *global* row ids on its own device; the per-shard candidates are
gathered in shard order and reduced to the final top-k
(:func:`.mesh.all_gather`, then :func:`..ops.topk.merge_topk`).  One
process drives every device in turn, where the reference's ``shard_map``
runs them as one SPMD program.

The index wrappers mirror the reference's production deployment
(pgvector sharded via Citus, README.md:758-760): every shard holds an
independent index over its row range, and a query fans out to all shards
and merges their ``ORDER BY`` streams.  Each shard's index is an object
of its own on its shard's device; the reference stacks them into padded
(S, ...) arrays for its SPMD layout, which the port leaves out.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..errors import DataException, FeatureNotSupported, InternalError
from ..ops import distance as D
from ..ops.metric import Metric, stored_to_user
from ..ops.topk import merge_topk, topk_smallest
from .mesh import Mesh, all_gather, psum, shard_rows, to_device

#: transient budget for the device-sharded IVF candidate re-score — bounds
#: the per-chunk (Q, cc, D) f32 gather each shard materializes
SEARCH_CHUNK_BYTES = 2**29

#: rows of one L1 partial block of the dim-sharded scan: bounds its
#: (Q, rows, D/S) broadcast
_L1_BLOCK_BYTES = 2**28

_DENSE = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)

#: query rows of one probe-order product of the device-sharded IVF scan:
#: every product takes this shape (padded), so a query's centroid scores,
#: and with them its probes, do not depend on the rows beside it — a
#: fan-out's slice of the batch answers as the whole batch does
_PROBE_ROWS = 256


def _rows_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in blocks of _PROBE_ROWS rows of ``a`` (the last block
    zero-padded)."""
    out = []
    for s in range(0, a.shape[0], _PROBE_ROWS):
        blk = a[s: s + _PROBE_ROWS]
        n = blk.shape[0]
        if n < _PROBE_ROWS:
            blk = torch.cat([blk, blk.new_zeros((_PROBE_ROWS - n,
                                                 blk.shape[1]))])
        out.append((blk @ b.T)[:n])
    return torch.cat(out) if out else a.new_zeros((0, b.shape[0]))


def _f32(x, device) -> torch.Tensor:
    """``x`` (numpy or a tensor) as an f32 tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _empty_topk(nq: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((nq, k), torch.inf, device=device),
            torch.full((nq, k), -1, dtype=torch.int32, device=device))


def _merge_shards(parts, k: int, device):
    """Fold the shards' (d, global id) candidates into the k best, in
    shard order on ``device``: ties keep the lower shard, then the lower
    position (the reference's top_k over the all_gathered (Q, S·k)
    block).  Also pads k past the candidates' width with +inf / -1."""
    parts = list(parts)
    nq = parts[0][0].shape[0] if parts else 0
    d, i = _empty_topk(nq, k, device)
    if parts:
        cd = all_gather([p[0] for p in parts], device, dim=1)
        ci = all_gather([p[1].to(torch.int32) for p in parts], device, dim=1)
        # the running best is empty, so merging the block into it is the
        # reference's one top_k over the gathered candidates
        d, i = merge_topk(cd, ci, d, i, k)
    return d, torch.where(torch.isinf(d), -1, i)


# ---------------------------------------------------------------------------
# sharded exact search — per-shard partial top-k + merge
# ---------------------------------------------------------------------------


def sharded_exact_search(mesh: Mesh, metric: Metric, db, qs, k: int,
                         valid=None, axis: str = "shard"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded database: stored distances (L2
    squared) and int32 global ids, (Q, k), on the mesh's first device.

    Shard s takes its contiguous range of rows (:func:`.mesh.shard_rows`)
    onto its device and runs the port's exact engine over them (:func:`..index.flat.dense_exact`:
    K1 inside its gate, L2 and inner product over f32 rows), keeping
    ``min(k, rows)`` with global ids; the (S·k) candidates merge in shard
    order.  This is pgvector's parallel seq scan + Gather (SURVEY.md
    §2.4.4) over the mesh."""
    from ..index.flat import dense_exact

    if metric not in _DENSE:
        raise ValueError(f"metric {metric} is not a dense metric")
    devs = mesh.axis_devices(axis)
    home = devs[0]
    if not torch.is_tensor(db):
        db = torch.as_tensor(np.asarray(db, dtype=np.float32))
    n = db.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=db.device)
    else:
        valid = torch.as_tensor(valid, device=db.device)[:n].to(torch.bool)
    qs = _f32(qs, home)
    if qs.ndim == 1:
        qs = qs[None, :]
    parts = []
    for dev, (lo, hi) in zip(devs, shard_rows(n, len(devs))):
        if hi <= lo:
            continue  # a padded shard holds no real row
        d, i, _ = dense_exact(metric, to_device(qs, dev),
                              to_device(db[lo:hi], dev), hi - lo,
                              min(k, hi - lo), to_device(valid[lo:hi], dev),
                              tile=8192)
        parts.append((d, torch.where(i >= 0, i + lo, -1)))
    return _merge_shards(parts, k, home)


def dim_sharded_exact_search(mesh: Mesh, metric: Metric, db, qs, k: int,
                             valid=None, axis: str = "shard"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the *feature* dimension sharded over the mesh: each
    device holds a D/S-column slice (±1) of every row and query, computes its
    partial inner products and squared-norm pieces (one product over its
    slice; L1 a partial elementwise sum), and one :func:`.mesh.psum`
    assembles the exact scores on the first device.  Every dense metric
    decomposes exactly over dim slices; packed bit metrics do not.

    Complements :func:`sharded_exact_search`: shard rows when N is large,
    dims when D is.  The (Q, N) score block materializes, so this path
    expects the modest row counts of huge-dim tables.  Returns stored
    distances and int32 ids, (Q, k)."""
    if metric not in _DENSE:
        raise FeatureNotSupported(
            f"dim_sharded_exact_search does not support {metric}: packed "
            "bit metrics do not decompose over feature slices")
    devs = mesh.axis_devices(axis)
    home = devs[0]
    if not torch.is_tensor(db):
        db = torch.as_tensor(np.asarray(db, dtype=np.float32))
    if not torch.is_tensor(qs):
        qs = torch.as_tensor(np.asarray(qs, dtype=np.float32))
    n, dim = db.shape
    ip_p, qsq_p, dsq_p = [], [], []
    for dev, (lo, hi) in zip(devs, shard_rows(dim, len(devs))):
        if hi <= lo:
            continue  # zero columns add 0 to every partial
        db_s = _f32(db[:, lo:hi], dev)
        qs_s = _f32(qs[:, lo:hi], dev)
        if metric is Metric.L1:
            rows = max(1, _L1_BLOCK_BYTES // max(1, 4 * qs_s.shape[0]
                                                 * (hi - lo)))
            ip_p.append(torch.cat([
                torch.sum(torch.abs(qs_s[:, None, :] - db_s[None, r:r + rows]),
                          dim=-1) for r in range(0, max(n, 1), rows)], dim=1)
                [:, :n])
            continue
        D.dot_precision()
        ip_p.append(qs_s @ db_s.T)
        qsq_p.append(torch.sum(qs_s * qs_s, dim=1))
        dsq_p.append(torch.sum(db_s * db_s, dim=1))
    part = psum(ip_p, home)
    del ip_p  # the partial blocks: (Q, N) f32 each
    if metric is Metric.L1:
        s = part
    elif metric is Metric.IP:
        s = -part
    elif metric is Metric.L2:
        s = torch.clamp(psum(qsq_p, home)[:, None] - 2.0 * part
                        + psum(dsq_p, home)[None, :], min=0.0)
    else:
        denom = (torch.sqrt(psum(qsq_p, home))[:, None]
                 * torch.sqrt(psum(dsq_p, home))[None, :])
        s = torch.where(denom > 0,
                        1.0 - part / torch.where(denom > 0, denom, 1.0),
                        torch.inf)
    del part
    if valid is not None:
        ok = torch.as_tensor(valid, device=home)[:n].to(torch.bool)
        s = torch.where(ok[None, :], s, torch.inf)
    nq = s.shape[0]
    d, i = topk_smallest(s, min(k, n))
    del s
    if d.shape[1] < k:
        d = torch.cat([d, d.new_full((nq, k - d.shape[1]), torch.inf)], dim=1)
        i = torch.cat([i, i.new_full((nq, k - i.shape[1]), -1)], dim=1)
    return d, torch.where(torch.isinf(d), -1, i).to(torch.int32)


# ---------------------------------------------------------------------------
# sharded k-means step — data parallel over samples, psum of center sums
# ---------------------------------------------------------------------------


def sharded_kmeans_step(mesh: Mesh, data, centers, axis: str = "shard",
                        spherical: bool = False, binary: bool = False,
                        key: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """One Lloyd's iteration over a sample-sharded dataset: on each shard
    the assignment product and per-center partial sums, reduced with
    :func:`.mesh.psum` — the data-parallel analogue of the reference's
    parallel build workers feeding one shared state (SURVEY.md §2.4.2-3).
    ``spherical`` / ``binary`` apply the per-round center normalization
    hooks (NormCenters ivfkmeans.c:96-105; the bit threshold
    ivfutils.c:282-423).

    ``key`` (a ``torch.Generator`` on the mesh's first device) enables the
    empty-cluster reseed (ivfkmeans.c:222-227, as the single-device
    ``_new_centers``): k global sample rows are drawn once, the shard that
    owns each contributes it, and a psum replicates them.  Without a key,
    empty clusters keep their previous center."""
    return _kmeans_round(mesh, data, centers, axis, spherical, binary,
                         key)[0]


def _kmeans_round(mesh: Mesh, data, centers, axis: str, spherical: bool,
                  binary: bool, key: Optional[torch.Generator],
                  prev: Optional[list] = None):
    """:func:`sharded_kmeans_step`, also returning each shard's assignment
    and how many samples changed list since ``prev`` (every sample when
    ``prev`` is None)."""
    from ..ops.distance import highest_precision

    devs = mesh.axis_devices(axis)
    home = devs[0]
    centers = _f32(centers, home)
    if not torch.is_tensor(data):
        data = torch.as_tensor(np.asarray(data, dtype=np.float32))
    s, k = data.shape[0], centers.shape[0]
    blocks = shard_rows(s, len(devs))
    sums, counts, assigns, changed = [], [], [], []
    for j, (dev, (lo, hi)) in enumerate(zip(devs, blocks)):
        data_s = _f32(data[lo:hi], dev)
        c = to_device(centers, dev)
        with highest_precision():
            ip = data_s @ c.T
        if spherical:
            assign = torch.argmax(ip, dim=1)
        else:
            c_sq = torch.sum(c * c, dim=1)
            assign = torch.argmin(c_sq[None, :] - 2.0 * ip, dim=1)
        assigns.append(assign)
        changed.append(torch.sum(assign != prev[j]) if prev is not None
                       else torch.tensor(hi - lo, device=dev))
        sums.append(torch.zeros((k, data.shape[1]), device=dev)
                    .index_add_(0, assign, data_s))
        counts.append(torch.zeros(k, device=dev).index_add_(
            0, assign, torch.ones(hi - lo, device=dev)))
    sums, counts = psum(sums, home), psum(counts, home)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    empty = (counts == 0)[:, None]
    if key is not None:
        # the reseed comes BEFORE the normalize / threshold hooks, as in
        # _new_centers: the owning shard contributes each sampled row
        rand_rows = torch.randint(0, s, (k,), generator=key,
                                  device=key.device).to(home)
        contrib = []
        for dev, (lo, hi) in zip(devs, blocks):
            local = to_device(rand_rows, dev) - lo
            owned = (local >= 0) & (local < hi - lo)
            rows = _f32(data[lo:hi], dev)[torch.clamp(local, 0,
                                                      max(hi - lo - 1, 0))]
            contrib.append(torch.where(owned[:, None], rows, 0.0))
        new = torch.where(empty, psum(contrib, home), new)
    else:
        new = torch.where(empty, centers, new)
    if spherical:
        norms = torch.sqrt(torch.sum(new * new, dim=1, keepdim=True))
        new = new / torch.clamp(norms, min=1e-30)
    if binary:
        new = (new > 0.5).float()
    return new, assigns, psum(changed, home)


def _train_centers_sharded(mesh: Mesh, data, k: int, *, axis: str = "shard",
                           spherical: bool = False, binary: bool = False,
                           seed: int = 0, max_iters: int = 500):
    """:func:`train_centers_sharded` with its Lloyd's rounds: (centers,
    rounds)."""
    from ..index.ivf_kmeans import _kmeanspp_init, make_generator, train_centers

    home = mesh.axis_devices(axis)[0]
    data = _f32(data, home)
    if data.shape[0] < k:
        # tiny tables do not need the mesh: the single-device tiling path,
        # so both entry points agree
        return train_centers(data, k, spherical=spherical, binary=binary,
                             seed=seed)
    g = make_generator(seed, home)
    centers = _kmeanspp_init(data, g, k, spherical)
    if binary:
        centers = (centers > 0.5).float()
    rounds, assigns = 0, None
    for _ in range(max_iters):
        centers, assigns, changed = _kmeans_round(
            mesh, data, centers, axis, spherical, binary, g, assigns)
        rounds += 1
        # no sample changed list: the centers are the means of the final
        # assignment (the reference stops when they stop moving, the same
        # fixpoint; on the card the atomic partial sums may still move
        # them in the last bit)
        if int(changed) == 0:
            break
    # post-checks (ivfkmeans.c:490-547), as train_centers
    host = centers.cpu()
    if not torch.isfinite(host).all():
        raise InternalError(
            "k-means produced non-finite centers. Please report a bug.")
    if spherical and (torch.linalg.norm(host, dim=1) == 0).any():
        raise InternalError(
            "k-means produced a zero-norm center for a spherical metric."
            " Please report a bug.")
    return centers, rounds


def train_centers_sharded(mesh: Mesh, data, k: int, *, axis: str = "shard",
                          spherical: bool = False, binary: bool = False,
                          seed: int = 0, max_iters: int = 500) -> torch.Tensor:
    """IVF center training with sample-sharded Lloyd's rounds — the
    device-parallel analogue of the reference's parallel k-means phase
    (ivfbuild.c:829-966).  k-means++ seeding is sequential and runs on the
    mesh's first device; each round is one :func:`sharded_kmeans_step`
    with the reseed drawn from a generator seeded by ``seed``.  Stops when
    no sample changes list (the fixpoint where the reference's centers
    stop moving); the single-device post-checks apply.  The
    reference draws from ``jax.random``, so the two packages train
    different centers from one seed."""
    return _train_centers_sharded(mesh, data, k, axis=axis,
                                  spherical=spherical, binary=binary,
                                  seed=seed, max_iters=max_iters)[0]


# ---------------------------------------------------------------------------
# sharded index wrappers — one sub-index per shard, fan-out + merge
# ---------------------------------------------------------------------------


def _slice_table(table, lo: int, hi: int, device):
    """A table of the same kind holding rows [lo, hi) of ``table`` on
    ``device``, validity intact (deleted rows stay deleted)."""
    from ..store.table import BitTable, DenseTable, SparseTable

    n = hi - lo
    cap = max(n, 8)
    if isinstance(table, DenseTable):
        sub = DenseTable(table.dim, dtype=table.dtype, capacity=cap,
                         device=device)
        cols = ("data",)
    elif isinstance(table, BitTable):
        sub = BitTable(table.dim, capacity=cap, device=device)
        cols = ("data",)
    elif isinstance(table, SparseTable):
        sub = SparseTable(table.dim, nnz_cap=table.nnz_cap, capacity=cap,
                          device=device)
        cols = ("idx", "val")
        sub.version += 1
    else:
        raise TypeError(f"unsupported table type {type(table).__name__}")
    for c in cols:
        getattr(sub, c)[:n] = to_device(getattr(table, c)[lo:hi], device)
    sub.valid[:n] = to_device(table.valid[lo:hi], device)
    sub.count = n
    return sub


def _append_rows(sub, table, rows: np.ndarray) -> np.ndarray:
    """Append rows ``rows`` of ``table`` to the shard table ``sub``; returns
    their local ids."""
    from ..store.table import BitTable, SparseTable

    r = torch.as_tensor(rows, dtype=torch.int64, device=table.device)
    if isinstance(table, BitTable):
        return sub.insert_words(table.data[r].to(sub.device))
    if isinstance(table, SparseTable):
        return sub.insert_arrays(table.idx[r].cpu(), table.val[r].cpu(),
                                 _checked=True)
    return sub.insert(table.data[r].float().cpu().numpy())


def _build_shards(table, devices, make_index):
    """Partition the table into contiguous row ranges (``shard_rows``), one
    per device of ``devices``, and build one sub-index per range, one
    after another.  The reference builds them in a thread pool; on one
    H100, four threads building four shards of the card gave the same
    graphs about four times slower (they share one stream and the
    interpreter lock).

    Returns (indexes, sub_tables, g_rows), ``g_rows[s]`` shard ``s``'s
    local row → global row."""
    devices = list(devices)
    subs, g_rows = [], []
    for dev, (lo, hi) in zip(devices, shard_rows(table.count, len(devices))):
        subs.append(_slice_table(table, lo, hi, dev))
        g_rows.append(np.arange(lo, hi, dtype=np.int32))
    return [make_index(s) for s in subs], subs, g_rows


class _ShardedWrapper:
    """Fan-out and merge: rows split into contiguous ranges, one
    single-device index a range; queries run against every shard and the
    per-shard (d, global id) streams merge."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.shards = []
        self.offsets = []

    def _merge(self, results, k: int):
        ds = np.concatenate([d for d, _ in results], axis=1)
        is_ = np.concatenate(
            [np.where(i >= 0, i + off, -1)
             for (_, i), off in zip(results, self.offsets)], axis=1)
        # stable: equal distances keep the lower shard
        order = np.argsort(ds, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(ds, order, axis=1),
                np.take_along_axis(is_, order, axis=1))


class ShardedFlatIndex(_ShardedWrapper):
    """Row-sharded exact search over a mesh: :func:`sharded_exact_search`
    over the table's live rows.  Returns operator distances."""

    def __init__(self, mesh: Mesh, table, metric: Metric, axis: str = "shard"):
        super().__init__(mesh.shape[axis])
        self.mesh = mesh
        self.axis = axis
        self.table = table
        self.metric = metric

    def search(self, qs, k: int):
        from ..index.flat import _coerce_dense_queries

        t = self.table
        qs = _coerce_dense_queries(qs, t.dim, self.mesh.axis_devices(
            self.axis)[0])
        d, i = sharded_exact_search(self.mesh, self.metric, t.data[: t.count],
                                    qs, k, valid=t.valid[: t.count],
                                    axis=self.axis)
        if self.metric is Metric.L2:
            d = torch.where(torch.isinf(d), d,
                            torch.sqrt(torch.clamp(d, min=0.0)))
        return d.cpu().numpy(), i.cpu().numpy()


class ShardedIVFFlatIndex(_ShardedWrapper):
    """One IVFFlat sub-index per row shard, on the table's device (the
    Citus-sharded deployment, README.md:758-760).  Centers are trained per
    shard; queries fan out with the same probes and merge."""

    def __init__(self, table, metric: Metric, n_shards: int, lists: int = 100,
                 seed: int = 0):
        super().__init__(n_shards)
        from ..index.ivfflat import IVFFlatIndex

        self.metric = metric
        self.shards, self.subs, g_rows = _build_shards(
            table, [table.device] * n_shards,
            lambda sub: IVFFlatIndex(sub, metric, lists=lists, seed=seed))
        self.offsets = [int(g[0]) if len(g) else 0 for g in g_rows]

    def search(self, qs, k: int, probes: Optional[int] = None):
        results = [s.search(qs, k, probes=probes) for s in self.shards]
        return self._merge(results, k)


class ShardedHNSWIndex(_ShardedWrapper):
    """One HNSW graph per row shard, on the table's device; fan-out and
    merge (SURVEY.md §7 M5).  Each shard's search is its index's own:
    K2 over its packed slab on the card."""

    def __init__(self, table, metric: Metric, n_shards: int, m: int = 16,
                 ef_construction: int = 64, seed: int = 0, **kw):
        super().__init__(n_shards)
        from ..index.hnsw import HNSWIndex

        self.metric = metric
        self.shards, self.subs, g_rows = _build_shards(
            table, [table.device] * n_shards,
            lambda sub: HNSWIndex(sub, metric, m=m,
                                  ef_construction=ef_construction,
                                  seed=seed, **kw))
        self.offsets = [int(g[0]) if len(g) else 0 for g in g_rows]

    def search(self, qs, k: int, ef_search: Optional[int] = None):
        results = [s.search(qs, k, ef_search=ef_search) for s in self.shards]
        return self._merge(results, k)


# ---------------------------------------------------------------------------
# device-placed sharded indexes — each shard's index on its own device, one
# search launched shard by shard, the candidates merged in shard order
# ---------------------------------------------------------------------------


def _sharded_manifest(path: str, kind: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    if man.get("object") != kind:
        raise DataException(f"expected a {kind} checkpoint")
    return man


class _DeviceSharded:
    """What the device-placed indexes share: the mesh's shard and replica
    devices, least-loaded insert routing, delete propagation, checkpoints
    shard by shard, and the fan-out of a query batch over replica columns.
    Subclasses give ``_place`` (one shard's search state on a device),
    ``_search_shard`` and the checkpoint functions."""

    _object = ""

    def __init__(self, mesh: Mesh, table, metric: Metric, axis: str,
                 qaxis: Optional[str]):
        self.mesh = mesh
        self.axis = axis
        if qaxis is not None and qaxis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {qaxis!r}")
        self.qaxis = qaxis
        self.metric = metric
        self.table = table
        #: the mesh's first device: results land here
        self.device = mesh.devices.flat[0]

    def _grid(self) -> np.ndarray:
        """(shards, replicas) devices: shard s of replica column r."""
        names = list(self.mesh.axis_names)
        devs = np.moveaxis(self.mesh.devices, names.index(self.axis), 0)
        if self.qaxis is None:
            return devs.reshape(devs.shape[0], -1)[:, :1]
        qi = [a for a in names if a != self.axis].index(self.qaxis) + 1
        devs = np.moveaxis(devs, qi, 1)
        return devs.reshape(devs.shape[0], devs.shape[1], -1)[:, :, 0]

    def _shard_devices(self) -> List[torch.device]:
        return list(self._grid()[:, 0])

    def _restack(self) -> None:
        """(Re)place each shard's search state on every device of its row
        of the grid (a no-op copy where a replica shares the device)."""
        grid = self._grid()
        self._placed = [[self._place(j, dev) for dev in grid[j]]
                        for j in range(len(self.shards))]

    # ------------------------------------------------------------- mutations
    def insert(self, rows) -> None:
        """aminsert, sharded: each new global row goes to the least-loaded
        shard, round-robin from it for a balanced batch (insert-time
        balancing; the reference's analogue is Citus routing rows by
        distribution key)."""
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        loads = np.array([sub.count for sub in self.subs])
        order = np.argsort(loads, kind="stable")
        pick = order[np.arange(len(rows)) % len(self.subs)]
        for s in range(len(self.subs)):
            sel = pick == s
            if not sel.any():
                continue
            local = _append_rows(self.subs[s], self.table, rows[sel])
            self.shards[s].insert(local)
            self.g_rows[s] = np.concatenate(
                [self.g_rows[s], rows[sel].astype(np.int32)])
        self._restack()

    def vacuum(self) -> None:
        """Propagate global deletes to every shard, then run each shard's
        vacuum."""
        valid = self.table.valid.cpu().numpy()
        for s, sub, g in zip(self.shards, self.subs, self.g_rows):
            sub_valid = sub.valid[: sub.count].cpu().numpy()
            dead = np.flatnonzero(sub_valid & ~valid[g])
            if len(dead):
                sub.delete(dead)
            s.vacuum()
        self._restack()

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str) -> None:
        """One table and one index checkpoint a shard, each shard's local →
        global rows, and a manifest (the reference's layout, either
        package reads it)."""
        from ..io import checkpoint as ckpt

        os.makedirs(path, exist_ok=True)
        for j, (s, sub, g) in enumerate(
                zip(self.shards, self.subs, self.g_rows)):
            ckpt.save_table(sub, os.path.join(path, f"shard{j}_table"))
            self._save_index(s, os.path.join(path, f"shard{j}_index"))
            np.save(os.path.join(path, f"shard{j}_grows.npy"), g)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"magic": ckpt.MAGIC, "version": ckpt.FORMAT_VERSION,
                       "object": self._object, "n_shards": len(self.shards),
                       "metric": self.metric.name, **self._params()}, f)

    def _load_shards(self, path: str, n_shards: int) -> None:
        from ..io import checkpoint as ckpt

        devs = self._shard_devices()
        if n_shards != len(devs):
            raise DataException(
                f"checkpoint holds {n_shards} shards, the mesh's {self.axis}"
                f" axis {len(devs)}")
        self.shards, self.subs, self.g_rows = [], [], []
        for j in range(n_shards):
            sub = ckpt.load_table(os.path.join(path, f"shard{j}_table"),
                                  device=devs[j])
            self.subs.append(sub)
            self.shards.append(self._load_index(
                sub, os.path.join(path, f"shard{j}_index")))
            self.g_rows.append(np.load(
                os.path.join(path, f"shard{j}_grows.npy")).astype(np.int32))
        self._restack()

    # ---------------------------------------------------------------- search
    def _fan_out(self, qs: torch.Tensor, k: int, **kw):
        """Each replica column answers its slice of the batch; within a
        column every shard searches the slice on its device and the
        candidates merge in shard order.  Per-query work does not depend
        on the slice, so a fan-out equals the 1-D search."""
        grid = self._grid()
        n_rep = grid.shape[1]
        out_d, out_i = [], []
        for r, (lo, hi) in enumerate(shard_rows(qs.shape[0], n_rep)):
            if hi <= lo:
                continue
            col_home = grid[0, r]
            parts = []
            for j in range(len(self.shards)):
                dev = grid[j, r]
                res = self._search_shard(self._placed[j][r],
                                         to_device(qs[lo:hi], dev), k, **kw)
                if res is not None:
                    parts.append(res)
            if parts:
                d, i = _merge_shards(parts, k, col_home)
            else:
                d, i = _empty_topk(hi - lo, k, col_home)
            out_d.append(d)
            out_i.append(i)
        d = all_gather(out_d, self.device)
        i = all_gather(out_i, self.device)
        return stored_to_user(self.metric, d), i


class DeviceShardedHNSWIndex(_DeviceSharded):
    """Row-range-sharded HNSW with device-resident shards.

    Each shard's graph (values, nbr0, nbr_up, up_slot, element rows as
    global rows) lives on its shard's device; ``search`` runs Algorithm 5
    shard by shard (:func:`..index.hnsw_kernels.query_search` over row
    gathers, with the ``hash2`` visited set of the reference's
    ``query_search`` default) against the replicated query batch and
    merges the per-shard top-k in shard order.  Row validity is the global
    table's, so a delete is invisible to searches at once.

    The per-shard indexes are kept, so the lifecycle works sharded:
    ``insert`` routes new rows to the least-loaded shard, ``vacuum``
    propagates deletes and repairs every shard's graph, and ``save`` /
    ``load`` checkpoint shard by shard in the reference's ``sharded_hnsw``
    layout.  On a 2-D mesh (:func:`.mesh.make_mesh2`) ``qaxis`` also
    splits the query batch: the graph replicates over ``qaxis`` and each
    replica column answers its slice."""

    _object = "sharded_hnsw"

    def __init__(self, mesh: Mesh, table, metric: Metric, axis: str = "shard",
                 m: int = 16, ef_construction: int = 64, seed: int = 0,
                 qaxis: Optional[str] = None, _defer_build: bool = False,
                 **kw):
        from ..index.hnsw import HEAPTIDS, HNSWIndex

        super().__init__(mesh, table, metric, axis, qaxis)
        self.m = m
        self.ef_construction = ef_construction
        self.seed = seed
        self.heaptids = HEAPTIDS
        if _defer_build:  # load() fills the shards
            return
        self.shards, self.subs, self.g_rows = _build_shards(
            table, self._shard_devices(),
            lambda sub: HNSWIndex(sub, metric, m=m,
                                  ef_construction=ef_construction, seed=seed,
                                  **kw))
        self._restack()

    def _params(self) -> dict:
        return {"m": self.m, "ef_construction": self.ef_construction,
                "seed": self.seed}

    def _place(self, j: int, dev: torch.device) -> dict:
        s, g = self.shards[j], self.g_rows[j]
        s._sync_device_meta()
        er = s.elem_rows.astype(np.int64)
        g_pad = np.concatenate([g.astype(np.int64), [-1]])
        glob = np.where(er >= 0, g_pad[np.minimum(er, len(g) - 1)], -1)
        return {"kind": s.kind, "sdim": s._scorer_sdim(),
                "values": to_device(s.values, dev),
                "nbr0": to_device(s.nbr0, dev),
                "nbr_up": to_device(s.nbr_up, dev),
                "up_slot": to_device(s._up_slot_dev, dev),
                "elem_rows": torch.as_tensor(glob.astype(np.int32),
                                             device=dev),
                "entry": s.entry, "entry_level": s.entry_level}

    def _search_shard(self, p: dict, qs, k: int, ef: int, expand: int):
        from ..index import hnsw_kernels as K

        if p["entry"] < 0:
            return None  # an empty graph has no candidate
        dev = p["nbr0"].device
        d, r, _ = K.query_search(
            p["kind"], self.metric, p["values"], p["nbr0"], p["nbr_up"],
            p["up_slot"], p["elem_rows"], to_device(self.table.valid, dev),
            None, qs, p["entry"], p["entry_level"], ef=ef, k=k,
            heaptids=self.heaptids, expand=expand, sdim=p["sdim"],
            vmode="hash2")
        return d, r

    def search(self, qs, k: int, ef_search: Optional[int] = None,
               expand: int = 1):
        """(operator distances, global row ids) as numpy, -1/inf padded."""
        from ..config import config
        from ..index.flat import _coerce_dense_queries

        ef = int(config.validate("hnsw.ef_search", ef_search)
                 if ef_search is not None else config.get("hnsw.ef_search"))
        qs = _coerce_dense_queries(qs, self.table.dim, self.device)
        if self.metric is Metric.COSINE:
            norms = torch.sqrt(torch.sum(qs * qs, dim=1, keepdim=True))
            qs = qs / torch.clamp(norms, min=1e-30)
        d, i = self._fan_out(qs, k, ef=ef, expand=expand)
        return d.cpu().numpy(), i.cpu().numpy()

    def _save_index(self, idx, path: str) -> None:
        from ..io import checkpoint as ckpt

        ckpt.save_hnsw(idx, path)

    @staticmethod
    def _load_index(sub, path: str):
        from ..io import checkpoint as ckpt

        return ckpt.load_hnsw(sub, path)

    @classmethod
    def load(cls, mesh: Mesh, table, path: str, axis: str = "shard",
             qaxis: Optional[str] = None):
        """A ``sharded_hnsw`` checkpoint (either package's) over ``table``,
        shard j on the mesh's j-th shard device."""
        man = _sharded_manifest(path, cls._object)
        self = cls(mesh, table, Metric[man["metric"]], axis=axis,
                   m=man["m"], ef_construction=man["ef_construction"],
                   seed=man["seed"], qaxis=qaxis, _defer_build=True)
        self._load_shards(path, int(man["n_shards"]))
        return self


class DeviceShardedIVFFlatIndex(_DeviceSharded):
    """Row-range-sharded IVFFlat with device-resident shards: per device
    the centroids, the (lists, cap) posting matrix, the shard table's rows
    and its local → global rows; a search per shard runs probe order →
    candidate gather → score → local top-k, and the shards' candidates
    merge in shard order.  Centers are trained per shard (the Citus
    pattern: every shard runs its own CREATE INDEX).  ``insert``,
    ``vacuum``, ``save`` / ``load`` (``sharded_ivfflat``) and ``qaxis`` as
    :class:`DeviceShardedHNSWIndex`."""

    _object = "sharded_ivfflat"

    def __init__(self, mesh: Mesh, table, metric: Metric, axis: str = "shard",
                 lists: int = 100, seed: int = 0, qaxis: Optional[str] = None,
                 _defer_build: bool = False, **kw):
        from ..index.ivfflat import IVFFlatIndex

        super().__init__(mesh, table, metric, axis, qaxis)
        self.lists = lists
        self.seed = seed
        self._normalized = metric is Metric.COSINE
        if _defer_build:
            return
        self.shards, self.subs, self.g_rows = _build_shards(
            table, self._shard_devices(),
            lambda sub: IVFFlatIndex(sub, metric, lists=lists, seed=seed,
                                     **kw))
        self._restack()

    def _params(self) -> dict:
        return {"lists": self.lists, "seed": self.seed}

    def _place(self, j: int, dev: torch.device) -> dict:
        s, sub = self.shards[j], self.subs[j]
        return {"centroids": to_device(s.centroids.float(), dev),
                "postings": torch.as_tensor(np.asarray(s.postings),
                                            dtype=torch.int64, device=dev),
                "data": to_device(sub.data, dev),
                "grows": torch.as_tensor(self.g_rows[j].astype(np.int64),
                                         device=dev)}

    def _search_shard(self, p: dict, qs, k: int, probes: int):
        """Probe order (GetScanLists) → the probed lists' candidates,
        re-scored in chunks under SEARCH_CHUNK_BYTES with a running top-k
        (also pads k past the candidates with inf / -1).  Each query's
        arithmetic is the same whatever the batch holds, so a fan-out
        equals the 1-D search bit for bit."""
        metric = self.metric
        cent, post, data, grows = (p["centroids"], p["postings"], p["data"],
                                   p["grows"])
        dev = cent.device
        row_valid = to_device(self.table.valid, dev)
        D.dot_precision()
        ip = _rows_mm(qs, cent)
        if metric in (Metric.IP, Metric.COSINE):
            cscore = -ip
        else:
            cscore = torch.sum(cent * cent, dim=1)[None, :] - 2.0 * ip
        _, order = topk_smallest(cscore, min(probes, cent.shape[0]))
        qn = qs.shape[0]
        cand_all = post[order].reshape(qn, -1)  # (Q, C) local rows
        c = cand_all.shape[1]
        dim = data.shape[1]
        cc = min(c, max(64, SEARCH_CHUNK_BYTES // max(1, qn * dim * 4)))
        d, i = _empty_topk(qn, k, dev)
        qsq = torch.sum(qs * qs, dim=-1)[:, None]
        for s0 in range(0, c, cc):
            cand = cand_all[:, s0:s0 + cc]
            gcand = torch.where(cand >= 0, grows[torch.clamp(cand, min=0)], -1)
            ok = (gcand >= 0) & row_valid[torch.clamp(gcand, min=0)]
            v = data[torch.clamp(cand, min=0)].float()
            if self._normalized:
                nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
                v = v / torch.clamp(nrm, min=1e-30)
            # an elementwise product and a sum over D: a row's score does
            # not depend on how many rows the batch holds
            vip = torch.sum(v * qs[:, None, :], dim=-1)
            if metric is Metric.L2:
                s = torch.clamp(qsq - 2.0 * vip + torch.sum(v * v, dim=-1),
                                min=0.0)
            else:
                s = -vip
            d, i = merge_topk(d, i, torch.where(ok, s, torch.inf),
                              gcand.to(torch.int32), k)
        return d, torch.where(torch.isinf(d), -1, i)

    def search(self, qs, k: int, probes: Optional[int] = None):
        """(operator distances, global row ids) as numpy, -1/inf padded."""
        from ..config import config
        from ..index.flat import _coerce_dense_queries

        probes = int(config.validate("ivfflat.probes", probes)
                     if probes is not None else config.get("ivfflat.probes"))
        probes = min(probes, self.lists)
        qs = _coerce_dense_queries(qs, self.table.dim, self.device)
        if self._normalized:
            norms = torch.sqrt(torch.sum(qs * qs, dim=1, keepdim=True))
            qs = qs / torch.clamp(norms, min=1e-30)
        d, i = self._fan_out(qs, k, probes=probes)
        return d.cpu().numpy(), i.cpu().numpy()

    def _save_index(self, idx, path: str) -> None:
        from ..io import checkpoint as ckpt

        ckpt.save_ivfflat(idx, path)

    @staticmethod
    def _load_index(sub, path: str):
        from ..io import checkpoint as ckpt

        return ckpt.load_ivfflat(sub, path)

    @classmethod
    def load(cls, mesh: Mesh, table, path: str, axis: str = "shard",
             qaxis: Optional[str] = None):
        """A ``sharded_ivfflat`` checkpoint (either package's) over
        ``table``."""
        man = _sharded_manifest(path, cls._object)
        self = cls(mesh, table, Metric[man["metric"]], axis=axis,
                   lists=man["lists"], seed=man["seed"], qaxis=qaxis,
                   _defer_build=True)
        self._load_shards(path, int(man["n_shards"]))
        return self
