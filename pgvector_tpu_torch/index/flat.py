"""Exact (brute-force) search — pgvector's no-index path and the ground
truth for every recall test; counterpart of ``pgvector_tpu.index.flat``.

Routes, named in ``last_path`` after each search:

- dense, by ``PGVECTOR_TPU_EXACT`` (``grouped``, the default; ``pallas``;
  ``xla``): L2 and inner product over an f32 table with at least 4096
  rows and k ≤ 64 go to K1 (:mod:`..ops.fused_topk`, "fused", the
  reference's gate ``flat.py:154-156``) unless the mode is ``xla``; under
  ``grouped`` the rest of L2, inner product and cosine over at least 4096
  rows (cosine, k > 64, bf16 and f16 tables) go to the grouped engine
  (:func:`..ops.topk.grouped_exact_topk`, "grouped"); everything else (L1,
  small tables, and every search under ``xla``) goes to the tiled scan
  (:func:`..ops.topk.tiled_topk`, "tiled").  The reference's retry and
  fallback around its Pallas compile stay out of the port.
- bit: Hamming and Jaccard with k ≤ 64 go to K4
  (:func:`..ops.bit_scan.bit_topk`, "bit-kernel"); k > 64 to the tiled
  scan over ``bit_scores`` ("tiled").
- sparse, the reference's three routes and thresholds
  (``flat.py:214-330``): L2/IP/cosine over ≥ 4096 rows whose dense copy
  fits ``PGVECTOR_TPU_SPARSE_DENSIFY_GB`` (8) go through a cached dense
  copy and the dense engine ("densified"); beyond it, tiles of at most
  ``PGVECTOR_TPU_SPARSE_TILE_BYTES`` (512 MB) are scattered dense on the
  device and scored by K1 for L2/IP, merged into the running best
  ("densified-tile"); L1, and dims too large for a 512-row tile, take the
  merge join in chunks of ``PGVECTOR_TPU_SPARSE_CHUNK`` (256) queries
  ("merge-join").
"""

from __future__ import annotations

import os
from typing import Tuple, Union

import numpy as np
import torch

from ..errors import DataException
from ..ops import distance as D
from ..ops import fused_topk
from ..ops.bit_scan import BIT_METRICS, bit_topk
from ..ops.metric import Metric
from ..ops.topk import grouped_exact_topk, merge_topk, tiled_topk
from ..store.table import BitTable, DenseTable, SparseTable
from ..types import Bit, HalfVec, SparseVec, Vector
from ..utils.stats import ScanStats

DENSE_METRICS = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)
SPARSE_METRICS = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)

#: the smallest table K1 scans (the reference's gate, flat.py:155)
FUSED_MIN_ROWS = 4096

#: the fewest rows a densified tile may hold before the merge join wins
#: again (flat.py:284-285)
MIN_TILE_ROWS = 512


def _exact_mode() -> str:
    """The dense exact engine, ``PGVECTOR_TPU_EXACT`` (flat.py:28-33):
    ``grouped`` (the default), ``pallas`` (K1 within its gate, else the
    tiled scan) or ``xla`` (the tiled scan)."""
    return os.environ.get("PGVECTOR_TPU_EXACT", "grouped")


def _grouped_group_size(n: int, nq: int) -> int:
    """Group width balancing the (Q, N/group) group-min matrix (≤ ~1.5 GB)
    against the refine's gather of k·group rows a query (flat.py:90)."""
    g = 16
    while g < 1024 and (n // g) * nq * 4 > 15 * 2**27:
        g *= 2
    return g


def _dense_row_scores(metric: Metric, qs: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """(Q, C) stored distances of per-query candidate rows ``v`` (Q, C, D)
    (flat.py:54): the formulation of :func:`..ops.distance.dense_scores`
    (L2 squared, cosine over raw norms, clamped), batched per query."""
    qf = qs.float()
    v = v.float()
    D.dot_precision()
    ip = torch.bmm(v, qf[:, :, None])[:, :, 0]
    if metric is Metric.IP:
        return -ip
    v_sq = torch.sum(v * v, dim=-1)
    if metric is Metric.L2:
        q_sq = torch.sum(qf * qf, dim=-1, keepdim=True)
        return torch.clamp(q_sq - 2.0 * ip + v_sq, min=0.0)
    q_n = torch.sqrt(torch.sum(qf * qf, dim=-1, keepdim=True))
    denom = q_n * torch.sqrt(v_sq)
    sim = torch.where(denom > 0, ip / torch.where(denom > 0, denom, 1.0),
                      -torch.inf)
    return torch.where(denom > 0, 1.0 - torch.clamp(sim, -1.0, 1.0),
                       torch.inf)


def _coerce_dense_queries(q, dim: int, device) -> torch.Tensor:
    if isinstance(q, (Vector, HalfVec)):
        q = q.x[None, :]
    elif isinstance(q, (list, tuple)) and q and isinstance(q[0], (Vector, HalfVec)):
        q = np.stack([v.x for v in q])
    if isinstance(q, torch.Tensor):
        arr = q.to(device=device, dtype=torch.float32)
    else:
        arr = torch.as_tensor(np.asarray(q, dtype=np.float32), device=device)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.shape[1] != dim:
        raise DataException(f"different vector dimensions {arr.shape[1]} and {dim}")
    return arr


def _coerce_bit_queries(q, table: BitTable) -> torch.Tensor:
    """Bit values or bools (…, dim) → packed (Q, words) int32 on the
    table's device."""
    if isinstance(q, Bit):
        q = q.bits[None, :]
    elif isinstance(q, (list, tuple)) and q and isinstance(q[0], Bit):
        q = np.stack([b.bits for b in q])
    if not torch.is_tensor(q):
        q = np.asarray(q, dtype=bool)
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[1] != table.dim:
        raise DataException(
            f"different bit lengths {q.shape[1]} and {table.dim}")
    return D.pack_bits(q).to(table.device)


def _sparse_list(q, dim: int):
    """SparseVec queries as a list, each checked against the table's dim."""
    if isinstance(q, SparseVec):
        q = [q]
    for sv in q:
        if sv.dim != dim:
            raise DataException(
                f"different sparsevec dimensions {sv.dim} and {dim}")
    return list(q)


def sparse_query_arrays(q, width: int, device):
    """(Q, width) padded index and value tensors of SparseVec queries."""
    q_idx = np.full((len(q), width), D.SPARSE_PAD, dtype=np.int32)
    q_val = np.zeros((len(q), width), dtype=np.float32)
    for r, sv in enumerate(q):
        q_idx[r, : sv.nnz] = sv.indices
        q_val[r, : sv.nnz] = sv.values
    return (torch.as_tensor(q_idx, device=device),
            torch.as_tensor(q_val, device=device))


def dense_exact(metric: Metric, qs: torch.Tensor, data: torch.Tensor,
                n: int, k: int, valid: torch.Tensor, tile: int):
    """The dense exact engine, routed as the module docstring says.
    Returns (stored distances, int32 ids, the route's name)."""
    mode = _exact_mode()
    if (mode != "xla" and fused_topk.supported(metric, data.dtype)
            and n >= FUSED_MIN_ROWS and k <= fused_topk.MAX_K):
        d, i = fused_topk.exact_topk(metric, qs, data[:n], k, valid=valid)
        return d, i, "fused"
    if (mode == "grouped" and n >= FUSED_MIN_ROWS
            and metric in (Metric.L2, Metric.IP, Metric.COSINE)):
        def score_rows(cand):
            return _dense_row_scores(metric, qs, data[cand])

        d, i = grouped_exact_topk(
            lambda t: D.dense_scores(metric, qs, t), score_rows, (data,), n,
            k, group=_grouped_group_size(n, qs.shape[0]), valid=valid)
        return d, i, "grouped"

    def score(tile_data):
        return D.dense_scores(metric, qs, tile_data)

    d, i = tiled_topk(score, (data,), n, k, tile=tile, valid=valid)
    return d, i, "tiled"


class FlatIndex:
    """Exact top-k over a dense, bit or sparse table.  Stateless w.r.t. the
    table's contents — always sees the current rows + validity mask.
    ``last_path`` names the route of the previous search (module
    docstring)."""

    def __init__(self, table: Union[DenseTable, BitTable, SparseTable],
                 metric: Metric, tile: int = 8192):
        self.table = table
        self.metric = metric
        self.tile = tile
        #: pg_stat observability analogue (utils/stats.py)
        self.stats = ScanStats()
        self.last_path: str = ""
        if isinstance(table, DenseTable):
            if metric not in DENSE_METRICS:
                raise DataException(
                    f"operator {metric.op} does not apply to dense vectors")
        elif isinstance(table, BitTable):
            if metric not in BIT_METRICS:
                raise DataException(
                    f"operator {metric.op} does not apply to bit vectors")
        elif isinstance(table, SparseTable):
            if metric not in SPARSE_METRICS:
                raise DataException(
                    f"operator {metric.op} does not apply to sparse vectors")
        else:
            raise DataException(
                f"exact search does not apply to {type(table).__name__}")

    def _valid(self, fmask):
        """Live-row mask over the first ``count`` rows, ANDed with an
        optional caller filter (capacity- or count-sized)."""
        v = self.table.valid[: self.table.count]
        if fmask is not None:
            fm = torch.as_tensor(np.asarray(fmask, dtype=bool),
                                 device=v.device)
            v = v & fm[: self.table.count]
        return v

    # -- dense -------------------------------------------------------------
    def _search_dense(self, q, k: int, fmask=None):
        table = self.table
        qs = _coerce_dense_queries(q, table.dim, table.device)
        d, i, self.last_path = dense_exact(
            self.metric, qs, table.data, table.count, k, self._valid(fmask),
            self.tile)
        return d, i

    # -- bit ---------------------------------------------------------------
    def _search_bit(self, q, k: int, fmask=None):
        table: BitTable = self.table
        qw = _coerce_bit_queries(q, table)
        metric = self.metric
        data = table.data[: table.count]
        valid = self._valid(fmask)
        if k <= fused_topk.MAX_K:
            self.last_path = "bit-kernel"
            # no popcounts: K4 needs none of the table's (Jaccard counts
            # |x| as it unpacks), the plain version counts them a tile
            return bit_topk(metric, qw, data, k, valid.contiguous())
        self.last_path = "tiled"

        def score(tile_words):
            return D.bit_scores(metric, qw, tile_words)

        return tiled_topk(score, (data,), table.count, k, tile=self.tile,
                          valid=valid)

    # -- sparse ------------------------------------------------------------
    def _sparse_densified(self) -> torch.Tensor:
        """Dense f32 (count, dim) copy of the sparse table, cached on the
        table (product paths build a fresh FlatIndex per query) and keyed
        by its insert count; deletes do not change the values, and the
        validity mask is passed to the engine fresh."""
        table: SparseTable = self.table
        key = (table.version, table.count)
        cached = getattr(table, "_dense_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        table._dense_cache = None  # free the stale copy first
        n = table.count
        data = torch.empty((n, table.dim), dtype=torch.float32,
                           device=table.device)
        chunk = max(1, (1 << 27) // (4 * (table.dim + 1)))
        for s in range(0, n, chunk):
            data[s: s + chunk] = D.scatter_dense(
                table.idx[s: min(s + chunk, n)],
                table.val[s: min(s + chunk, n)], table.dim)[:, : table.dim]
        table._dense_cache = (key, data)
        return data

    def _search_sparse(self, q, k: int, fmask=None):
        table: SparseTable = self.table
        q = _sparse_list(q, table.dim)
        metric = self.metric
        valid = self._valid(fmask)
        dense_metric = metric in (Metric.L2, Metric.IP, Metric.COSINE)
        budget = float(os.environ.get("PGVECTOR_TPU_SPARSE_DENSIFY_GB", "8"))
        if (dense_metric and table.count >= FUSED_MIN_ROWS
                and table.count * table.dim * 4 <= budget * 2**30):
            qs = self._dense_sparse_queries(q)
            d, i, path = dense_exact(metric, qs, self._sparse_densified(),
                                     table.count, k, valid, self.tile)
            self.last_path = f"densified-{path}"
            return d, i
        if dense_metric:
            tile_budget = int(os.environ.get(
                "PGVECTOR_TPU_SPARSE_TILE_BYTES", str(512 << 20)))
            t_rows = min(max(tile_budget // (table.dim * 4), 1), self.tile)
            t_rows = 1 << (int(t_rows).bit_length() - 1)  # floor pow2
            if t_rows >= MIN_TILE_ROWS:
                self.last_path = "densified-tile"
                return self._densified_tiles(self._dense_sparse_queries(q),
                                             k, valid, t_rows)
        self.last_path = "merge-join"
        pq = max(max((sv.nnz for sv in q), default=1), 1)
        q_idx, q_val = sparse_query_arrays(q, pq, table.device)
        chunk = max(1, int(os.environ.get("PGVECTOR_TPU_SPARSE_CHUNK", "256")))
        outs = []
        for s in range(0, len(q), chunk):
            ci, cv = q_idx[s: s + chunk], q_val[s: s + chunk]

            def score(tile_idx, tile_val, ci=ci, cv=cv):
                return D.sparse_scores_batch(metric, ci, cv, tile_idx, tile_val)

            outs.append(tiled_topk(score, (table.idx, table.val), table.count,
                                   k, tile=self.tile, valid=valid))
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    def _dense_sparse_queries(self, q) -> torch.Tensor:
        qs = np.zeros((len(q), self.table.dim), dtype=np.float32)
        for r, sv in enumerate(q):
            qs[r, sv.indices] = sv.values
        return torch.as_tensor(qs, device=self.table.device)

    def _densified_tiles(self, qs: torch.Tensor, k: int, valid: torch.Tensor,
                         t_rows: int):
        """Scatter each tile of ``t_rows`` rows dense on the device and
        score it: K1 for L2/IP (k ≤ 64; no (Q, tile) score block reaches
        device memory), dense_scores otherwise; merge into the running
        best, which sits first, so equal distances keep the lower row."""
        table: SparseTable = self.table
        metric, n, nq = self.metric, table.count, qs.shape[0]
        kernel = fused_topk.supported(metric, torch.float32) and \
            k <= fused_topk.MAX_K
        best_d = torch.full((nq, k), torch.inf, device=qs.device)
        best_i = torch.full((nq, k), -1, dtype=torch.int32, device=qs.device)
        for start in range(0, max(n, 1), t_rows):
            end = min(start + t_rows, n)
            dense = D.scatter_dense(table.idx[start:end],
                                    table.val[start:end],
                                    table.dim)[:, : table.dim]
            if kernel:
                d, i = fused_topk.exact_topk(metric, qs, dense,
                                             min(k, end - start),
                                             valid=valid[start:end])
                i = torch.where(i >= 0, i + start, -1)
            else:
                s = D.dense_scores(metric, qs, dense)
                s = torch.where(valid[None, start:end], s, torch.inf)
                ids = torch.arange(start, end, dtype=torch.int32,
                                   device=qs.device)
                d, i = s, ids.expand(nq, -1)
            best_d, best_i = merge_topk(best_d, best_i, d, i, k)
            best_i = torch.where(torch.isinf(best_d), -1, best_i)
        return best_d, best_i

    def search(self, q, k: int,
               filter_mask=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k.  Returns (distances, row_ids) as numpy arrays with
        user-facing operator distances; absent slots give inf / -1.
        ``filter_mask`` restricts results to rows where it is True."""
        if isinstance(self.table, DenseTable):
            stored, ids = self._search_dense(q, k, filter_mask)
        elif isinstance(self.table, BitTable):
            stored, ids = self._search_bit(q, k, filter_mask)
        else:
            stored, ids = self._search_sparse(q, k, filter_mask)
        if self.metric is Metric.L2:
            user = torch.where(torch.isinf(stored), stored,
                               torch.sqrt(torch.clamp(stored, min=0.0)))
        else:
            user = stored
        user, ids = user.cpu().numpy(), ids.cpu().numpy()
        self.stats.count(len(ids), ids)
        return user, ids
