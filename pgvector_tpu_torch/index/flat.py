"""Exact (brute-force) search — pgvector's no-index path and the ground
truth for every recall test; counterpart of ``pgvector_tpu.index.flat``
(the dense path).

Routing by metric and shape, as the reference's gate does
(``flat.py:154-156``): L2 and inner product over an f32 table with at
least 4096 rows and k ≤ 64 go to K1 (:mod:`..ops.fused_topk`); every other
dense search (cosine, L1, k > 64, small tables) goes to the tiled scan
(:func:`..ops.topk.tiled_topk`).  The reference's default grouped engine
is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..errors import DataException, FeatureNotSupported
from ..ops import distance as D
from ..ops import fused_topk
from ..ops.metric import Metric
from ..ops.topk import tiled_topk
from ..store.table import DenseTable
from ..types import HalfVec, Vector
from ..utils.stats import ScanStats

DENSE_METRICS = (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1)

#: the smallest table K1 scans (the reference's gate, flat.py:155)
FUSED_MIN_ROWS = 4096


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


class FlatIndex:
    """Exact top-k over a dense table.  Stateless w.r.t. the table's
    contents — always sees the current rows + validity mask.
    ``last_path`` records which engine served the previous search
    ("fused" for K1, "tiled" for the tiled scan)."""

    def __init__(self, table: DenseTable, metric: Metric, tile: int = 8192):
        if not isinstance(table, DenseTable):
            raise FeatureNotSupported(
                f"exact search over {type(table).__name__} is not ported yet")
        if metric not in DENSE_METRICS:
            raise DataException(f"operator {metric.op} does not apply to dense vectors")
        self.table = table
        self.metric = metric
        self.tile = tile
        #: pg_stat observability analogue (utils/stats.py)
        self.stats = ScanStats()
        self.last_path: str = ""

    def _valid(self, fmask):
        """Live-row mask over the first ``count`` rows, ANDed with an
        optional caller filter (capacity- or count-sized)."""
        v = self.table.valid[: self.table.count]
        if fmask is not None:
            fm = torch.as_tensor(np.asarray(fmask, dtype=bool),
                                 device=v.device)
            v = v & fm[: self.table.count]
        return v

    def _search_dense(self, q, k: int, fmask=None):
        table = self.table
        qs = _coerce_dense_queries(q, table.dim, table.device)
        metric = self.metric
        if (fused_topk.supported(metric, table.dtype)
                and table.count >= FUSED_MIN_ROWS and k <= fused_topk.MAX_K):
            self.last_path = "fused"
            return fused_topk.exact_topk(
                metric, qs, table.data[: table.count], k,
                valid=self._valid(fmask))
        self.last_path = "tiled"

        def score(tile_data):
            return D.dense_scores(metric, qs, tile_data)

        return tiled_topk(score, (table.data,), table.count, k,
                          tile=self.tile, valid=self._valid(fmask))

    def search(self, q, k: int,
               filter_mask=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k.  Returns (distances, row_ids) as numpy arrays with
        user-facing operator distances; absent slots give inf / -1.
        ``filter_mask`` restricts results to rows where it is True."""
        stored, ids = self._search_dense(q, k, filter_mask)
        if self.metric is Metric.L2:
            user = torch.where(torch.isinf(stored), stored,
                               torch.sqrt(torch.clamp(stored, min=0.0)))
        else:
            user = stored
        user, ids = user.cpu().numpy(), ids.cpu().numpy()
        self.stats.count(len(ids), ids)
        return user, ids
