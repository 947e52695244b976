"""Re-ranking pipelines — counterpart of ``pgvector_tpu.rerank``, the
library form of pgvector's quantization recipes (README.md:558-663):

- **binary quantization + re-rank** (README.md:589-609): a Hamming HNSW
  over ``binary_quantize(embedding)``, then the candidates re-ordered by
  the exact distance on the original vectors;
- **subvector + re-rank** (README.md:644-663): an HNSW over
  ``subvector(v, 1, d')``, re-ranked full-width;
- any row-wise expression index (README.md:558-569).

``exact_rerank`` is the shared second stage: gather the candidate rows of
the source table and re-score them with the exact operator distance.
Expressions map a (R, dim) f32 tensor of source rows, on the table's
device, to the shadow values: a float tensor makes a DenseTable shadow, a
bool tensor a BitTable shadow.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .errors import DataException
from .index.flat import _coerce_dense_queries
from .index.hnsw import HNSWIndex
from .ops.metric import Metric
from .ops.topk import topk_smallest
from .store.table import BitTable, DenseTable


def exact_rerank(table: DenseTable, metric: Metric, q,
                 candidate_ids: np.ndarray, k: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Re-score (Q, C) candidate row ids (-1 padded) with the exact
    operator distance and keep the best k (the outer ORDER BY of the
    re-rank CTE, README.md:600-607).  Zero-norm rows, or a zero query,
    score +inf under cosine and come out as absent slots (-1 / inf), as in
    the reference."""
    qs = _coerce_dense_queries(q, table.dim, table.device)
    cand = torch.as_tensor(np.asarray(candidate_ids, np.int32),
                           device=table.device)
    safe = torch.clamp(cand, min=0).long()
    qf = qs[:, None, :]
    vf = table.data[safe].float()  # (Q, C, D)
    if metric is Metric.L2:
        s = torch.sum((qf - vf) ** 2, dim=-1)
    elif metric is Metric.IP:
        s = -torch.sum(qf * vf, dim=-1)
    elif metric is Metric.COSINE:
        ip = torch.sum(qf * vf, dim=-1)
        denom = (torch.sqrt(torch.sum(qf * qf, dim=-1))
                 * torch.sqrt(torch.sum(vf * vf, dim=-1)))
        s = 1.0 - torch.where(denom > 0,
                              ip / torch.where(denom > 0, denom, 1.0),
                              -torch.inf)
    elif metric is Metric.L1:
        s = torch.sum(torch.abs(qf - vf), dim=-1)
    else:
        raise DataException(
            f"operator {metric.op} does not apply to dense re-ranking")
    ok = (cand >= 0) & table.valid[safe]
    s = torch.where(ok, s, torch.inf)
    d, i = topk_smallest(s, min(k, s.shape[1]), ids=cand)
    i = torch.where(torch.isinf(d), -1, i)
    if metric is Metric.L2:
        d = torch.where(torch.isinf(d), d, torch.sqrt(torch.clamp(d, min=0.0)))
    return d.cpu().numpy(), i.cpu().numpy()


class ExpressionIndex:
    """An HNSW over ``expr(value)`` — ``CREATE INDEX ON t ((expr(v)))``
    (README.md:558-569).  Keeps a shadow table of the expression's values
    and an explicit shadow-row → source-row map, so inserts in any order,
    also after deletes and slot reuse on the source, stay consistent.

    ``qexpr`` (default ``expr``) maps the coerced queries the same way.
    ``search`` runs the shadow index, maps ids back to source rows and,
    with ``rerank``, re-scores them exactly on the source (fetching
    ``rerank_factor`` × k candidates)."""

    def __init__(self, table: DenseTable, expr, metric: Metric = Metric.L2,
                 shadow_metric: Optional[Metric] = None, qexpr=None,
                 rerank: bool = True, rerank_factor: int = 4,
                 m: int = 16, ef_construction: int = 64, seed: int = 0,
                 **kw):
        self.table = table
        self.expr = expr
        self.qexpr = qexpr or expr
        self.metric = metric
        self.rerank = rerank
        self.rerank_factor = rerank_factor
        self._src_of_shadow = np.zeros(0, np.int64)
        dev = table.device
        live = np.flatnonzero(table.valid[: table.count].cpu().numpy())
        sample = self.expr(torch.zeros((1, table.dim), device=dev))
        cap = max(table.count, 8)
        if sample.dtype == torch.bool:
            self.shadow = BitTable(sample.shape[1], capacity=cap, device=dev)
            shadow_metric = shadow_metric or Metric.HAMMING
            kw.setdefault("dedup", False)
        else:
            self.shadow = DenseTable(sample.shape[1], capacity=cap,
                                     device=dev)
            shadow_metric = shadow_metric or metric
        if len(live):
            srows = self._insert_shadow(live)
            self._map_rows(srows, live)
        self.index = HNSWIndex(self.shadow, shadow_metric, m=m,
                               ef_construction=ef_construction, seed=seed,
                               **kw)

    def _insert_shadow(self, rows: np.ndarray) -> np.ndarray:
        """Append ``expr`` of source ``rows`` to the shadow table, in
        chunks of rows on the device; returns the shadow row ids."""
        out = []
        chunk = 1 << 18
        for s in range(0, len(rows), chunk):
            r = torch.as_tensor(rows[s: s + chunk], device=self.table.device)
            vals = self.expr(self.table.data[r].float())
            if isinstance(self.shadow, DenseTable):
                vals = vals.cpu().numpy()
            out.append(self.shadow.insert(vals))
        return np.concatenate(out).astype(np.int64)

    def _map_rows(self, shadow_rows: np.ndarray, src_rows: np.ndarray) -> None:
        hi = int(shadow_rows.max(initial=-1)) + 1
        if hi > len(self._src_of_shadow):
            grown = np.full(max(hi, 2 * len(self._src_of_shadow), 8), -1,
                            np.int64)
            grown[: len(self._src_of_shadow)] = self._src_of_shadow
            self._src_of_shadow = grown
        self._src_of_shadow[shadow_rows] = src_rows

    def insert(self, rows) -> None:
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        srows = self._insert_shadow(rows)
        self._map_rows(srows, rows)
        self.index.insert(srows)

    def vacuum(self) -> None:
        """Propagate source deletes to the shadow, then vacuum the shadow
        index — no id-alignment assumption."""
        src_valid = self.table.valid.cpu().numpy()
        n_sh = self.shadow.count
        srcs = self._src_of_shadow[:n_sh]
        sh_valid = self.shadow.valid[:n_sh].cpu().numpy()
        dead_sh = np.flatnonzero(
            sh_valid & ((srcs < 0) | ~src_valid[np.maximum(srcs, 0)]))
        if len(dead_sh):
            self.shadow.delete(dead_sh)
        self.index.vacuum()

    def search(self, q, k: int, ef_search: Optional[int] = None):
        qs = _coerce_dense_queries(q, self.table.dim, self.table.device)
        qv = self.qexpr(qs)
        fetch = max(k * self.rerank_factor, k) if self.rerank else k
        # the derived ef stays inside hnsw.ef_search's range (1..1000); an
        # explicit out-of-range ef_search still raises, as a SET would
        d, cand = self.index.search(qv, fetch,
                                    ef_search=ef_search
                                    or min(max(fetch, 40), 1000))
        # shadow rows → source rows (drops shadows of deleted sources)
        safe = np.maximum(cand, 0)
        src = np.where(cand >= 0, self._src_of_shadow[safe], -1)
        src_valid = self.table.valid.cpu().numpy()
        src = np.where((src >= 0) & src_valid[np.maximum(src, 0)], src, -1)
        if not self.rerank:
            # a candidate whose source row is gone keeps id -1 and must
            # not surface a finite distance
            return np.where(src[:, :k] >= 0, d[:, :k], np.inf), src[:, :k]
        return exact_rerank(self.table, self.metric, qs, src, k)


class BinaryQuantizedIndex(ExpressionIndex):
    """Hamming HNSW over ``binary_quantize(embedding)`` with exact
    re-ranking (README.md:589-609): an ExpressionIndex whose expression is
    the sign bits (a BitTable shadow)."""

    def __init__(self, table: DenseTable, metric: Metric = Metric.L2,
                 m: int = 16, ef_construction: int = 64,
                 rerank_factor: int = 4, seed: int = 0, **kw):
        super().__init__(table, expr=lambda v: v > 0, metric=metric,
                         shadow_metric=Metric.HAMMING, m=m,
                         ef_construction=ef_construction,
                         rerank_factor=rerank_factor, seed=seed, **kw)

    @property
    def bit_table(self) -> BitTable:
        return self.shadow


class SubvectorIndex(ExpressionIndex):
    """HNSW over ``subvector(v, 1, d')`` with full-width re-ranking
    (README.md:644-663): an ExpressionIndex over a prefix slice."""

    def __init__(self, table: DenseTable, metric: Metric = Metric.L2,
                 sub_dim: Optional[int] = None, m: int = 16,
                 ef_construction: int = 64, rerank_factor: int = 4,
                 seed: int = 0, **kw):
        sd = sub_dim or max(table.dim // 2, 1)
        super().__init__(table, expr=lambda v: v[:, :sd], metric=metric,
                         m=m, ef_construction=ef_construction,
                         rerank_factor=rerank_factor, seed=seed, **kw)
        self.sub_dim = sd

    @property
    def sub_table(self) -> DenseTable:
        return self.shadow
