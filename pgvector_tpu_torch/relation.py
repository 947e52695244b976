"""Relation — the table-with-indexes facade (the SQL experience minus SQL),
counterpart of ``pgvector_tpu.relation``.

Ties together the storage, index AMs, planner, and scans the way Postgres
does for ``SELECT ... ORDER BY embedding <-> q LIMIT k``:

    rel = Relation(DenseTable(128))
    rel.insert(vectors)
    rel.create_index("hnsw", Metric.L2, m=16, ef_construction=64)
    dists, ids = rel.knn(q, k=10)          # planner picks the access path
    print(rel.explain(Metric.L2))          # EXPLAIN-style plan line

DML flows through every attached index (aminsert per index); ``delete`` +
``vacuum`` mirror dead-tuple marking and index cleanup.  The table and its
indexes live on the table's device (the card unless the caller named
another); ``knn`` returns numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .errors import DataException
from .index.flat import FlatIndex
from .ops.metric import Metric
from .planner import choose_path, estimate_cost


class Relation:
    def __init__(self, table):
        self.table = table
        self.indexes: List[object] = []
        #: optional io.replication.ReplicationLog — when set, insert /
        #: delete / vacuum append delta records (the WAL-streaming
        #: analogue a replica replays via apply_deltas)
        self.replication_log = None

    # ------------------------------------------------------------------- DDL
    def create_index(self, kind: str, metric: Optional[Metric] = None, **opts):
        """CREATE INDEX ... USING {hnsw | ivfflat | btree}.  The AM kinds
        take an opclass metric; btree indexes the total value ordering
        (sql/vector.sql:300-346) and takes none."""
        if kind == "btree":
            from .index.btree import OrderedIndex

            idx = OrderedIndex(self.table, **opts)
        elif metric is None:
            raise DataException(f'access method "{kind}" requires an opclass metric')
        elif kind == "hnsw":
            from .index.hnsw import HNSWIndex

            idx = HNSWIndex(self.table, metric, **opts)
        elif kind == "ivfflat":
            from .index.ivfflat import IVFFlatIndex

            idx = IVFFlatIndex(self.table, metric, **opts)
        else:
            raise DataException(f'access method "{kind}" does not exist')
        self.indexes.append(idx)
        return idx

    def drop_index(self, idx) -> None:
        self.indexes.remove(idx)

    # ------------------------------------------------------------------- DML
    def insert(self, values) -> np.ndarray:
        rows = self.table.insert(values)
        for idx in self.indexes:
            idx.insert(rows)
        if self.replication_log is not None:
            self.replication_log.log_insert(self.table, rows)
        return rows

    def delete(self, rows) -> None:
        self.table.delete(rows)
        if self.replication_log is not None:
            self.replication_log.log_delete(np.atleast_1d(
                np.asarray(rows, np.int64)))

    def vacuum(self) -> None:
        for idx in self.indexes:
            idx.vacuum()
        if self.replication_log is not None:
            self.replication_log.log_vacuum()

    # ----------------------------------------------------------------- query
    def knn(
        self,
        q,
        k: int,
        metric: Optional[Metric] = None,
        filter_mask: Optional[np.ndarray] = None,
        use_index: bool = True,
        **knobs,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k by the given metric; the planner chooses exact scan vs an
        index path by estimated cost (``use_index=False`` ≈ SET
        enable_indexscan = off, the recall-monitoring recipe
        README.md:762-773)."""
        metric = metric or self._default_metric()
        path = choose_path(self.table, self.indexes if use_index else [],
                           metric, **knobs)
        if path.index is None:
            return FlatIndex(self.table, metric).search(
                q, k, filter_mask=filter_mask)
        kwargs = {}
        if filter_mask is not None:
            kwargs["filter_mask"] = filter_mask
        from .index.hnsw import HNSWIndex

        if isinstance(path.index, HNSWIndex):
            if "ef_search" in knobs:
                kwargs["ef_search"] = knobs["ef_search"]
        else:
            if "probes" in knobs:
                kwargs["probes"] = knobs["probes"]
        if filter_mask is not None or kwargs:
            return path.index.search(q, k, **kwargs)
        return path.index.search(q, k)

    def explain(self, metric: Optional[Metric] = None, analyze: bool = False,
                q=None, k: int = 10, **knobs) -> str:
        """EXPLAIN-style plan with cost estimates; ``analyze=True`` also
        runs the query and appends actual rows / wall time / the PG18
        "Index Searches" line (nsearches, hnswscan.c:206-210)."""
        metric = metric or self._default_metric()
        lines = []
        path = choose_path(self.table, self.indexes, metric, **knobs)
        for idx in [None] + self.indexes:
            if idx is not None and getattr(idx, "metric", None) is not metric:
                continue
            cost = estimate_cost(idx, self.table, metric, **knobs)
            name = "Seq Scan" if idx is None else (
                f"Index Scan using {type(idx).__name__.replace('Index','').lower()}"
            )
            chosen = " <-- chosen" if (
                (idx is None) == (path.index is None)
                and (idx is path.index)
            ) else ""
            lines.append(f"{name}  (cost≈{cost:.0f} tuples){chosen}")
        if analyze:
            import time

            if q is None:
                raise DataException("EXPLAIN ANALYZE requires a query vector")
            before = (path.index.stats.searches
                      if path.index is not None else 0)
            t0 = time.perf_counter()
            _, r = self.knn(q, k, metric=metric, **knobs)
            ms = (time.perf_counter() - t0) * 1000.0
            lines.append(f"Rows Returned: {int((r >= 0).sum())}")
            if path.index is not None:
                lines.append(
                    f"Index Searches: {path.index.stats.searches - before}")
            lines.append(f"Execution Time: {ms:.3f} ms")
        return "\n".join(lines)

    def _default_metric(self) -> Metric:
        # first index that HAS an opclass metric (btree OrderedIndex
        # indexes the total value ordering and carries none)
        for idx in self.indexes:
            m = getattr(idx, "metric", None)
            if m is not None:
                return m
        return Metric.L2

    def __len__(self) -> int:
        return self.table.live_count
