"""Index scan statistics — the pg_stat observability analogue.

The reference leans on Postgres's cumulative stats: every amrescan bumps
``pg_stat_user_indexes.idx_scan`` via ``pgstat_count_index_scan``, and
PG18 EXPLAIN shows per-node ``Index Searches`` (nsearches — incremented
once per actual graph descent, so iterative-scan resumes count,
hnswscan.c:206-210).  Every index here carries a ``ScanStats`` instance
(``idx.stats``) with the same meanings, batch-shaped:

- ``scans``: ``search()`` calls (amrescan analogue)
- ``queries``: total query vectors scanned
- ``searches``: graph/posting descents — queries × (1 + iterative
  resumes), the nsearches analogue
- ``tuples_returned``: non-null result tuples emitted

Two counts of the port's own, outside ``as_dict()`` (the fields the
reference shares):

- ``host_reads``: blocking device → host reads made by the index's
  scans and inserts (``utils.telemetry.host_read``), on the CPU too
- ``query_hops``: layer-0 hops summed over the queries of the HNSW
  index's plain scans, K2's work count
"""

from __future__ import annotations

import numpy as np


class ScanStats:
    __slots__ = ("scans", "queries", "searches", "tuples_returned",
                 "host_reads", "query_hops")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.scans = 0
        self.queries = 0
        self.searches = 0
        self.tuples_returned = 0
        self.host_reads = 0
        self.query_hops = 0

    def count(self, nq: int, rows, rounds: int = 1) -> None:
        self.scans += 1
        self.queries += int(nq)
        self.searches += int(nq) * max(int(rounds), 1)
        self.tuples_returned += int((np.asarray(rows) >= 0).sum())

    def as_dict(self) -> dict:
        return {"scans": self.scans, "queries": self.queries,
                "searches": self.searches,
                "tuples_returned": self.tuples_returned}

    def __repr__(self) -> str:  # pragma: no cover - debug convenience
        return (f"ScanStats({self.as_dict()}, host_reads={self.host_reads}, "
                f"query_hops={self.query_hops})")
