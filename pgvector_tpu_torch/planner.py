"""Cost estimation + access-path choice — counterpart of
``pgvector_tpu.planner``, the library form of pgvector's planner hooks
(hnswcostestimate src/hnsw.c:134-233, ivfflatcostestimate
src/ivfflat.c:85-151) and Postgres's index-vs-seqscan decision.

The reference returns infinite cost when a scan has no ORDER BY distance
operator (hnsw.c:147-160) — the translation here: an index path is only
offered for a matching metric, and the planner compares estimated tuple
visits (the dominant device-time proxy) across exact scan, HNSW, and
IVFFlat to pick the cheapest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch

from .config import config
from .ops.metric import Metric


@dataclass
class Path:
    kind: str  # "exact" | "hnsw" | "ivfflat"
    index: Optional[object]
    cost: float

    def __repr__(self) -> str:
        # tuple-model costs are row counts (≥1); calibrated costs are
        # device seconds (≪1) — render small values with enough precision
        return f"Path({self.kind}, cost={self.cost:.6g})"


def hnsw_scan_tuples(n: int, m: int, ef_search: int, entry_level: int) -> float:
    """Expected tuples visited by one HNSW scan — the reference's estimate
    (hnsw.c:197-208): entryLevel·m descent hops plus a layer-0 term
    2m·ef_search · 0.55·ln(N) / (ln(m)·(1+ln(ef_search)))."""
    if n <= 0:
        return 1.0
    layer0 = (
        2.0 * m * ef_search
        * 0.55 * math.log(max(n, 2))
        / (math.log(m) * (1.0 + math.log(max(ef_search, 2))))
    )
    return max(entry_level, 0) * m + layer0


def ivfflat_scan_tuples(n: int, lists: int, probes: int) -> float:
    """Expected tuples for an IVFFlat scan (ivfflat.c:85-151): all list
    centers plus the probed fraction of the table."""
    probes = min(probes, lists)
    return lists + n * probes / max(lists, 1)


def estimate_cost(index_or_none, table, metric: Metric,
                  ef_search: Optional[int] = None,
                  probes: Optional[int] = None) -> float:
    """Tuple-visit estimate for one access path (per query)."""
    from .index.hnsw import HNSWIndex
    from .index.ivfflat import IVFFlatIndex

    n = table.live_count
    if index_or_none is None:
        return float(max(n, 1))  # exact scan visits everything
    idx = index_or_none
    if isinstance(idx, HNSWIndex):
        ef = int(ef_search if ef_search is not None else config.get("hnsw.ef_search"))
        return hnsw_scan_tuples(n, idx.m, ef, max(idx.entry_level, 0))
    if isinstance(idx, IVFFlatIndex):
        p = int(probes if probes is not None else config.get("ivfflat.probes"))
        return ivfflat_scan_tuples(n, idx.lists, p)
    raise TypeError(f"unknown index type {type(idx).__name__}")


def choose_path(table, indexes: List[object], metric: Metric,
                order_by: bool = True, calibration: "Calibration" = None,
                q_count: int = 1, **knobs) -> Path:
    """Pick the cheapest access path for a top-k query ordered by
    ``metric``.  Without ORDER BY the approximate indexes are unusable
    (infinite cost, hnsw.c:147-160) and the exact scan wins.

    With ``calibration`` (see ``calibrate``), costs are predicted DEVICE
    SECONDS for a ``q_count``-query batch instead of the reference's
    tuple-visit proxy — on TPU the proxy misorders paths badly (an exact
    scan "visits" every row but rides one tensor-core product, while each
    HNSW tuple visit sits behind a latency-bound gather), so the crossover
    between paths is a measured property, not a row-count one."""
    if calibration is not None:
        paths = [Path("exact", None, calibration.predict("exact", q_count))]
        if order_by:
            for idx in indexes:
                if getattr(idx, "metric", None) is not metric:
                    continue
                key = calibration.key_of(idx)
                if key not in calibration.constants:
                    continue  # not measured → not offered
                kind = type(idx).__name__.replace("Index", "").lower()
                paths.append(Path(kind, idx, calibration.predict(key, q_count)))
        return min(paths, key=lambda p: p.cost)
    paths = [Path("exact", None, estimate_cost(None, table, metric))]
    if order_by:
        for idx in indexes:
            if getattr(idx, "metric", None) is not metric:
                continue  # opclass mismatch → path not offered
            kind = type(idx).__name__.replace("Index", "").lower()
            paths.append(Path(kind, idx, estimate_cost(idx, table, metric, **knobs)))
    return min(paths, key=lambda p: p.cost)


class Calibration:
    """Per-path device-time model fit from measured runs (VERDICT r3 #9).

    Each path's batch time is modeled as ``fixed + per_q · Q``: the fixed
    term captures dispatch/compile-free kernel-launch overhead and
    per-batch setup (greedy descent, probe ordering), the linear term the
    per-query work.  Constants come from timing the REAL paths on the
    caller's actual table/indexes at two probe batch sizes — no
    hand-tuned rates, so the model tracks whatever the current device
    (the CPU or a CUDA card) actually delivers."""

    def __init__(self, constants):
        #: {key: (fixed_s, per_q_s)}; key "exact" or id() of an index
        self.constants = constants

    @staticmethod
    def key_of(idx) -> object:
        return "exact" if idx is None else id(idx)

    def predict(self, key, q_count: int) -> float:
        fixed, per_q = self.constants[key]
        return fixed + per_q * max(q_count, 1)


def _time_path(search_fn, queries, sizes, device=None) -> tuple:
    """Fit (fixed_s, per_q_s) for one path: warm each probe shape once
    (kernel build, slab cache), then take the best of 2 timed runs per
    size and solve the two-point linear system.

    CUDA work is asynchronous: the host clock measures the device only
    when the timed call ends in a synchronise.  The searches return numpy
    arrays today, which synchronises, but the clock stops behind an
    explicit ``torch.cuda.synchronize`` on a CUDA ``device`` as well, so
    a search that returned device tensors could not make the calibration
    time only the launches."""
    import time as _time

    def sync():
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    samples = []
    for q_n in sizes:
        qb = queries[:q_n]
        search_fn(qb)  # warm this shape
        best = float("inf")
        for _ in range(2):
            sync()
            t0 = _time.perf_counter()
            search_fn(qb)
            sync()
            best = min(best, _time.perf_counter() - t0)
        samples.append((q_n, best))
    (q1, t1), (q2, t2) = samples[0], samples[-1]
    per_q = max((t2 - t1) / max(q2 - q1, 1), 0.0)
    fixed = max(t1 - per_q * q1, 0.0)
    return fixed, per_q


def calibrate(table, indexes: List[object], metric: Metric, queries,
              k: int = 10, sizes=(32, 256), **knobs) -> Calibration:
    """Measure every offered path on ``table`` with real probe batches
    drawn from ``queries`` — and with all of ``queries``, the batch the
    caller plans for, when it is larger than the probe sizes — and return
    a ``Calibration`` for ``choose_path(..., calibration=...)``.

    Any index exposing ``.metric`` and ``.search(q, k)`` participates —
    HNSW, IVFFlat and the Expression/re-rank indexes alike
    (the reference's costestimate hooks only cover its two AMs;
    device-time measurement generalizes for free)."""
    from .index.flat import FlatIndex

    n_avail = queries.shape[0] if hasattr(queries, "shape") else len(queries)
    sizes = tuple(min(s, n_avail) for s in sizes)
    if n_avail > max(sizes):
        # The whole query set is timed too, and the line is fit through
        # it: on a CUDA card neither path is linear in the batch between
        # probe sizes and the batch the caller plans for (an HNSW search
        # is paced by its per-hop launches, nearly flat in the batch; K1
        # turns compute-bound only at large batches), so a line through
        # 32 and 256 queries alone extrapolates both the wrong way and
        # picks the slower path.  The reference fits the probe sizes
        # only.
        sizes = sizes + (n_avail,)
    flat = FlatIndex(table, metric)
    dev = table.device
    constants = {"exact": _time_path(lambda q: flat.search(q, k),
                                     queries, sizes, dev)}
    for idx in indexes:
        if getattr(idx, "metric", None) is not metric:
            continue
        constants[Calibration.key_of(idx)] = _time_path(
            lambda q, idx=idx: idx.search(q, k, **knobs), queries, sizes,
            dev)
    return Calibration(constants)
