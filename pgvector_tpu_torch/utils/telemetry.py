"""Observability — phase timers and build progress.

The reference's story (SURVEY.md §5): compile-time ``*_BENCH`` flags wrap
build phases in instr_time timers (hnsw.h:89-102), and
``pg_stat_progress_create_index`` reports named phases
(hnswbuildphasename hnsw.c:117-129).  Here the equivalents are runtime: a
timer registry and a progress callback protocol, as in
``pgvector_tpu.utils.telemetry``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

#: hnswbuildphasename parity (hnsw.c:117-129)
HNSW_PHASES = ("initializing", "loading tuples")


class Timers:
    """Accumulating phase timers — the *_BENCH instr_time analogue.

    Host clock only: CUDA work is asynchronous, so a phase that does not
    end in a synchronise measures the enqueue, not the device."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.enabled = False

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


#: process-wide timer registry; enable with ``timers.enabled = True``
timers = Timers()


class Progress:
    """Build-progress reporting (pgstat_progress_update_param analogue,
    hnswbuild.c:602, 1093)."""

    def __init__(self, callback: Optional[Callable[[str, int, int], None]] = None):
        self.callback = callback or (lambda phase, done, total: None)
        self.phase = ""
        self.done = 0
        self.total = 0

    def set_phase(self, phase: str, total: int = 0) -> None:
        self.phase, self.done, self.total = phase, 0, total
        self.callback(phase, 0, total)

    def advance(self, n: int = 1) -> None:
        self.done += n
        self.callback(self.phase, self.done, self.total)
