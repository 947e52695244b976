"""Observability — phase timers and spans, host-read counters, build
progress and device-memory accounting.

The reference's story (SURVEY.md §5): compile-time ``*_BENCH`` flags wrap
build phases in instr_time timers (hnsw.h:89-102), and
``pg_stat_progress_create_index`` reports named phases
(hnswbuildphasename hnsw.c:117-129).  Here the equivalents are runtime: a
timer registry that also keeps each phase as a span, and a progress
callback protocol, as in ``pgvector_tpu.utils.telemetry``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: hnswbuildphasename parity (hnsw.c:117-129)
HNSW_PHASES = ("initializing", "loading tuples")

#: spans that also take a pair of CUDA event markers on the current
#: stream, so their device time is known with no sync inside them
DEVICE_SPANS = frozenset(("hnsw.search.descent", "hnsw.search.layer0",
                          "hnsw.search.rerank"))

#: spans the log holds after :meth:`Timers.clear_spans`; later ones are
#: dropped (counted in ``Timers.dropped``)
SPAN_LOG_MAX = 65536


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is recording (in any thread)."""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One recorded phase: ``name``; ``start_ns`` and ``end_ns`` on
    ``time.time_ns()``; ``parent``, the span it ran inside (None for an
    outermost one); ``request``, the number of the outermost span above
    it (its own where it is outermost); ``counts``, host reads by site
    made while it was the innermost open span; and ``device_ms``, the
    device time between its markers (:data:`DEVICE_SPANS` only, read by
    :meth:`Timers.spans`; None otherwise)."""

    __slots__ = ("name", "number", "parent", "request", "start_ns",
                 "end_ns", "counts", "marks", "device_ms")

    def __init__(self, name: str, number: int, parent: Optional["Span"]):
        self.name, self.number, self.parent = name, number, parent
        self.request = parent.request if parent is not None else number
        self.start_ns = self.end_ns = 0
        self.counts: Dict[str, int] = {}
        self.marks = None
        self.device_ms: Optional[float] = None

    @property
    def host_reads(self) -> int:
        return sum(self.counts.values())

    def under(self, name: str) -> bool:
        """Whether this span or one it ran inside is named ``name``."""
        s = self
        while s is not None:
            if s.name == name:
                return True
            s = s.parent
        return False


class _Thread(threading.local):
    """A thread's open spans, innermost last, and its host reads."""

    def __init__(self) -> None:
        self.stack: List[Span] = []
        self.reads = 0


class Timers:
    """Accumulating phase timers — the *_BENCH instr_time analogue — that
    keep each phase as a :class:`Span`.

    ``phase(name)`` records while ``enabled`` is set or a
    ``torch.profiler`` session records; otherwise it costs one check.  A
    recorded phase adds to ``totals`` / ``counts`` (``report()``) and
    appends its span to a log bounded at :data:`SPAN_LOG_MAX` (the oldest
    kept).  Spans are on ``time.time_ns()``, the clock the profiler's
    events are on, so they lie beside the device's trace.  CUDA work is
    asynchronous: a phase that does not end in a synchronise measures the
    enqueue, not the device; the phases in :data:`DEVICE_SPANS` also
    record a CUDA event at entry and at exit, read by :meth:`spans` after
    one sync."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.enabled = False
        self.dropped = 0
        self._log: List[Span] = []
        self._numbers = itertools.count()
        self._lock = threading.Lock()
        self._thread = _Thread()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        if not (self.enabled or profiling()):
            yield
            return
        stack = self._thread.stack
        span = Span(name, next(self._numbers), stack[-1] if stack else None)
        if name in DEVICE_SPANS and torch.cuda.is_initialized():
            span.marks = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            span.marks[0].record()
        stack.append(span)
        span.start_ns = time.time_ns()
        try:
            yield
        finally:
            span.end_ns = time.time_ns()
            stack.pop()
            if span.marks is not None:
                span.marks[1].record()
            with self._lock:
                self.totals[name] += (span.end_ns - span.start_ns) / 1e9
                self.counts[name] += 1
                if len(self._log) < SPAN_LOG_MAX:
                    self._log.append(span)
                else:
                    self.dropped += 1

    def host_read(self, site: str) -> None:
        """Count one blocking device → host read at ``site``: on this
        thread's total (:attr:`host_reads`) and, while a span is open, on
        the innermost one."""
        t = self._thread
        t.reads += 1
        if t.stack:
            counts = t.stack[-1].counts
            counts[site] = counts.get(site, 0) + 1

    @property
    def host_reads(self) -> int:
        """This thread's host reads so far, recorded or not."""
        return self._thread.reads

    def spans(self) -> List[Span]:
        """The recorded spans in the order they ended, their markers read
        (one device sync where any are unread)."""
        with self._lock:
            log = list(self._log)
        unread = [s for s in log if s.marks is not None]
        if unread:
            torch.cuda.synchronize()
            for s in unread:
                s.device_ms = s.marks[0].elapsed_time(s.marks[1])
                s.marks = None
        return log

    def clear_spans(self) -> None:
        with self._lock:
            self._log = []
            self.dropped = 0

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }

    def reset(self) -> None:
        """Clear the totals; the span log is kept (:meth:`clear_spans`)."""
        self.totals.clear()
        self.counts.clear()


#: process-wide timer registry; enable with ``timers.enabled = True``
timers = Timers()


def host_read(site: str) -> None:
    """:meth:`Timers.host_read` on the process-wide registry."""
    timers.host_read(site)


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


def hbm_bytes(*tensors) -> int:
    """Total bytes of the given device tensors (``numel · element_size``;
    tuples are walked, None skipped) — the explicit device-memory budget
    that replaces the maintenance_work_mem cliff (hnswbuild.c:530-549)."""
    total = 0
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, tuple):
            total += hbm_bytes(*t)
        else:
            total += t.numel() * t.element_size()
    return total


def table_hbm_bytes(table) -> int:
    parts = [getattr(table, n, None) for n in ("data", "idx", "val", "valid")]
    return hbm_bytes(*[p for p in parts if p is not None])


def hnsw_hbm_bytes(idx, slab: bool = False) -> int:
    """The graph's bytes: its value arrays (0 while they alias the table's
    own tensors) and both neighbor levels; with ``slab``, also the packed
    layer-0 slab cache (``_nbr_vals``, with an int8 slab's scale and
    norms), the largest device allocation of a 1M graph, which the
    reference does not have."""
    vals = () if getattr(idx, "_alias_values", False) else idx.values
    total = hbm_bytes(vals, idx.nbr0, idx.nbr_up)
    if slab:
        total += hbm_bytes(idx._nbr_vals, idx._nbr_scale, idx._nbr_norm2)
    return total


def ivfflat_hbm_bytes(idx) -> int:
    return hbm_bytes(idx.centroids, idx.postings_flat,
                     getattr(idx, "post_values", None),
                     getattr(idx, "post_vsq", None))
