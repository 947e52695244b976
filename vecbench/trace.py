"""The traced run: ``torch.profiler`` over a bounded stretch of the window.

The stretch is a fixed number of requests, starting at a fixed request of
the window, so that what is traced and kept stays small.  The benchmark
records its own spans on the host's clock (``time.time_ns``, the clock
the profiler's events are on): each request (``vb.request``,
``vb.insert_batch``) and, where a kind asks, the program's phases.
From the profiler this module keeps the device's operations (kernels,
copies, sets) with their times and, where the workload asks for
``host_ops``, the host's events on the thread that drove the window.
Recording every host operation slows a host-bound loop (an index build's
by about two thirds), so such a workload traces the device alone and
labels its idle gaps by the spans and by the device operation that ends
each gap.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

SPAN_PREFIX = "vb."


def short_name(name: str) -> str:
    """A device function's name without its parameters and without the
    anonymous namespace: ``void (anonymous namespace)::f<T>(Args)`` ->
    ``void f<T>``."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()


def kernel_base(name: str) -> str:
    """A device function's bare name: ``void ns::f<T, 3>(Args)`` -> ``f``."""
    s = short_name(name)
    s = s[5:] if s.startswith("void ") else s
    return s.split("<")[0].rsplit("::", 1)[-1].strip()


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


def _start_ns(e) -> int:
    f = getattr(e, "start_ns", None)
    return int(f()) if f else int(e.start_us() * 1000)


def _dur_ns(e) -> int:
    f = getattr(e, "duration_ns", None)
    return int(f()) if f else int(e.duration_us() * 1000)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceRecord:
    requests: int
    window: Tuple[int, int]                      # ns, profiler clock
    device_ops: List[Tuple[str, int, int]]       # name, start, end (ns)
    host: List[Tuple[str, int, int, bool]]       # name, start, end, span?
    counters: Dict[str, int] = field(default_factory=dict)  # deltas

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def clipped(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for _, s, e in self.device_ops
                if e > w0 and s < w1]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.clipped())) / 1e9

    @property
    def idle_pct(self) -> float:
        """The share of the stretch in which nothing ran on the device."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def outside_s(self) -> float:
        """Device time outside the window: near 0 where the spans' clock
        and the profiler's agree."""
        total = sum(e - s for _, s, e in self.device_ops)
        return (total - sum(e - s for s, e in self.clipped())) / 1e9

    def kernels(self, names: Optional[set] = None):
        """(name, start, end) of the kernels, or of those whose bare name
        is in ``names``."""
        return [k for k in self.device_ops if is_kernel(k[0])
                and (names is None or kernel_base(k[0]) in names)]

    def kernel_s(self, names: set) -> float:
        return sum(e - s for _, s, e in self.kernels(names)) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in _union(self.clipped()):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at their middle: the outermost
        benchmark span, the innermost of the program's spans, and the
        innermost host event or, where none was recorded, the device
        operation that ended the gap (``before <name>``)."""
        ops: Dict[str, int] = {}
        w0, w1 = self.window
        for name, s, e in self.device_ops:
            if e > w0 and s < w1:
                key = short_name(name)[:96]
                ops[key] = ops.get(key, 0) + min(e, w1) - max(s, w0)
        gaps = self.idle_gaps()
        label: Dict[str, int] = {}
        starts = sorted((max(s, w0), kernel_base(n))
                        for n, s, e in self.device_ops if e > w0 and s < w1)
        after = {}  # a gap's end -> the operation that starts there
        for s, name in reversed(starts):
            after[s] = name
        mids = sorted(((s + e) // 2, e - s, e) for s, e in gaps)
        host = sorted(self.host, key=lambda h: h[1])
        stack: list = []
        j = 0
        for mid, length, end in mids:
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] <= host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            live = [h for h in stack if h[2] > mid]
            spans = [h[0] for h in live if h[3]]
            parts = [spans[0]] if spans else ["(no span)"]
            if len(spans) > 1:
                parts.append(spans[-1])
            inner = [h[0] for h in live if not h[3]]
            if inner:
                parts.append(inner[-1][:64])
            elif end in after:
                parts.append("before " + after[end][:64])
            key = " / ".join(parts)
            label[key] = label.get(key, 0) + length
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v / 1e9] for k, v in rank(ops)],
                "idle_gaps": [[k, v / 1e9] for k, v in rank(label)]}


class Tracer:
    """Profiles requests ``after`` .. ``after + count - 1`` of the window
    (none when ``count`` is 0).  ``counters`` returns the program's
    counters, read before and after the stretch; ``on_stop`` runs when
    the stretch ends."""

    def __init__(self, after: int = 0, count: int = 0, device=None,
                 counters: Callable[[], Dict[str, int]] = dict,
                 on_stop: Callable[[], None] = None, host_ops: bool = True):
        self.after, self.count = after, count
        self.device, self.counters = device, counters
        self.on_stop, self.host_ops = on_stop, host_ops
        self.prof = None
        self.record: Optional[TraceRecord] = None
        self.spans: List[Tuple[str, int, int]] = []
        self._c0: Dict[str, int] = {}
        self._c1: Dict[str, int] = {}
        self._done = 0
        self._stopped = None  # the profile of the stretch, once it ended

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def pending(self) -> bool:
        """The stretch is asked for and has not ended: the window goes on
        until it has, so a traced run always traces the whole stretch."""
        return bool(self.count) and self.record is None and \
            self._stopped is None

    def _cuda(self) -> bool:
        import torch

        return (self.device is not None
                and torch.device(self.device).type == "cuda")

    def _sync(self):
        if self._cuda():
            import torch

            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if self._cuda() else []
        if self.host_ops or not acts:
            acts.append(ProfilerActivity.CPU)
        return profile(activities=acts)

    def prime(self) -> None:
        """Start and stop the profiler once before the window: its first
        start (CUPTI's set-up) takes seconds."""
        if self.count:
            with self._profile():
                self._sync()

    def before(self, i: int) -> None:
        if self.count and i == self.after and self.pending:
            self._sync()
            self._c0 = dict(self.counters())
            self.prof = self._profile()
            self.prof.__enter__()

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own while the stretch runs."""
        if not self.active:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def after_request(self, i: int) -> None:
        if self.active:
            self._done += 1
            if self._done >= self.count:
                self.stop()

    def stop(self) -> None:
        """End the stretch (also where the window closed first)."""
        if not self.active:
            return
        self._sync()
        self.prof.__exit__(None, None, None)
        self._c1 = dict(self.counters())
        self._stopped, self.prof = self.prof, None
        if self.on_stop is not None:
            self.on_stop()

    def read(self) -> Optional[TraceRecord]:
        """Parse the stretch's events (after the window)."""
        prof, self._stopped = self._stopped, None
        reqs = [sp for sp in self.spans if sp[0].startswith(SPAN_PREFIX)]
        if prof is None or not reqs:
            return self.record
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            s = _start_ns(e)
            item = (e.name(), s, s + _dur_ns(e))
            if e.is_user_annotation():
                continue
            if e.device_type() == DeviceType.CUDA:
                device.append(item)
            else:
                host.append(item + (e.start_thread_id(),))
        if host:  # the thread that drove the window: the busiest one
            tids = [h[3] for h in host]
            thread = max(set(tids), key=tids.count)
            host = [h[:3] + (False,) for h in host if h[3] == thread]
        self.record = TraceRecord(
            requests=len(reqs),
            window=(min(s for _, s, _ in reqs), max(t for _, _, t in reqs)),
            device_ops=device,
            host=[(n, s, t, True) for n, s, t in self.spans] + host,
            counters={k: self._c1.get(k, 0) - v for k, v in self._c0.items()})
        return self.record
