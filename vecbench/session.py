"""One run of one cell: its set-up phases, its window, and what the metric
readers and the judge read afterwards."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import data
from .spec import Cell
from .trace import SPAN_PREFIX, TraceRecord, Tracer


@dataclass
class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""
    cell: Cell
    trace: Optional[TraceRecord] = None
    setup: Dict[str, float] = field(default_factory=dict)  # phase -> s
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)  # per request
    queries_done: int = 0     # queries answered in the window
    rows_done: int = 0        # rows indexed in the window
    attempted: int = 0        # requests (or insert batches) in the window
    recall: Optional[float] = None
    paused_s: float = 0.0     # window time spent checking, left out of it
    peak_bytes: int = 0       # the device's peak before a check reset it
    timers: Dict[str, dict] = field(default_factory=dict)  # program phases
    info: Dict[str, object] = field(default_factory=dict)  # shapes, routes


def queries_per_s(run: Run):
    """Queries answered over the whole window, or None where there were
    none (a build)."""
    if not run.queries_done or run.window_s <= 0:
        return None
    return run.queries_done / run.window_s


def p95_ms(run: Run):
    """The 95th percentile of every request's latency in the window (linear
    interpolation between order statistics), or None for a build."""
    if not run.queries_done or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3


class Context:
    """A run in progress: the cell, the seed, the device, the clock the
    set-up is measured from, and the run's record."""

    def __init__(self, cell: Cell, seed: int, device, t0: float,
                 trace: bool = False):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.t0, self.traced = t0, trace
        self.run = Run(cell)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one set-up phase, ended by a device sync."""
        t = time.perf_counter()
        yield
        self.sync()
        self.run.setup[name] = time.perf_counter() - t

    def tracer(self, counters: Callable[[], Dict[str, int]] = dict,
               on_stop: Callable[[], None] = None) -> Tracer:
        """The traced run's tracer (primed), or one that traces nothing."""
        if not self.traced:
            return Tracer()
        tr = self.cell.workload["trace"]
        t = Tracer(int(tr["after"]), int(tr["count"]), self.device, counters,
                   on_stop, bool(tr.get("host_ops", True)))
        t.prime()
        return t

    def load_kernels(self) -> None:
        """Build or load the program's kernel library (a set-up phase of
        its own: the first run in a checkout compiles it)."""
        if not self.cuda:
            return
        from pgvector_tpu_torch.ops import _cuda

        with self.phase("kernels"):
            _cuda.lib()
        self.run.info["nvcc_s"] = _cuda.build_seconds

    def inputs(self, nq: int):
        """(rows, queries) of the cell's configuration, on the device."""
        cfg = self.cell.config
        gen = cfg["data"]
        return data.make_data(cfg["rows"], nq, cfg["dim"], self.seed,
                              self.device, data.torch_dtype(cfg["dtype"]),
                              gen["centers"], gen["center_scale"],
                              gen["centers_seed"])

    def table(self, rows: torch.Tensor):
        """The program's table holding ``rows``, handed over as host
        arrays, as a client's COPY would."""
        from pgvector_tpu_torch import DenseTable

        cfg = self.cell.config
        t = DenseTable(cfg["dim"], dtype=data.torch_dtype(cfg["dtype"]),
                       capacity=cfg["rows"], device=self.device)
        t.insert(rows.cpu().numpy())
        return t

    def sampler(self):
        """Which later requests of the window are judged beside the first
        answer to each batch: a draw from the seed."""
        wl = self.cell.workload
        rng = np.random.default_rng(self.seed % (1 << 63))
        rate, cap = float(wl["judge_rate"]), int(wl["judge_max"])
        taken = [0]

        def take() -> bool:
            if taken[0] < cap and rng.random() < rate:
                taken[0] += 1
                return True
            return False

        return take

    def free(self) -> None:
        import gc

        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def closed_loop(request: Callable[[int], int], seconds: float,
                tracer: Tracer, span: str, run: Run) -> int:
    """One client: ``request(i)`` back to back, each started only before
    the deadline, so the window closes at the first request boundary after
    ``seconds`` (in a traced run, not before the traced stretch has
    ended).  ``request`` returns the units (queries, rows) it completed;
    returns their sum.  The window runs from the first request's start to
    the last one's end.  Time a request spends checking the system, which
    it adds to ``run.paused_s``, is left out of its latency and of the
    window, and moves the deadline by as much."""
    lat = run.latencies_s
    start = time.perf_counter()
    end, i, units = start, 0, 0
    while (i == 0 or tracer.pending
           or time.perf_counter() < start + seconds + run.paused_s):
        tracer.before(i)
        t0, p0 = time.perf_counter(), run.paused_s
        with tracer.span(SPAN_PREFIX + span):
            units += request(i)
        end = time.perf_counter()
        tracer.after_request(i)
        lat.append(end - t0 - (run.paused_s - p0))
        i += 1
    tracer.stop()
    run.attempted = i
    run.window_s = end - start - run.paused_s
    return units
