"""The port's span recorder and counters (``utils/telemetry.py``,
``utils/stats.py``), on the CPU: a span is kept only while the timers are
on or a ``torch.profiler`` session records; spans nest by parent and share
their outermost span's request; the log is bounded and counts what it
drops; ``reset()`` clears the totals and keeps the spans.  The spans are
on the profiler's clock: the aten ops of a search lie inside the stage
that ran them.  ``ScanStats.host_reads`` equals an independent count of
the tensor reads a search or an insert makes, and ``query_hops`` lies
between the layer-0 hop count and queries × hops launched.  One card test
holds the device markers' time under the search's wall time.

This file imports no JAX, so its card test runs on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_telemetry.py
"""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pgvector_tpu_torch import (  # noqa: E402
    DenseTable, HNSWIndex, Metric, config)
from pgvector_tpu_torch.utils import telemetry  # noqa: E402
from pgvector_tpu_torch.utils.telemetry import Timers, timers  # noqa: E402

K, EF = 5, 16


def _nest(t: Timers, reads: int = 0):
    with t.phase("outer"):
        with t.phase("mid"):
            with t.phase("inner"):
                for _ in range(reads):
                    t.host_read("site")


def test_off_records_nothing():
    t = Timers()
    _nest(t, reads=3)
    assert t.spans() == [] and t.report() == {} and t.dropped == 0
    assert t.host_reads == 3  # counted, on no span


def test_parents_and_requests_nest():
    t = Timers()
    t.enabled = True
    _nest(t, reads=2)
    _nest(t)
    spans = t.spans()
    assert [s.name for s in spans] == ["inner", "mid", "outer"] * 2
    for inner, mid, outer in (spans[:3], spans[3:]):
        assert inner.parent is mid and mid.parent is outer
        assert outer.parent is None
        assert inner.request == mid.request == outer.request == outer.number
        assert outer.start_ns <= mid.start_ns <= inner.start_ns
        assert inner.end_ns <= mid.end_ns <= outer.end_ns
        assert inner.under("outer") and not outer.under("inner")
        assert inner.device_ms is None  # not a device span
    assert spans[0].request != spans[3].request
    assert spans[0].counts == {"site": 2} and spans[0].host_reads == 2
    assert spans[1].host_reads == spans[2].host_reads == 0
    assert t.report()["outer"]["count"] == 2


def test_bound_keeps_the_oldest_and_counts_the_dropped():
    t = Timers()
    t.enabled = True
    n = telemetry.SPAN_LOG_MAX
    for i in range(n + 7):
        with t.phase(f"s{i % 3}"):
            pass
    spans = t.spans()
    assert len(spans) == n and t.dropped == 7
    assert spans[0].number == 0 and spans[-1].number == n - 1
    assert t.report()["s0"]["count"] + t.report()["s1"]["count"] + \
        t.report()["s2"]["count"] == n + 7  # the totals count them all
    t.clear_spans()
    assert t.spans() == [] and t.dropped == 0


def test_reset_keeps_the_spans():
    t = Timers()
    t.enabled = True
    _nest(t)
    t.reset()
    assert t.report() == {}
    assert [s.name for s in t.spans()] == ["inner", "mid", "outer"]


def test_recording_follows_a_cpu_profiler_session():
    t = Timers()
    _nest(t)
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.profiling()
        _nest(t, reads=1)
    assert not telemetry.profiling()
    _nest(t)
    spans = t.spans()
    assert [s.name for s in spans] == ["inner", "mid", "outer"]
    assert spans[0].host_reads == 1


def test_threads_keep_their_own_stacks_and_counts():
    """Eight threads nest spans and count reads at once (switching every
    10 µs): no span takes another thread's parent, no span or total is
    lost, and each thread's read count is its own."""
    t = Timers()
    t.enabled = True
    reads = {}

    def work(j):
        for _ in range(100):
            with t.phase(f"root{j}"):
                with t.phase(f"leaf{j}"):
                    t.host_read("x")
        reads[j] = t.host_reads

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(j,)) for j in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = t.spans()
    assert len(spans) == 8 * 200 and t.dropped == 0
    assert sum(v["count"] for v in t.report().values()) == 8 * 200
    assert reads == {j: 100 for j in range(8)}
    for s in spans:
        if s.name.startswith("leaf"):
            assert s.parent.name == "root" + s.name[4:]
            assert s.request == s.parent.number and s.host_reads == 1


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(3)
    table = DenseTable(16, device="cpu")
    table.insert(rng.normal(size=(1500, 16)).astype(np.float32))
    idx = HNSWIndex(table, Metric.L2, m=4, ef_construction=16, seed=1)
    assert idx.entry_level >= 1  # the descent has levels to walk
    return idx, rng.normal(size=(20, 16)).astype(np.float32)


def test_search_spans_on_the_profilers_clock(index):
    """Under a CPU profiler the search's aten ops lie inside its root
    span; the re-rank's TID expansion (``repeat_interleave``) inside
    ``hnsw.search.rerank``, the descent's stop tests (``is_nonzero``)
    inside ``hnsw.search.descent``."""
    idx, q = index
    timers.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx.search(q, K, ef_search=EF)
    spans = {s.name: s for s in timers.spans()}
    assert set(spans) == {"hnsw.search", "hnsw.search.query_in",
                          "hnsw.search.descent", "hnsw.search.layer0",
                          "hnsw.search.rerank"}
    root = spans["hnsw.search"]
    assert all(s.parent is root for n, s in spans.items() if s is not root)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert len(events) > 100

    def inside(name, span):
        found = [(s, e) for n, s, e in events if n == name]
        assert found, name
        return all(span.start_ns <= s and e <= span.end_ns for s, e in found)

    assert all(root.start_ns <= s and e <= root.end_ns
               for _, s, e in events)
    assert inside("aten::repeat_interleave", spans["hnsw.search.rerank"])
    assert inside("aten::is_nonzero", spans["hnsw.search.descent"])
    assert spans["hnsw.search.descent"].counts["descent.moved"] >= 1
    timers.clear_spans()


class _TensorReads:
    """A count of every ``Tensor.item``, ``__bool__``, ``cpu`` and
    ``tolist`` call, independent of the program's own count."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("item", "__bool__", "cpu", "tolist"):
            plain = getattr(torch.Tensor, name)

            def counted(*a, _plain=plain, **kw):
                self.n += 1
                return _plain(*a, **kw)
            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("what", ["search", "iterative", "insert"])
def test_host_reads_equal_an_independent_count(index, monkeypatch, what):
    idx, q = index
    s0 = idx.stats.host_reads
    if what == "insert":  # a second batch: its waves walk upper levels
        table = DenseTable(16, device="cpu")
        rows = np.random.default_rng(4).normal(size=(400, 16))
        table.insert(rows.astype(np.float32))
        idx = HNSWIndex(table, Metric.L2, m=4, ef_construction=16,
                        build=False)
        idx.insert(np.arange(200))
        assert idx.entry_level >= 1
        s0 = idx.stats.host_reads
        reads = _TensorReads(monkeypatch)
        idx.insert(np.arange(200, 400))
    else:
        scan = (config.local(**{"hnsw.iterative_scan": "relaxed_order"})
                if what == "iterative" else contextlib.nullcontext())
        reads = _TensorReads(monkeypatch)
        with scan:
            idx.search(q, K, ef_search=EF)
    monkeypatch.undo()
    assert reads.n > 0
    assert idx.stats.host_reads - s0 == reads.n


@pytest.mark.parametrize("packed", ["f32", "off"])
def test_query_hops_between_steps_and_launches(index, monkeypatch, packed):
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", packed)
    idx, q = index
    h0 = idx.stats.query_hops
    idx.search(q, K, ef_search=EF)
    hops = idx.stats.query_hops - h0
    assert idx._last_scan_steps <= hops <= len(q) * idx._last_scan_launches


@pytest.mark.cuda
def test_device_markers_within_the_search_wall_time():
    """On the card: the descent's, layer 0's and the re-rank's marker ms
    add up to no more than the search's wall ms (the search ends with
    its results on the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    rng = np.random.default_rng(5)
    table = DenseTable(64, device="cuda")
    table.insert(rng.normal(size=(20000, 64)).astype(np.float32))
    idx = HNSWIndex(table, Metric.L2, m=8, ef_construction=32, seed=2)
    q = rng.normal(size=(500, 64)).astype(np.float32)
    idx.search(q, K, ef_search=40)  # the slab and the kernels, built
    timers.clear_spans()
    timers.enabled = True
    try:
        t0 = time.time_ns()
        idx.search(q, K, ef_search=40)
        wall_ms = (time.time_ns() - t0) / 1e6
    finally:
        timers.enabled = False
    spans = {s.name: s for s in timers.spans()}
    stages = [spans[f"hnsw.search.{n}"].device_ms
              for n in ("descent", "layer0", "rerank")]
    assert all(ms is not None and ms > 0 for ms in stages)
    assert sum(stages) <= wall_ms
    root = spans["hnsw.search"]
    assert sum(stages) <= (root.end_ns - root.start_ns) / 1e6
    timers.clear_spans()
