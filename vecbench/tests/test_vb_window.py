"""The window's arithmetic: a rate over the whole window, a 95th
percentile over every request, and a stall inside the window moving both;
the traced stretch's busy and idle time."""

import time

import numpy as np
import pytest

from vecbench import spec
from vecbench.session import Run, closed_loop
from vecbench.trace import TraceRecord, Tracer, kernel_base


def _window(delays, seconds):
    cell = spec.load_cell("sift1m.exact")
    run = Run(cell)

    def request(i):
        time.sleep(delays(i))
        return 100

    run.queries_done = closed_loop(request, seconds, Tracer(), "request",
                                   run)
    return run


def _qps(run):
    return spec.reader("qps").read(run)


def _p95(run):
    return spec.reader("p95_ms").read(run)


def test_rate_and_tail_over_the_whole_window():
    run = _window(lambda i: 0.004, 0.4)
    assert run.attempted == len(run.latencies_s) >= 40
    assert run.window_s >= 0.4
    assert run.window_s == pytest.approx(sum(run.latencies_s), rel=0.05)
    assert _qps(run) == pytest.approx(run.attempted * 100 / run.window_s)
    assert 4.0 <= _p95(run) < 8.0
    assert _p95(run) == pytest.approx(
        np.percentile(run.latencies_s, 95) * 1e3)


def test_a_stall_moves_both():
    steady = _window(lambda i: 0.004, 0.4)
    # every tenth request stalls for 40 ms: the stalls hold 10 % of the
    # requests, so the 95th percentile lands on them, and the rate falls
    stalled = _window(lambda i: 0.04 if i % 10 == 5 else 0.004, 0.4)
    assert _qps(stalled) < 0.75 * _qps(steady)
    assert _p95(stalled) > 30.0 > _p95(steady)


def test_a_check_inside_the_window_is_left_out():
    """A request that checks the system for 40 ms (every tenth) adds it to
    ``paused_s``: neither its latency, the window nor the deadline holds
    it, so the rate and the tail are those of the steady window."""
    steady = _window(lambda i: 0.004, 0.4)
    cell = spec.load_cell("sift1m.exact")
    run = Run(cell)

    def request(i):
        if i % 10 == 5:
            t = time.perf_counter()
            time.sleep(0.04)
            run.paused_s += time.perf_counter() - t
        time.sleep(0.004)
        return 100

    run.queries_done = closed_loop(request, 0.4, Tracer(), "request", run)
    assert run.paused_s >= 0.04 * (run.attempted // 10)
    assert run.window_s == pytest.approx(0.4, abs=0.05)
    assert _qps(run) == pytest.approx(_qps(steady), rel=0.2)
    assert _p95(run) < 8.0


def test_window_closes_at_the_first_boundary_after_the_deadline():
    run = _window(lambda i: 0.05, 0.12)
    assert run.attempted == 3  # started at 0, 50 and 100 ms
    assert run.window_s >= 0.15


def test_trace_record_busy_and_gaps():
    tr = TraceRecord(
        requests=2, window=(0, 1000),
        device_ops=[("void k1<float>(int)", 100, 300),
                    ("k2(int)", 250, 400),
                    ("Memcpy HtoD (Pageable -> Device)", 600, 700),
                    ("k3", 950, 1200)],
        host=[("vb.request", 0, 560, True), ("aten::item", 420, 540, False),
              ("vb.request", 560, 1000, True),
              ("cudaStreamSynchronize", 700, 950, False)])
    assert tr.busy_s == pytest.approx((300 + 100 + 50) / 1e9)
    assert tr.idle_gaps() == [(0, 100), (400, 600), (700, 950)]
    assert len(tr.kernels()) == 3 and tr.kernel_s({"k1"}) == 200 / 1e9
    b = tr.breakdown()
    gaps = dict(b["idle_gaps"])
    assert gaps["vb.request / cudaStreamSynchronize"] == pytest.approx(2.5e-7)
    assert gaps["vb.request / aten::item"] == pytest.approx(2e-7)
    assert gaps["vb.request / before k1"] == pytest.approx(1e-7)
    assert b["device_ops"][0][0] == "void k1<float>"


def test_kernel_base():
    assert kernel_base("void ns::packed_hop_kernel<float, 0, 1>(HopArgs)") \
        == "packed_hop_kernel"
    assert kernel_base("topk_pass1(CUtensorMap, float const*)") == \
        "topk_pass1"
    assert kernel_base("Memset (Device)") == "Memset"
