"""The ``program_span`` readers of the program's own spans
(``vecbench/program_spans.py``), on a synthetic run and span log: a span
counts only where it started and ended inside the traced window, a
search metric is a sum over the traced requests, the build's a sum over
the ``hnsw.wave`` spans in the window, and each reads None where the
window holds no span, where there is no trace, and where the program
has no span recorder."""

import pytest

from vecbench import spec
from vecbench.session import Run
from vecbench.trace import TraceRecord

W0, W1 = 1_000_000, 9_000_000  # the traced window, ns


class _Log:
    """A recorder holding a given span log."""

    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return list(self._spans)


def _span(name, start, end, parent=None, reads=0, device_ms=None):
    from pgvector_tpu_torch.utils.telemetry import Span

    s = Span(name, 0, parent)
    s.start_ns, s.end_ns = start, end
    if reads:
        s.counts["site"] = reads
    s.device_ms = device_ms
    return s


def _run(requests=4, cell="sift1m.hnsw.ef40"):
    run = Run(spec.load_cell(cell))
    run.trace = TraceRecord(requests=requests, window=(W0, W1),
                            device_ops=[], host=[])
    return run


def _search_log():
    """Two requests inside the window and one before it and one after;
    then a span of each stage that starts before the window and ends in
    it, and one that ends after it.  Only the first two requests count."""
    log = []
    for t0, t1 in ((2_000_000, 3_000_000), (4_000_000, 6_000_000),
                   (0, 900_000), (9_100_000, 9_900_000)):
        root = _span("hnsw.search", t0, t1, reads=2)
        step = (t1 - t0) // 5
        log += [root,
                _span("hnsw.search.query_in", t0, t0 + step, root),
                _span("hnsw.search.descent", t0 + step, t0 + 2 * step, root,
                      reads=10, device_ms=1.5),
                _span("hnsw.search.layer0", t0 + 2 * step, t0 + 3 * step,
                      root, reads=5, device_ms=4.0),
                _span("hnsw.search.rerank", t0 + 3 * step, t0 + 4 * step,
                      root, device_ms=2.5)]
    for t0, t1 in ((900_000, 1_100_000), (8_900_000, 9_100_000)):
        log += [_span(name, t0, t1, reads=50, device_ms=100.0)
                for name in ("hnsw.search", "hnsw.search.query_in",
                             "hnsw.search.descent", "hnsw.search.layer0",
                             "hnsw.search.rerank")]
    return log


# the value of each search metric over the two requests in the window,
# divided by the trace's 4 requests
SEARCH = {"search.host_reads_per_request": 2 * (2 + 10 + 5) / 4,
          "search.descent_ms_per_request": 2 * 1.5 / 4,
          "search.layer0_ms_per_request": 2 * 4.0 / 4,
          "search.rerank_ms_per_request": 2 * 2.5 / 4,
          "search.query_in_ms_per_request": (0.2 + 0.4) / 4}


@pytest.fixture
def program(monkeypatch):
    from pgvector_tpu_torch.utils import telemetry

    def use(spans):
        monkeypatch.setattr(telemetry, "timers", _Log(spans))
    return use


@pytest.mark.parametrize("metric", sorted(SEARCH))
def test_search_readers(program, metric):
    read = spec.reader(metric).read
    program(_search_log())
    assert read(_run()) == pytest.approx(SEARCH[metric])
    assert read(_run(requests=2)) == pytest.approx(2 * SEARCH[metric])
    program([])
    assert read(_run()) is None
    program(_search_log())
    run = _run()
    run.trace = None
    assert read(run) is None


def test_device_readers_need_markers(program):
    """A span without device markers (a CPU run) gives no device ms."""
    log = _search_log()
    for s in log:
        s.device_ms = None
    program(log)
    for stage in ("descent", "layer0", "rerank"):
        assert spec.reader(f"search.{stage}_ms_per_request").read(
            _run()) is None


def test_build_reads_per_wave(program):
    read = spec.reader("build.host_reads_per_wave").read
    log = []
    for t0 in (2_000_000, 5_000_000, 8_800_000):  # the last one ends late
        wave = _span("hnsw.wave", t0, t0 + 1_000_000, reads=1)
        search = _span("hnsw.wave.search", t0, t0 + 400_000, wave, reads=6)
        connect = _span("hnsw.wave.connect", t0 + 400_000, t0 + 900_000,
                        wave)
        log += [wave, search, connect,
                _span("hnsw.connect.backlinks", t0 + 500_000, t0 + 800_000,
                      connect, reads=1)]
    # reads outside any wave do not count
    log.append(_span("hnsw.dedup_keys", 1_200_000, 1_300_000, reads=3))
    program(log)
    run = _run(requests=2, cell="sift1m.build")
    assert read(run) == pytest.approx((1 + 6 + 1) * 2 / 2)
    program([log[-1]])
    assert read(run) is None


@pytest.mark.parametrize("metric",
                         sorted(SEARCH) + ["build.host_reads_per_wave"])
def test_no_recorder_reads_none(monkeypatch, metric):
    """A program without the recorder (an older checkout): None, no
    error."""
    from pgvector_tpu_torch.utils import telemetry

    monkeypatch.setattr(telemetry, "timers", object())
    assert spec.reader(metric).read(_run()) is None
