"""The program's own spans inside a traced run's window, for the
``program_span`` metrics that read them.

The program (``pgvector_tpu_torch.utils.telemetry``) records its phases as
spans while a ``torch.profiler`` session records, on ``time.time_ns()``:
the clock of the tracer's window.  A span is taken when it started and
ended inside the window.  A program without that recorder gives None, and
the metric is left out of the result line."""

from __future__ import annotations


def in_window(run):
    """The program's spans that started and ended inside the traced
    window, or None where there is no window or no recorder."""
    tr = run.trace
    if tr is None or not tr.requests:
        return None
    try:
        from pgvector_tpu_torch.utils.telemetry import timers
        spans = timers.spans
    except (ImportError, AttributeError):
        return None
    w0, w1 = tr.window
    return [s for s in spans() if w0 <= s.start_ns and s.end_ns <= w1]


def named(run, name: str):
    """The spans called ``name`` in the window, or None where none."""
    spans = in_window(run)
    found = [s for s in spans or () if s.name == name]
    return found or None


def device_ms_per_request(run, name: str):
    """The device ms between the markers of the spans called ``name``, a
    traced request."""
    spans = [s for s in named(run, name) or () if s.device_ms is not None]
    if not spans:
        return None
    return sum(s.device_ms for s in spans) / run.trace.requests


def host_ms_per_request(run, name: str):
    """The host ms of the spans called ``name``, a traced request."""
    spans = named(run, name)
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / run.trace.requests
