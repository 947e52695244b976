"""Blocking device -> host reads a request: the reads the program counted
on its spans (``telemetry.host_read``: the descent's steps, the beam
loop's every few hops, the hop counts, the results) inside the traced
window, over the traced requests."""

from vecbench import program_spans


def read(run):
    spans = program_spans.in_window(run)
    if not spans:
        return None
    return sum(s.host_reads for s in spans) / run.trace.requests
