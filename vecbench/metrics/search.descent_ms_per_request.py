"""Device ms a request of the entry point's score and the greedy descent
over the upper levels: the time between the CUDA event markers of the
program's ``hnsw.search.descent`` spans inside the traced window, over
the traced requests."""

from vecbench import program_spans

SPAN = "hnsw.search.descent"


def read(run):
    return program_spans.device_ms_per_request(run, SPAN)
