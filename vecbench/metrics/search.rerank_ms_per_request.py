"""Device ms a request of the f32 re-rank of the final pool and the heap-
TID expansion: the time between the CUDA event markers of the program's
``hnsw.search.rerank`` spans inside the traced window, over the traced
requests."""

from vecbench import program_spans

SPAN = "hnsw.search.rerank"


def read(run):
    return program_spans.device_ms_per_request(run, SPAN)
