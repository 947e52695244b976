"""Device ms a request of the layer-0 beam search (a K2 launch a hop): the
time between the CUDA event markers of the program's
``hnsw.search.layer0`` spans inside the traced window, over the traced
requests."""

from vecbench import program_spans

SPAN = "hnsw.search.layer0"


def read(run):
    return program_spans.device_ms_per_request(run, SPAN)
