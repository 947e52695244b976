"""Host ms a request from the search's entry until the queries are on the
card (their coercion to f32 on the host and the copy): the program's
``hnsw.search.query_in`` spans inside the traced window, over the traced
requests."""

from vecbench import program_spans

SPAN = "hnsw.search.query_in"


def read(run):
    return program_spans.host_ms_per_request(run, SPAN)
