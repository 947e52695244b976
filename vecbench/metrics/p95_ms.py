"""The 95th percentile of every request's latency in the window of an HNSW
search cell, from send to ids on the host."""

from vecbench.session import p95_ms


def read(run):
    return p95_ms(run)
