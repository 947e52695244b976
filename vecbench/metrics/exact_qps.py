"""Queries answered over the whole window of an exact-search cell, results
on the host (kept apart from the HNSW cells' ``qps``: the exact scan is
device-bound and its runs agree more closely than the host-paced
searches', so it gets a bound of its own)."""

from vecbench.session import queries_per_s


def read(run):
    return queries_per_s(run)
