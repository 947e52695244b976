"""Queries answered over the whole window of an HNSW search cell, results
on the host."""

from vecbench.session import queries_per_s


def read(run):
    return queries_per_s(run)
