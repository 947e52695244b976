"""Rows indexed over the whole window (CREATE INDEX / INSERT into an HNSW
index, each batch ended by a device sync)."""


def read(run):
    if not run.rows_done or run.window_s <= 0:
        return None
    return run.rows_done / run.window_s
