"""The share of the traced stretch of an index-build window in which no
operation ran on the device: 1 - (union of the device's operation
intervals / the stretch), from the profiler."""


def read(run):
    tr = run.trace
    return tr.idle_pct if tr is not None and run.rows_done else None
