"""Device kernels a request, counted by the profiler over the traced
requests (copies and sets not counted)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.requests or not run.queries_done:
        return None
    n = len(tr.kernels())
    return n / tr.requests if n else None
