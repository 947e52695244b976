"""The share of the reference's exact top-10 that the first answer to each
batch of the query pool holds, over the whole pool (computed by the
benchmark from the answers after the window)."""


def read(run):
    if run.recall is None or run.cell.workload.get("k") != 10:
        return None
    return run.recall
