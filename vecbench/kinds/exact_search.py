"""Batch exact k-NN with no index (``SELECT ... ORDER BY v <-> q LIMIT k``
as a sequential scan): ``FlatIndex`` over the table."""

from __future__ import annotations

from .. import searches
from ..session import Context


def _counters():
    from pgvector_tpu_torch.ops.fused_topk import fused_topk

    return {"fused_topk": fused_topk.launches}


def setup(ctx: Context) -> searches.SearchState:
    from pgvector_tpu_torch import FlatIndex, Metric

    k = ctx.cell.workload["k"]
    ctx.load_kernels()
    with ctx.phase("data"):
        rows, batches, host = searches.pool(ctx)
        table = ctx.table(rows)
    flat = FlatIndex(table, Metric.L2)

    def search(q):
        return flat.search(q, k)

    st = searches.SearchState(rows, batches, host, search, _counters,
                              keep=[flat, table])
    searches.warm(ctx, st)
    ctx.run.info["route"] = flat.last_path
    return st


def window(ctx: Context, st: searches.SearchState, seconds: float) -> None:
    searches.window(ctx, st, seconds)


def check(ctx: Context, st: searches.SearchState):
    return searches.check(ctx, st, exact=True, recall_floor=None)
