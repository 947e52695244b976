"""Batch k-NN through an HNSW index built in set-up (CREATE INDEX ...
USING hnsw, then ``SELECT ... ORDER BY v <-> q LIMIT k`` for a batch of
queries at ``hnsw.ef_search``)."""

from __future__ import annotations

from .. import searches
from ..session import Context


def setup(ctx: Context) -> searches.SearchState:
    from pgvector_tpu_torch import Metric, Relation
    from pgvector_tpu_torch.ops.packed_hop import packed_hop

    cfg, wl = ctx.cell.config, ctx.cell.workload
    ix = cfg["index"]
    ctx.load_kernels()
    with ctx.phase("data"):
        rows, batches, host = searches.pool(ctx)
        table = ctx.table(rows)
    with ctx.phase("index_build"):
        rel = Relation(table)
        idx = rel.create_index(
            "hnsw", Metric.L2, m=ix["m"], ef_construction=ix["ef_construction"],
            wave_size=ix["wave_size"], beam_expand=ix["build_beam"],
            dedup=ix["dedup"], capacity=ix["capacity"],
            seed=ctx.seed % (1 << 63))
    idx.beam_expand = ix["query_beam"]
    k, ef = wl["k"], wl["ef_search"]

    def search(q):
        return idx.search(q, k, ef_search=ef)

    st = searches.SearchState(rows, batches, host, search,
                              keep=[rel, idx, table])
    searches.warm(ctx, st)
    # which slab K2 read (the configuration's "auto" pick)
    ctx.run.info["k2_launches_by_slab"] = dict(packed_hop.launches_by_slab)
    return st


def window(ctx: Context, st: searches.SearchState, seconds: float) -> None:
    searches.window(ctx, st, seconds)


def check(ctx: Context, st: searches.SearchState):
    return searches.check(ctx, st, exact=False, recall_floor=searches
                          .recall_floor(ctx, ctx.cell.workload["ef_search"]))
