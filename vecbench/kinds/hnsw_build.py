"""CREATE INDEX and continuous INSERT into an HNSW index: the window
inserts consecutive batches of the table's rows into an index created
empty, each batch ended by a device sync; when the table is used up it
searches the full index with the clock stopped, drops it and starts a new
one.  Every index the window filled is judged after the window against
the reference over the rows it held: the full ones from the answers kept
at the wrap, the last one searched when the window has closed."""

from __future__ import annotations

import contextlib
import gc
import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from .. import searches
from ..judge import Answer, judge, worst
from ..session import Context, closed_loop

#: the program's phase timers, ended by device syncs in the traced run
PHASE_SYNC = "PGVECTOR_TPU_PHASE_SYNC"


@dataclass
class BuildState:
    rows: torch.Tensor
    query: torch.Tensor      # the check's queries on the device
    host_query: np.ndarray
    rel: object              # the table as a relation
    make: object             # () -> an empty index over the table
    idx: object = None
    held: int = 0            # rows the current index holds
    searched: List["Searched"] = field(default_factory=list)


@dataclass
class Searched:
    """One index's answers to the check's queries, kept for the judge."""
    held: int                # rows the index held
    answer: Answer
    missing: int             # rows inserted that the index does not hold


def setup(ctx: Context) -> BuildState:
    from pgvector_tpu_torch import Metric, Relation

    cfg, wl = ctx.cell.config, ctx.cell.workload
    ix = cfg["index"]
    ctx.load_kernels()
    with ctx.phase("data"):
        rows, qs = ctx.inputs(wl["check_queries"])
        table = ctx.table(rows)
        host_q = qs.cpu().numpy()
    rel = Relation(table)

    def make():
        return rel.create_index(
            "hnsw", Metric.L2, m=ix["m"], ef_construction=ix["ef_construction"],
            wave_size=ix["wave_size"], beam_expand=ix["build_beam"],
            dedup=ix["dedup"], capacity=ix["capacity"],
            seed=ctx.seed % (1 << 63), build=False)

    st = BuildState(rows, qs, host_q, rel, make)
    with ctx.phase("warm"):  # the window's shapes, on an index thrown away
        st.idx = make()
        st.idx.insert(np.arange(wl["batch_rows"], dtype=np.int64))
        drop(st)
    return st


def drop(st: BuildState) -> None:
    """DROP INDEX."""
    st.rel.drop_index(st.idx)
    st.idx, st.held = None, 0


@contextlib.contextmanager
def _phases_as_spans(tracer):
    """The program's phase timers on, each phase also a span of the
    tracer's (what the host was doing, in the trace)."""
    from pgvector_tpu_torch.utils.telemetry import timers

    plain = timers.phase

    @contextlib.contextmanager
    def phase(name):
        with tracer.span(name), plain(name):
            yield

    timers.reset()
    timers.enabled = True
    timers.phase = phase
    try:
        yield timers
    finally:
        del timers.phase
        timers.enabled = False
        os.environ.pop(PHASE_SYNC, None)


def _sync_phases_from_now() -> None:
    """After the profiled stretch: each phase ended by a device sync, so
    the timers split the rest of the window as the device does (the
    stretch itself ran unsynchronized, as the untraced build does)."""
    from pgvector_tpu_torch.utils.telemetry import timers

    os.environ[PHASE_SYNC] = "1"
    timers.reset()


def search_index(ctx: Context, st: BuildState) -> None:
    """Search the current index (the configuration's query beam, the
    workload's ef), keep its answers and its missing rows, and drop it."""
    wl, ix = ctx.cell.workload, ctx.cell.config["index"]
    idx = st.idx
    idx.beam_expand = ix["query_beam"]
    d, ids = idx.search(st.host_query, wl["k"], ef_search=wl["ef_search"])
    st.searched.append(Searched(st.held, Answer(0, d, ids),
                                st.held - idx.live_elements))
    drop(st)


def check_full_index(ctx: Context, st: BuildState) -> None:
    """In the window, with the clock stopped: search the full index and
    drop it.  The packed slab that the search makes is the check's, not
    the build's: the device's peak is kept from before it and counted
    anew once the index is gone."""
    t = time.perf_counter()
    if ctx.cuda:
        ctx.run.peak_bytes = max(ctx.run.peak_bytes,
                                 torch.cuda.max_memory_allocated(ctx.device))
    search_index(ctx, st)
    gc.collect()
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    ctx.run.paused_s += time.perf_counter() - t


def window(ctx: Context, st: BuildState, seconds: float) -> None:
    wl, n = ctx.cell.workload, ctx.cell.config["rows"]
    batch = int(wl["batch_rows"])

    def request(i: int) -> int:
        if st.idx is not None and st.held >= n:  # the table used up
            check_full_index(ctx, st)
        if st.idx is None:
            st.idx = st.make()
        end = min(st.held + batch, n)
        st.idx.insert(np.arange(st.held, end, dtype=np.int64))
        ctx.sync()
        done, st.held = end - st.held, end
        return done

    tracer = ctx.tracer(on_stop=_sync_phases_from_now)
    with (_phases_as_spans(tracer) if ctx.traced
          else contextlib.nullcontext()) as timers:
        ctx.run.rows_done = closed_loop(request, seconds, tracer,
                                        "insert_batch", ctx.run)
        if timers is not None:
            ctx.run.timers = timers.report()
    ctx.run.trace = tracer.read()


def check(ctx: Context, st: BuildState):
    """Search the index the window left, free it, then judge every index
    the window filled over the rows each held; each number is its worst
    over them."""
    wl = ctx.cell.workload
    search_index(ctx, st)
    st.rel = st.make = None
    ctx.free()
    floor = searches.recall_floor(ctx, wl["ef_search"])
    verdicts = []
    for s in st.searched:
        v = judge([s.answer], [st.query], st.rows, s.held, wl["k"],
                  wl["limits"], exact=False, recall_floor=floor)
        v.hold("missing_rows", s.missing, "<=", 0)
        verdicts.append(v)
    v = worst(verdicts)
    ctx.run.recall = v.recall
    ctx.run.info["rows_held"] = [s.held for s in st.searched]
    ctx.run.info["recall_by_index"] = [u.recall for u in verdicts]
    ctx.run.info["paused_s"] = ctx.run.paused_s
    return v
