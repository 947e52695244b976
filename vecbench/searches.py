"""The window and the check of a search cell: one client sends requests of
``request_queries`` queries back to back, cycling through a pool of
``pool_batches`` batches made from the seed; a request ends when the
distances and ids are on the host."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .judge import Answer, Verdict, judge
from .session import Context, closed_loop


@dataclass
class SearchState:
    rows: torch.Tensor               # the benchmark's rows (reference side)
    batches: List[torch.Tensor]      # the pool on the device
    host: List[np.ndarray]           # the pool as the system receives it
    search: Optional[Callable]       # host batch -> (distances, ids)
    counters: Callable[[], Dict[str, int]] = dict
    keep: list = field(default_factory=list)  # the program's objects
    answers: List[Answer] = field(default_factory=list)


def pool(ctx: Context):
    """(rows, device batches, host batches) of a search cell."""
    wl = ctx.cell.workload
    rows, qs = ctx.inputs(wl["request_queries"] * wl["pool_batches"])
    batches = list(qs.split(wl["request_queries"]))
    return rows, batches, [b.cpu().numpy() for b in batches]


def warm(ctx: Context, st: SearchState) -> None:
    """Every shape the window uses: the first call (where the program
    builds what it builds lazily), then one pass over the pool."""
    with ctx.phase("first_search"):
        st.search(st.host[0])
    with ctx.phase("warm"):
        for q in st.host[1:]:
            st.search(q)


def window(ctx: Context, st: SearchState, seconds: float) -> None:
    """Requests back to back; the first answer to each pool batch is kept,
    and a sample of the later ones drawn from the seed."""
    first: Dict[int, Answer] = {}
    later: List[Answer] = []
    take = ctx.sampler()
    n_batches = len(st.host)

    def request(i: int) -> int:
        b = i % n_batches
        d, ids = st.search(st.host[b])
        if b not in first:
            first[b] = Answer(b, d, ids)
        elif take():
            later.append(Answer(b, d, ids))
        return len(ids)

    tracer = ctx.tracer(st.counters)
    ctx.run.queries_done = closed_loop(request, seconds, tracer, "request",
                                       ctx.run)
    ctx.run.trace = tracer.read()
    st.answers = list(first.values()) + later


def check(ctx: Context, st: SearchState, exact: bool,
          recall_floor: Optional[float]) -> Verdict:
    """Free the program's state, then judge the window's answers against
    the reference over the whole table."""
    cfg, wl = ctx.cell.config, ctx.cell.workload
    st.keep.clear()
    st.search = None
    ctx.free()
    v = judge(st.answers, st.batches, st.rows, cfg["rows"], wl["k"],
              wl["limits"], exact, recall_floor)
    ctx.run.recall = v.recall
    ctx.run.info["judged_answers"] = len(st.answers)
    return v


def recall_floor(ctx: Context, ef: int) -> float:
    """The recall@10 the configuration states for an HNSW scan at ``ef``."""
    return float(ctx.cell.config["guarantees"]["recall_at_10_floor"][str(ef)])
