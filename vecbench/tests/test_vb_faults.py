"""A whole run, with the look for a card skipped and the timed path broken
underneath, comes out as not correct; so does the control.  Each cell is
cut to a size the CPU runs (conftest.tiny_cell); a sound run of it comes
out correct."""

import time

import numpy as np
import pytest

from vecbench.control import control
from vecbench.run import execute

CELLS = ["sift1m.hnsw.ef40", "gist960.hnsw.ef40", "sift1m.exact",
         "sift1m.build"]


def run_cell(cell, seed=2**31 + 5):
    result, _, _ = execute(cell, seed, 0.3, False, "cpu",
                           t0=time.perf_counter())
    return result


def _searcher(kind):
    from pgvector_tpu_torch import FlatIndex, HNSWIndex

    return FlatIndex if kind == "exact_search" else HNSWIndex


def state_unchanged(mp, kind):
    """A step that hands back its state unchanged: no beam hop moves the
    pool; the exact scan's fold keeps its empty lists; an insert wave
    leaves the graph as it was."""
    from pgvector_tpu_torch.index import hnsw, hnsw_kernels
    from pgvector_tpu_torch.ops import fused_topk as k1

    if kind == "exact_search":
        def fold_nothing(qs, db, dbsq, k):
            d, i = k1.fused_topk_plain(qs, db, dbsq, k)
            return d.fill_(float("inf")), i.fill_(-1)
        mp.setattr(k1, "fused_topk", fold_nothing)
    elif kind == "hnsw_build":
        mp.setattr(hnsw.HNSWIndex, "_insert_wave", lambda self, e, lv: None)
    else:
        plain = hnsw_kernels.search_layer

        def no_hop(*a, **kw):
            kw["max_steps"] = 0
            return plain(*a, **kw)
        mp.setattr(hnsw_kernels, "search_layer", no_hop)


def half_left_out(mp, kind):
    """Half of each request left out: the second half of a search's
    queries answered with nothing; half of each insert batch dropped."""
    if kind == "hnsw_build":
        from pgvector_tpu_torch import HNSWIndex

        plain = HNSWIndex.insert
        mp.setattr(HNSWIndex, "insert",
                   lambda self, rows: plain(self, rows[: len(rows) // 2]))
        return
    cls = _searcher(kind)
    plain = cls.search

    def half(self, q, k, *a, **kw):
        d, i = plain(self, q[: len(q) // 2], k, *a, **kw)
        pad = len(q) - len(d)
        return (np.concatenate([d, np.full((pad, k), np.inf, d.dtype)]),
                np.concatenate([i, np.full((pad, k), -1, i.dtype)]))
    mp.setattr(cls, "search", half)


def answer_altered(mp, kind):
    """One id of each answer altered where it is produced."""
    cls = _searcher("hnsw_search" if kind == "hnsw_build" else kind)
    plain = cls.search

    def altered(self, q, k, *a, **kw):
        d, i = plain(self, q, k, *a, **kw)
        i = i.copy()
        i[len(i) // 2, 3] += 1
        return d, i
    mp.setattr(cls, "search", altered)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny, name):
    result = run_cell(tiny(name))
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny, monkeypatch, name, fault):
    cell = tiny(name)
    fault(monkeypatch, cell.workload["kind"])
    result = run_cell(cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    """The reference one precision step below the column's, in the
    program's place (tf32 for f32 rows, bf16 for fp16 rows)."""
    cell = tiny(name, dim=96 if name.startswith("gist") else 16)
    for seed in (1, 2, 2**31 + 9):
        out = control(cell, seed, "cpu")
        assert out["correct"] is False, out
        assert out["checks"]["dist_err"]["value"] > \
            out["checks"]["dist_err"]["limit"]


def first_index_half_left_out(mp):
    """Half of each insert batch dropped in the first index the window
    fills (the second one made: set-up warms up on one of its own), and
    in no later one."""
    from pgvector_tpu_torch import HNSWIndex

    plain, seen = HNSWIndex.insert, []

    def insert(self, rows):
        if self not in seen:
            seen.append(self)
        if len(seen) > 1 and self is seen[1]:
            rows = rows[: len(rows) // 2]
        return plain(self, rows)
    mp.setattr(HNSWIndex, "insert", insert)


@pytest.mark.parametrize("fault", [None, first_index_half_left_out],
                         ids=["sound", "first_index_half_left_out"])
def test_build_judges_every_index_it_filled(tiny, monkeypatch, fault):
    """A window long enough to use the table up and start again judges the
    full index as well as the last one."""
    cell = tiny("sift1m.build", rows=512)
    cell.workload["batch_rows"] = 256
    if fault is not None:
        fault(monkeypatch)
    # 3 s, so that a busy CPU still uses the table up inside the window
    result, _, ctx = execute(cell, 2**31 + 7, 3.0, False, "cpu",
                             t0=time.perf_counter())
    held = ctx.run.info["rows_held"]
    assert len(held) >= 2 and held[0] == 512, held
    assert ctx.run.paused_s > 0
    assert result["correct"] is (fault is None), result["checks"]
