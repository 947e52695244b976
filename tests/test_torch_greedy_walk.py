"""K7's plain version (``ops/greedy_walk.greedy_walk_plain``, the greedy
ef=1 descent over the upper levels) and the searches that take it, on the
CPU.

- Against the reference: a graph built by the JAX package (m = 4, so
  several upper levels), walked by the reference's ``greedy_descent`` a
  level at a time over its ``_neighbors_closure`` and by the plain walk
  over the raw tables (``nbr_up``, ``up_slot``), for L2, inner product and
  L1, f32, bf16 and f16 values, one level or all of them.
- Edge cases on a small hand-made graph: elements with no upper slot, -1
  ids in a list (a whole list of them, and one in front), a NaN distance
  (the walk stops where the reference's argmin takes it), the
  ``max_steps`` cap reached on a chain; ids at or past the value table's
  rows count as -1.
- ``query_search``, ``query_search_first`` and ``wave_search`` give what
  they gave with the per-level ``greedy_descent`` loop in place of K7.

Ids must match exactly, distances within ``torch_parity``'s ATOL / RTOL.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import Metric  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.ops import greedy_walk as TG  # noqa: E402
from torch_hnsw_pairs import reference_state  # noqa: E402
from torch_parity import ATOL, RTOL  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


@pytest.fixture(scope="module")
def graph():
    """A reference-built graph over 1,200 x 16 rows with m = 4, and 48
    queries: the arrays as torch tensors and as numpy."""
    rng = np.random.default_rng(17)
    db = rng.normal(size=(1200, 16)).astype(np.float32)
    jt = JTable(16)
    jt.insert(db)
    ref = JHNSW(jt, JMetric.L2, m=4, ef_construction=16, wave_size=256,
                beam_expand=4, dedup=False)
    arrays, meta = reference_state(ref)
    assert meta["entry_level"] >= 3
    qs = rng.normal(size=(48, 16)).astype(np.float32) * 1.5
    return dict(db=db, qs=qs, nbr0=np.array(arrays["nbr0"]),
                nbr_up=np.array(arrays["nbr_up"]),
                up_slot=np.array(arrays["up_slot"]),
                entry=meta["entry"], entry_level=meta["entry_level"])


def _reference_walk(vals, nbr0, nbr_up, up_slot, qs, cur, metric, hi, lo,
                    max_steps=512):
    """The reference's descent: its scorer's distance at ``cur``, then
    ``greedy_descent`` a level at a time over ``_neighbors_closure``."""
    jscore = JK.make_scorer("dense", JMetric[metric], (jnp.asarray(vals),))
    jnbrs = JK._neighbors_closure(jnp.asarray(nbr0), jnp.asarray(nbr_up),
                                  jnp.asarray(up_slot))
    jq, jcur = jnp.asarray(qs), jnp.asarray(cur)
    jd = jscore(jq, jcur[:, None])[:, 0]
    for lc in range(hi, lo - 1, -1):
        jcur, jd = JK.greedy_descent(jscore, jnbrs, jq, jcur, jd, lc,
                                     nbr_up.shape[2], max_steps)
    return np.asarray(jcur), np.asarray(jd)


def _plain_walk(vals, nbr_up, up_slot, qs, cur, metric, hi, lo,
                max_steps=512):
    tv = vals if torch.is_tensor(vals) else torch.from_numpy(vals)
    tq = torch.from_numpy(qs)
    tcur = torch.from_numpy(np.asarray(cur, np.int32))
    score = TK.make_scorer("dense", Metric[metric], tv)
    td = score(tq, tcur[:, None])[:, 0]
    return TG.greedy_walk_plain(
        tv, torch.from_numpy(nbr_up), torch.from_numpy(up_slot), tq, tcur,
        td, hi, lo, Metric[metric], max_steps)


def _assert_same_walk(want, got):
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("levels", ["top", "all"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("metric", ["L2", "IP", "L1"])
def test_greedy_walk_plain_matches_reference(graph, metric, dtype, levels):
    """The plain walk over the raw upper tables ends where the reference's
    per-level ``lax.while_loop`` walk ends, from the entry point, over the
    top level or every upper level; values rounded to the type first (both
    widen them exactly), and the wrapper routes CPU tensors to it."""
    tv = torch.from_numpy(graph["db"]).to(DTYPES[dtype])
    vals = tv.float().numpy()
    hi = graph["entry_level"]
    lo = hi if levels == "top" else 1
    cur = np.full(len(graph["qs"]), graph["entry"], np.int32)
    want = _reference_walk(vals, graph["nbr0"], graph["nbr_up"],
                           graph["up_slot"], graph["qs"], cur, metric, hi, lo)
    got = _plain_walk(tv, graph["nbr_up"], graph["up_slot"], graph["qs"],
                      cur, metric, hi, lo)
    _assert_same_walk(want, got)
    # queries moved: a few on the top level alone, most over all of them
    assert (want[0] != cur).sum() >= (4 if levels == "top" else len(cur) // 2)
    tq = torch.from_numpy(graph["qs"])
    score = TK.make_scorer("dense", Metric[metric], tv)
    start = torch.from_numpy(cur)
    routed = TG.greedy_walk(tv, torch.from_numpy(graph["nbr_up"]),
                            torch.from_numpy(graph["up_slot"]), tq, start,
                            score(tq, start[:, None])[:, 0], hi, lo,
                            Metric[metric])
    assert torch.equal(routed[0], got[0]) and torch.equal(routed[1], got[1])


def _small_graph():
    """A hand-made 2-level graph of 64 elements (8 dims, m = 4): a chain
    0 -> 1 -> ... along the first axis on level 1, element 40 without an
    upper slot, element 41's level-1 list all -1 and element 42's with -1
    in front, row 50 NaN; queries far along the chain."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(64, 8)).astype(np.float32) * 0.1
    vals[:32, 0] = np.arange(32, dtype=np.float32)
    nbr_up = rng.integers(0, 64, size=(64, 2, 4)).astype(np.int32)
    nbr_up[:31, 0] = -1
    nbr_up[np.arange(31), 0, 1] = np.arange(1, 32)  # the chain, at slot 1
    up_slot = np.arange(64, dtype=np.int32)
    up_slot[40] = -1
    nbr_up[41, 0] = -1
    nbr_up[42, 0, 0] = -1
    vals[50] = np.nan
    nbr0 = np.full((64, 8), -1, np.int32)  # the closure's 2m width
    qs = rng.normal(size=(6, 8)).astype(np.float32) * 0.1
    qs[:, 0] = 100.0
    return vals, nbr0, nbr_up, up_slot, qs


@pytest.mark.parametrize("case", ["no_slot", "minus_one", "nan", "cap"])
@pytest.mark.parametrize("metric", ["L2", "L1"])
def test_greedy_walk_plain_edge_cases(metric, case):
    """Edge cases against the reference's walk: a start with no upper slot
    (no list: it stays) and a chain into one; a list of -1 only and one
    with -1 in front; a NaN among a list's distances (the reference's
    argmin takes it first, so the query stops); the step cap, three moves
    along the chain."""
    vals, nbr0, nbr_up, up_slot, qs = _small_graph()
    max_steps, hi = 512, 1
    if case == "no_slot":
        cur = np.array([40, 40, 29, 30, 0, 5], np.int32)
        nbr_up[30, 0, 1] = 40  # the chain's end leads to no slot
        vals[40, 0] = 35.0
        nbr_up[:, 1] = -1
        hi = 2
    elif case == "minus_one":
        cur = np.array([41, 42, 42, 41, 20, 0], np.int32)
        nbr_up[42, 0, 1:] = [0, 10, 20]
    elif case == "nan":
        cur = np.array([3, 3, 7, 12, 20, 0], np.int32)
        nbr_up[7, 0] = [8, 50, -1, 9]  # NaN between two moves
        nbr_up[12, 0, 0] = 50
    else:
        cur = np.zeros(6, np.int32)
        max_steps = 3
    want = _reference_walk(vals, nbr0, nbr_up, up_slot, qs, cur, metric, hi,
                           1, max_steps)
    got = _plain_walk(vals, nbr_up, up_slot, qs, cur, metric, hi, 1,
                      max_steps)
    _assert_same_walk(want, got)
    end = got[0].numpy()
    if case == "no_slot":
        assert (end[:4] == 40).all()
    elif case == "minus_one":
        assert end[0] == 41 and end[1] == 31  # by 20, then the chain
    elif case == "nan":
        assert end[2] == 7 and end[3] == 12 and end[0] == 7
    else:
        assert (end == 3).all()


def test_greedy_walk_plain_ids_past_rows_are_empty():
    """A listed id at or past the value table's rows counts as -1 (the
    reference has no such id; K6's lists take the same rule)."""
    vals, _, nbr_up, up_slot, qs = _small_graph()
    cur = np.zeros(6, np.int32)
    past = nbr_up.copy()
    past[:31, 0, 2] = 64 + np.arange(31)
    got = _plain_walk(vals, past, up_slot, qs, cur, "L2", 1, 1)
    want = _plain_walk(vals, nbr_up, up_slot, qs, cur, "L2", 1, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0].numpy() == 31).all()


def _parent_descend(kind, metric, values, nbr_up, up_slot, score, nbrs, qs,
                    cur, cur_d, level_hi, level_lo):
    """The descent before K7: ``greedy_descent`` a level at a time over
    the 2m-wide closure."""
    for lc in range(level_hi, level_lo - 1, -1):
        cur, cur_d = TK.greedy_descent(score, nbrs, qs, cur, cur_d, lc,
                                       max_steps=512)
    return cur, cur_d


def _run_search(graph, route, metric):
    n = len(graph["nbr0"])
    g = dict(values=torch.from_numpy(graph["db"][:n]),
             nbr0=torch.from_numpy(graph["nbr0"]),
             nbr_up=torch.from_numpy(graph["nbr_up"]),
             up_slot=torch.from_numpy(graph["up_slot"]))
    qs = torch.from_numpy(graph["qs"])
    args = ("dense", Metric[metric], *g.values())
    if route == "query_search":
        d, r, steps = TK.query_search(
            *args, torch.arange(n, dtype=torch.int32)[:, None],
            torch.ones(n, dtype=torch.bool), None, qs, graph["entry"],
            graph["entry_level"], ef=24, k=10, heaptids=1, expand=4,
            vmode="off")
        return [d, r, torch.tensor(steps)]
    if route == "query_search_first":
        return list(TK.query_search_first(*args, qs, graph["entry"],
                                          graph["entry_level"], ef=24,
                                          dk=64))
    lv = np.random.default_rng(3).integers(0, graph["entry_level"] + 1,
                                           size=len(qs))
    return list(TK.wave_search(*args, qs, lv, graph["entry"],
                               graph["entry_level"], ef=24,
                               l_unroll=graph["entry_level"], expand=4))


@pytest.mark.parametrize("route", ["query_search", "query_search_first",
                                   "wave_search"])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_searches_match_the_per_level_descent(graph, route, metric,
                                              monkeypatch):
    """A dense index's searches with one K7 walk (its plain version here)
    give what they gave with the per-level ``greedy_descent`` loop: the
    same ids, distances within tolerance, everything else equal."""
    got = _run_search(graph, route, metric)
    monkeypatch.setattr(TK, "descend", _parent_descend)
    want = _run_search(graph, route, metric)
    for a, b in zip(want, got):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL,
                                       rtol=RTOL)
        else:
            np.testing.assert_array_equal(b.numpy(), a.numpy())
