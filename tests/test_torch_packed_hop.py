"""K2's plain version (``ops/packed_hop.packed_hop_plain``, the whole
packed hop) and the beam loops that drive it, against the reference on
the CPU.

The f32 / bf16 slab cases are in ``test_torch_ops.py``
(``test_packed_hop_plain_matches_reference_step``).  Here: the int8 slab
against the reference's int8 packed hop (``_hop_body`` with the slab, its
scale and norms, the Pallas tail in interpret mode); a NaN at an
unexpanded lane, where the reference's E = 1 branch and the port part (the
reference expands it), against the port's torch-op packed hop; a second
hop from the first one's done flags and hop counts; each query's hop count
over a whole search against the reference's ``steps`` of that query
searched alone; ``search_layer``'s K2 route (the pool packed across hops,
the count read every ``HOP_READ_EVERY`` hops) against the torch-op route,
a host read every hop; and ``greedy_descent`` against the reference's
walk.  Distances within ``torch_parity``'s f32 tolerance, ids
apart from ties, done flags and hop counts exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu_torch import Metric  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.ops import packed_hop as TP  # noqa: E402
from pgvector_tpu_torch.ops.distance import int8_query  # noqa: E402
from test_torch_ops import reference_packed_hop  # noqa: E402
from torch_parity import (  # noqa: E402
    ATOL, RTOL, assert_same_pool, int8_hop_case, packed_hop_case)

EF = 24


@pytest.mark.parametrize("e_sel", [1, 8])
@pytest.mark.parametrize("metric", ["L2", "IP", "L1"])
def test_int8_packed_hop_plain_matches_reference(metric, e_sel):
    """The int8 slab: the reference's int8 scorer (the re-quantized query,
    an exact int32 dot, the f32 close; L1 dequantized) and tail against
    the plain whole hop."""
    pool_d, pool_p, nbr0, q8, qs, scale, pnorm2 = int8_hop_case(
        31 + e_sel, 7, EF, e_sel)
    d0, p0, done0 = reference_packed_hop(pool_d, pool_p, nbr0, q8, qs, EF,
                                         e_sel, metric, int8=(scale, pnorm2))
    tq = torch.from_numpy(qs)
    tscale, tnorm = torch.from_numpy(scale), torch.from_numpy(pnorm2)
    qc, sq, q2 = int8_query(tq, tscale)
    d1, p1, done1, left, hops = TP.packed_hop(
        *(torch.from_numpy(a) for a in (pool_d, pool_p, nbr0, q8)), tq, EF,
        e_sel, Metric[metric], (qc, sq, q2, tnorm, tscale))
    assert_same_pool(d0, p0, d1.numpy(), p1.numpy())
    np.testing.assert_array_equal(done1.numpy(), done0)
    assert (hops == 1).all() and int(left) == int((~done1).sum())


@pytest.mark.parametrize("e_sel", [1, 8])
def test_packed_hop_nan_lane_matches_torch_route(e_sel):
    """A NaN at an unexpanded lane (row 7): the plain whole hop against
    the port's torch-op packed hop (``_hop_body`` over the same slabs),
    every row; E = 1 selects the NaN first and expands nothing there,
    and the NaN lane sorts after the empty ones, past ef."""
    pool_d, pool_p, nbr0, vals, qs = (torch.from_numpy(a) for a in
                                      packed_hop_case(71, 8, EF, e_sel,
                                                      nan=True))
    d1, p1, done1, _, _ = TP.packed_hop_plain(pool_d, pool_p, nbr0, vals, qs,
                                              EF, e_sel, Metric.L2)
    d0, i0, x0, _, done0 = TK._hop_body(
        None, None, qs, pool_d, pool_p >> 1, (pool_p & 1) == 1, EF, e_sel,
        packed=(vals, qs, nbr0, None), metric=Metric.L2)
    assert torch.equal(done1, done0)
    assert_same_pool(d0.numpy(), (i0 * 2 + x0.to(torch.int32)).numpy(),
                     d1.numpy(), p1.numpy())
    assert torch.isnan(pool_d[7]).any()
    if e_sel == 1:  # nothing expanded: no new id, the NaN lane past ef
        ids = set((p1[7] >> 1).tolist())
        assert ids <= set((pool_p[7] >> 1).tolist()) | {-1}
        assert not torch.isnan(d1[7]).any()


@pytest.mark.parametrize("e_sel", [1, 8])
def test_packed_hop_carries_done_and_hops(e_sel):
    """A second hop from the first's state: the queries done on entry keep
    their pool and their hop count, every other one takes the hop of a
    stateless call and counts one more."""
    case = [torch.from_numpy(a) for a in packed_hop_case(5, 7, EF, e_sel)]
    rest = (*case[2:], EF, e_sel, Metric.IP)
    d1, p1, done1, _, hops1 = TP.packed_hop(*case[:2], *rest)
    assert done1[3] and done1[6] and not done1[0]
    d2, p2, done2, left2, hops2 = TP.packed_hop(d1, p1, *rest, done=done1,
                                                hops=hops1)
    f_d, f_p, f_done, _, _ = TP.packed_hop(d1, p1, *rest)
    keep = done1[:, None]
    assert torch.equal(torch.where(keep, d1, f_d), d2)
    assert torch.equal(torch.where(keep, p1, f_p), p2)
    assert torch.equal(done2, done1 | f_done)
    assert torch.equal(hops2, 1 + (~done1).to(torch.int32))
    assert int(left2) == int((~done2).sum())


def _graph(seed, cap=300, m2=16, d=16, nq=8):
    """A random level-0 graph with its adjacency-packed slabs, queries and
    each query's seed element: (values, nbr0, nbr_vals, qs, init_i)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(cap, d)).astype(np.float32)
    nbr0 = np.stack([rng.choice(cap, m2, replace=False)
                     for _ in range(cap)]).astype(np.int32)
    nbr0[rng.random(nbr0.shape) < 0.15] = -1
    nbr_vals = vals[np.maximum(nbr0, 0)]
    qs = rng.normal(size=(nq, d)).astype(np.float32)
    init_i = rng.integers(0, cap, size=(nq, 1)).astype(np.int32)
    return vals, nbr0, nbr_vals, qs, init_i


def _k2_search(g, ef, e_sel, metric, stats=None):
    """The port's layer-0 search on the K2 route."""
    vals, nbr0, nbr_vals, qs, init_i = (torch.from_numpy(a) for a in g)
    score = TK.make_scorer("dense", metric, vals)
    init_d = score(qs, init_i)
    return TK.search_layer(
        score, None, qs, init_d, init_i, ef=ef, max_steps=8 * ef + 64,
        expand=e_sel, packed=(nbr_vals, qs, nbr0, None), metric=metric,
        stats=stats)


@pytest.mark.parametrize("e_sel", [1, 4])
def test_k2_hop_counts_match_reference_steps(e_sel):
    """Each query's hop count over a whole search on the K2 route (the
    kernel's per-query count, up to and including the hop that finds it
    done) equals the reference's ``steps`` for that query searched alone
    (its jitted while_loop over the packed hop), and the search's steps
    are the largest."""
    ef = 16
    g = _graph(40 + e_sel)
    vals, nbr0, nbr_vals, qs, init_i = g
    jnbr0 = jnp.asarray(nbr0)
    score = JK.make_scorer("dense", JMetric.L2, (jnp.asarray(vals),))

    @jax.jit
    def ref_steps(q, i0):
        d0 = score(q, i0)
        *_, steps = JK.search_layer(
            score, lambda e: jnbr0[jnp.maximum(e, 0)], q, d0, i0,
            jnp.zeros((1, 1), jnp.int32), ef, 8 * ef + 64, e_sel,
            vmode="off", packed=(jnp.asarray(nbr_vals), q),
            metric=JMetric.L2)
        return steps

    want = [int(ref_steps(jnp.asarray(qs[r:r + 1]),
                          jnp.asarray(init_i[r:r + 1])))
            for r in range(len(qs))]
    stats = {}
    _, _, steps = _k2_search(g, ef, e_sel, Metric.L2, stats)
    assert stats["hops"].tolist() == want
    assert steps == max(want) and len(set(want)) > 1


def _torch_route(g, ef, e_sel, metric):
    """The torch-op route: ``_hop_body`` over the slabs a hop, the done
    flags read after every hop."""
    vals, nbr0, nbr_vals, qs, init_i = (torch.from_numpy(a) for a in g)
    score = TK.make_scorer("dense", metric, vals)
    pool_d, pool_i, pool_x = TK._init_pool(score(qs, init_i), init_i, ef)
    steps = 0
    while steps < 8 * ef + 64:
        pool_d, pool_i, pool_x, _, done = TK._hop_body(
            score, None, qs, pool_d, pool_i, pool_x, ef, e_sel,
            packed=(nbr_vals, qs, nbr0, None), metric=metric)
        steps += 1
        if bool(done.all()):
            break
    return pool_d, pool_i, steps


@pytest.mark.parametrize("read_every", [1, TK.HOP_READ_EVERY])
@pytest.mark.parametrize("e_sel", [1, 4])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_search_layer_k2_route_matches_torch_route(metric, e_sel, read_every,
                                                   monkeypatch):
    """search_layer on the K2 route (the pool packed from hop to hop, one
    packed_hop a hop, the count read every HOP_READ_EVERY hops) gives the
    torch-op route's pools and hop count; the hops launched reach the
    count and stay below it plus HOP_READ_EVERY."""
    monkeypatch.setattr(TK, "HOP_READ_EVERY", read_every)
    g = _graph(50 + e_sel)
    d0, i0, s0 = _torch_route(g, 20, e_sel, Metric[metric])
    stats = {}
    d1, i1, s1 = _k2_search(g, 20, e_sel, Metric[metric], stats)
    assert s1 == s0 == stats["steps"] and s0 > 1
    assert s0 <= stats["launches"] < s0 + read_every
    np.testing.assert_array_equal(d1.numpy(), d0.numpy())
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_greedy_descent_matches_reference(metric):
    """greedy_descent (a host read every step) walks where the
    reference's ``lax.while_loop`` walk does: the same (cur, cur_d) from
    the same seeds over the same lists, after more than two moves."""
    vals, nbr0, _, qs, init_i = _graph(9)
    tv, tn, tq = (torch.from_numpy(a) for a in (vals, nbr0, qs))
    score = TK.make_scorer("dense", Metric[metric], tv)
    nbrs_of = lambda e, lc: torch.where(  # noqa: E731
        (e >= 0)[:, None], tn[torch.clamp(e, min=0).long()], -1)
    cur = torch.from_numpy(init_i[:, 0])
    got = TK.greedy_descent(score, nbrs_of, tq, cur,
                            score(tq, cur[:, None])[:, 0], 1, max_steps=64)
    jv, jn, jq = (jnp.asarray(a) for a in (vals, nbr0, qs))
    jscore = JK.make_scorer("dense", JMetric[metric], (jv,))
    jnbrs_of = lambda e, lc: jnp.where(  # noqa: E731
        (e >= 0)[:, None], jn[jnp.maximum(e, 0)], -1)
    jcur = jnp.asarray(init_i[:, 0])
    want = JK.greedy_descent(jscore, jnbrs_of, jq, jcur,
                             jscore(jq, jcur[:, None])[:, 0], 1, 16, 64)
    moves = int((got[0] != cur).sum())
    assert moves > 2
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("tool", ["k2", "k6"])
def test_breakdown_cuts_apply_to_the_kernels(tool):
    """The K2 and K6 breakdown tools' cuts still find their anchors in
    csrc/packed_hop.cu and csrc/gather_hop.cu, and each variant is a
    different source."""
    from pgvector_tpu_torch.tools import k2_breakdown, k3_k6_breakdown
    from pgvector_tpu_torch.tools.k1_breakdown import variant_source

    source, variants, cuts = {
        "k2": (k2_breakdown.K2_SOURCE, k2_breakdown.K2_VARIANTS,
               k2_breakdown.K2_CUTS),
        "k6": (k3_k6_breakdown.K6_SOURCE, k3_k6_breakdown.K6_VARIANTS,
               k3_k6_breakdown.K6_CUTS)}[tool]
    src = source.read_text()
    made = {v: variant_source(c, src, cuts) for v, c in variants.items()}
    assert made["whole"] == src
    assert len(set(made.values())) == len(made)
