"""K6's plain version (``ops/gather_hop.gather_hop_plain``, the whole hop)
against the reference's row-gather hop
(``pgvector_tpu.index.hnsw_kernels._hop_step`` with the visited set
``off``) on the CPU.

Both packages take one hop from the same seeded state: a graph of 400
elements (level-0 lists of 2m = 16, level-1 lists of m = 8), 32 queries
that are stored rows, sorted ef-pools of true distances (partly expanded,
one half empty).  The port's ``hnsw_kernels.gather_hop`` (the K6
wrapper, which on the CPU runs ``gather_hop_plain``) takes the packed
pool and the list tables and makes the E-selection, reads the lists,
dedupes, masks, scores and merges.  Cases: E = 1 (adjacency order) and
E = 4 (the Knuth-keyed dedupe), level 0 and level 1, L2, inner product,
cosine (normalized rows) and L1, f32 and bf16 rows; then edge cases
(+inf lanes with ids, ties, fully expanded and empty pools, a NaN at an
expanded lane, elements without an upper slot, listed ids at or past the
table's rows, which count as -1).  The pools must hold the same ids apart
from ties and distances within ``torch_parity``'s f32 tolerance (atol
1e-4, rtol 1e-5: the two stacks sum the same products in different
orders), with the same expanded flags and done flags.

A NaN at an unexpanded lane is where the reference's E = 1 branch and
the port part (the reference expands it); there the plain version is
held against the port's torch-op hop (``_hop_body`` through a scorer).
The kernel's E-selection (rounds of a warp-wide minimum over (key,
position)) is written out in numpy here and held equal to the plain
version's ``torch.argmin`` / stable sort, NaN, ±inf and ties included;
and ``search_layer`` on the K6 route (the pool packed across hops) gives
the torch-op route's pools and hop counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu_torch import Metric  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.ops import gather_hop as TG  # noqa: E402
from torch_parity import assert_same_pool, gather_hop_case  # noqa: E402

CAP, D, M, Q, EF = 400, 16, 8, 32, 24


def _state(seed, metric, dtype, grid=False):
    """Graph arrays, values (rounded to ``dtype``, held in f32 numpy) and
    the queries' sorted pools of true distances.  ``grid``: small integer
    values, so distances are exact and tie often."""
    rng = np.random.default_rng(seed)
    if grid:
        vals = rng.integers(-2, 3, size=(CAP, D)).astype(np.float32)
    else:
        vals = rng.normal(size=(CAP, D)).astype(np.float32)
    if metric == "COSINE":
        vals /= np.linalg.norm(vals, axis=1, keepdims=True)
    vals = torch.from_numpy(vals).to(dtype).float().numpy()
    nbr0 = np.stack([rng.choice(CAP, 2 * M, replace=False)
                     for _ in range(CAP)]).astype(np.int32)
    nbr0[rng.random(nbr0.shape) < 0.1] = -1
    nbr_up = np.stack([rng.choice(CAP, M, replace=False)
                       for _ in range(CAP)]).astype(np.int32)[:, None, :]
    nbr_up[rng.random(nbr_up.shape) < 0.1] = -1
    up_slot = np.arange(CAP, dtype=np.int32)
    up_slot[rng.random(CAP) < 0.1] = -1  # no upper slot: an empty list
    elems = rng.choice(CAP, Q, replace=False)
    qs = vals[elems]
    pool_i = np.stack([rng.choice(CAP, EF, replace=False)
                       for _ in range(Q)]).astype(np.int32)
    v = vals[pool_i]
    pool_d = {"L2": ((qs[:, None] - v) ** 2).sum(-1),
              "IP": -(qs[:, None] * v).sum(-1),
              "COSINE": -(qs[:, None] * v).sum(-1),
              "L1": np.abs(qs[:, None] - v).sum(-1)}[metric]
    pool_d = pool_d.astype(np.float32)
    pool_d[1, EF // 2:] = np.inf
    pool_i[1, EF // 2:] = -1
    order = np.argsort(pool_d, axis=1, kind="stable")
    pool_d = np.take_along_axis(pool_d, order, 1)
    pool_i = np.take_along_axis(pool_i, order, 1)
    pool_x = (rng.random((Q, EF)) > 0.6) & (pool_i >= 0)
    return vals, nbr0, nbr_up, up_slot, qs, pool_d, pool_i, pool_x


def _reference(metric, dtype, st, level, expand):
    vals, nbr0, nbr_up, up_slot, qs, pool_d, pool_i, pool_x = st
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = JK._hop_step(
        "dense", JMetric[metric], (jnp.asarray(vals, jdt),),
        jnp.asarray(nbr0), jnp.asarray(nbr_up), jnp.asarray(up_slot), level,
        jnp.asarray(qs, jdt), jnp.asarray(pool_d), jnp.asarray(pool_i),
        jnp.asarray(pool_x), jnp.full((Q, 8), -1, jnp.int32), EF, expand,
        vmode="off")
    jd, ji, jx, _, jdone = (np.asarray(a) for a in j)
    return jd, ji * 2 + jx, jdone


def _port(metric, dtype, st, level, expand):
    """One hop through ``hnsw_kernels.gather_hop`` (the plain version on
    the CPU): (pool_d, pool_p, done), checking ``left``, the hop counts
    (one a query) and that nothing launched."""
    vals, nbr0, nbr_up, up_slot, qs, pool_d, pool_i, pool_x = st
    values = torch.from_numpy(vals).to(dtype)
    launches = TG.gather_hop.launches
    td, tp, tdone, left, hops = TK.gather_hop(
        torch.from_numpy(pool_d), torch.from_numpy(pool_i * 2 + pool_x),
        torch.from_numpy(nbr0), torch.from_numpy(nbr_up),
        torch.from_numpy(up_slot), level, values,
        torch.from_numpy(qs).to(dtype), EF, expand, Metric[metric])
    assert TG.gather_hop.launches == launches
    assert tp.dtype == torch.int32 and tdone.dtype == torch.bool
    assert left.dtype == torch.int32 and left.shape == (1,)
    assert int(left) == int((~tdone).sum())
    assert hops.dtype == torch.int32 and (hops == 1).all()
    return td.numpy(), tp.numpy(), tdone.numpy()


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE", "L1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("level", [0, 1])
def test_gather_hop_plain_matches_reference(metric, dtype, expand, level):
    st = _state(11 + expand + 3 * level, metric, dtype)
    jd, jp, jdone = _reference(metric, dtype, st, level, expand)
    td, tp, tdone = _port(metric, dtype, st, level, expand)
    np.testing.assert_array_equal(tdone, jdone)
    assert_same_pool(jd, jp, td, tp)


def _edge(case, seed):
    """The reference's state and the port's (the same but where
    ``past_n`` adds listed ids at or past the table's rows, which the
    port reads as -1 and the reference's tables hold as -1)."""
    st = list(_state(seed, "L2", torch.float32, grid=case == "ties"))
    vals, nbr0, nbr_up, up_slot, qs, pool_d, pool_i, pool_x = st
    port = None
    if case == "inf":  # unexpanded lanes with ids at +inf, the worst too
        pool_d[:, -4:] = np.inf
        pool_x[:, -4:] = False
    elif case == "expanded":
        pool_x[:] = pool_i >= 0
    elif case == "empty":
        pool_i[:], pool_d[:], pool_x[:] = -1, np.inf, False
    elif case == "nan":  # a NaN at an expanded lane inside the pool
        pool_d[:, 5], pool_x[:, 5] = np.nan, True
    elif case == "slot":  # half the elements have no upper slot
        up_slot[::2] = -1
    elif case == "past_n":
        port = [a.copy() for a in st]
        for t in (port[1], port[2]):
            empty = t < 0
            t[empty] = CAP + np.arange(int(empty.sum())) % 7
    return st, port or st


@pytest.mark.parametrize("case", ["inf", "ties", "expanded", "empty", "nan",
                                  "slot", "past_n"])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("level", [0, 1])
def test_gather_hop_plain_edge_cases(case, expand, level):
    ref, port = _edge(case, 5 + expand + 3 * level)
    jd, jp, jdone = _reference("L2", torch.float32, ref, level, expand)
    td, tp, tdone = _port("L2", torch.float32, port, level, expand)
    np.testing.assert_array_equal(tdone, jdone)
    assert_same_pool(jd, jp, td, tp)
    if case in ("expanded", "empty"):
        assert tdone.all()
        np.testing.assert_array_equal(tp, port[6] * 2 + port[7])


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("level", [0, 1])
def test_gather_hop_plain_nan_lane_matches_torch_route(expand, level):
    """A NaN at an unexpanded lane (argmin takes it first at E = 1, the
    stable sort last at E > 1; it is never expanded): the plain version
    against the port's torch-op hop through a scorer, bit for bit."""
    st = _state(40 + expand + level, "L2", torch.float32)
    vals, nbr0, nbr_up, up_slot, qs, pool_d, pool_i, pool_x = st
    pool_d[:, 3], pool_x[:, 3] = np.nan, False
    pool_d[::3, -1], pool_x[::3, -1] = np.nan, False
    td, tp, tdone = _port("L2", torch.float32, st, level, expand)
    values = torch.from_numpy(vals)
    nbrs_of = TK._neighbors_closure(torch.from_numpy(nbr0),
                                    torch.from_numpy(nbr_up),
                                    torch.from_numpy(up_slot))
    rd, ri, rx, _, rdone = TK._hop_body(
        TK.make_scorer("dense", Metric.L2, values),
        lambda e: nbrs_of(e, level), torch.from_numpy(qs),
        torch.from_numpy(pool_d), torch.from_numpy(pool_i),
        torch.from_numpy(pool_x), EF, expand)
    np.testing.assert_array_equal(tdone, rdone.numpy())
    np.testing.assert_array_equal(td, rd.numpy())
    np.testing.assert_array_equal(tp, (ri * 2 + rx.to(torch.int32)).numpy())
    assert not tdone[0]


def _kernel_selection(pool_d, pool_p, ef, e):
    """csrc/gather_hop.cu's E-selection in numpy: E rounds, each taking
    the least (key, position) past the last one taken, the key the lane's
    distance where it is unexpanded with an id (else +inf), -0 as +0, a
    NaN first at E = 1 and after +inf at E > 1; done and the expanded
    lanes as the kernel decides them.  → (packed pool, (Q, E) ids, done)"""
    pool_p = pool_p.copy()
    q = pool_d.shape[0]
    sel = np.full((q, e), -1, np.int32)
    done = np.zeros(q, bool)
    for r in range(q):
        cand = (pool_p[r] >= 0) & ((pool_p[r] & 1) == 0)
        cd = np.where(cand, pool_d[r], np.inf)

        def key(j):
            x = cd[j]
            if np.isnan(x):
                return (0 if e == 1 else 2, 0.0, j)
            return (1, 0.0 if x == 0 else float(x), j)

        taken = sorted(range(ef), key=key)[:e]
        worst = pool_d[r, ef - 1]
        done[r] = np.isinf(cd[taken[0]]) or cd[taken[0]] > worst
        for k, j in enumerate(taken):
            x = cd[j]
            if np.isfinite(x) and x <= worst and not done[r]:
                sel[r, k] = pool_p[r, j] >> 1
                pool_p[r, j] |= 1
    return pool_p, sel, done


@pytest.mark.parametrize("expand", [1, 2, 4, 8])
@pytest.mark.parametrize("sorted_pool", [True, False])
def test_select_expand_is_the_kernels_rounds(expand, sorted_pool):
    """The plain E-selection (torch.argmin / stable sort) equals the
    kernel's rounds of minima on pools with ties, ±0, NaN, ±inf, lanes
    without ids, fully expanded and empty rows, sorted or not."""
    rng = np.random.default_rng(expand + 10 * sorted_pool)
    q, ef = 64, 24
    pool_d = rng.integers(0, 6, size=(q, ef)).astype(np.float32)
    special = rng.random((q, ef))
    pool_d[special < 0.06] = np.nan
    pool_d[(special >= 0.06) & (special < 0.12)] = np.inf
    pool_d[(special >= 0.12) & (special < 0.15)] = -np.inf
    pool_d[(special >= 0.15) & (special < 0.2)] = -0.0
    if sorted_pool:
        pool_d = np.sort(pool_d, axis=1)  # NaN last, as torch.sort
    pool_i = rng.integers(0, 1000, size=(q, ef)).astype(np.int32)
    pool_i[rng.random((q, ef)) < 0.1] = -1
    pool_x = (rng.random((q, ef)) < 0.4) & (pool_i >= 0)
    pool_x[0] = pool_i[0] >= 0  # fully expanded
    pool_i[1], pool_x[1] = -1, False  # empty
    pool_p = pool_i * 2 + pool_x.astype(np.int32)
    want = _kernel_selection(pool_d, pool_p, ef, expand)
    got = TG.select_expand(torch.from_numpy(pool_d), torch.from_numpy(pool_p),
                           ef, expand)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[2][0] and want[2][1]


@pytest.mark.parametrize("read_every", [1, TK.HOP_READ_EVERY])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("level", [0, 1])
def test_search_layer_k6_route_matches_torch_route(expand, level, read_every,
                                                   monkeypatch):
    """search_layer on the K6 route (the pool packed from hop to hop, one
    gather_hop a hop, the count read every HOP_READ_EVERY hops) gives the
    torch-op route's pools and hop count; the hops launched reach the
    count and stay below it plus HOP_READ_EVERY."""
    monkeypatch.setattr(TK, "HOP_READ_EVERY", read_every)
    vals, nbr0, nbr_up, up_slot, qs, *_ = _state(60 + expand + level, "L2",
                                                 torch.float32)
    values = torch.from_numpy(vals)
    tables = (torch.from_numpy(nbr0), torch.from_numpy(nbr_up),
              torch.from_numpy(up_slot))
    nbrs_of = TK._neighbors_closure(*tables)
    score = TK.make_scorer("dense", Metric.L2, values)
    q = torch.from_numpy(qs)
    init_i = torch.from_numpy(np.random.default_rng(level).integers(
        0, CAP, size=(Q, 2)).astype(np.int32))
    init_d = score(q, init_i)
    outs, stats = [], [{}, {}]
    for (rows, lists), st in zip(((None, None), (values, (*tables, level))),
                                 stats):
        outs.append(TK.search_layer(
            score, lambda e: nbrs_of(e, level), q, init_d, init_i, ef=EF,
            max_steps=4 * EF + 64, expand=expand, metric=Metric.L2,
            rows=rows, lists=lists, stats=st))
    (d0, i0, s0), (d1, i1, s1) = outs
    assert s1 == s0 and s0 > 1
    for st in stats:
        assert st["steps"] == s0
        assert s0 <= st["launches"] < s0 + read_every
    np.testing.assert_array_equal(d1.numpy(), d0.numpy())
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())


@pytest.mark.parametrize("e_sel", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_hop_routes_to_plain_on_cpu(e_sel, dtype):
    """The K6 wrapper takes the plain version for CPU tensors and launches
    nothing; with E > 1 the candidates that two lists share and one that
    the pool holds are scored once."""
    case = [torch.from_numpy(a) for a in gather_hop_case(3, 8, EF)]
    case[5] = case[5].to(dtype)
    args = (*case[:5], 0, *case[5:])
    launches = TG.gather_hop.launches
    out0 = TG.gather_hop_plain(*args, EF, e_sel, Metric.L2)
    out1 = TG.gather_hop(*args, EF, e_sel, Metric.L2)
    for a, b in zip(out0, out1):
        assert torch.equal(a, b)
    assert TG.gather_hop.launches == launches
    d0, p0, done, left, hops = out0
    assert (hops == 1).all()
    ids = (p0 >> 1).numpy()
    for r in range(ids.shape[0]):
        live = ids[r][ids[r] >= 0]
        assert len(set(live.tolist())) == len(live)
    assert np.isfinite(d0.numpy()[0]).all()
    assert done[3] and done[7] and not done[0]
    assert int(left) == int((~done).sum())


@pytest.mark.parametrize("e_sel", [1, 4])
def test_gather_hop_plain_carries_done_and_hops(e_sel):
    """A second hop from the first's state: the queries done on entry keep
    their pool and their hop count, every other one takes the hop of a
    stateless call and counts one more; ``left`` counts the queries not
    done after it."""
    case = [torch.from_numpy(a) for a in gather_hop_case(5, 8, EF)]
    args = (*case[:5], 0, *case[5:])
    d1, p1, done1, _, hops1 = TG.gather_hop(*args, EF, e_sel, Metric.L2)
    assert done1.any() and not done1.all()
    rest = args[2:]
    d2, p2, done2, left2, hops2 = TG.gather_hop(
        d1, p1, *rest, EF, e_sel, Metric.L2, done=done1, hops=hops1)
    f2, fp, fdone, _, _ = TG.gather_hop(d1, p1, *rest, EF, e_sel, Metric.L2)
    keep = done1[:, None]
    assert torch.equal(torch.where(keep, d1, f2), d2)
    assert torch.equal(torch.where(keep, p1, fp), p2)
    assert torch.equal(done2, done1 | fdone)
    assert torch.equal(hops2, 1 + (~done1).to(torch.int32))
    assert int(left2) == int((~done2).sum())
