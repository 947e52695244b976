"""K6's plain version (``ops/gather_hop.gather_hop_plain``) against the
reference's row-gather hop (``pgvector_tpu.index.hnsw_kernels._hop_step``
with the visited set ``off``) on the CPU.

Both packages take one hop from the same seeded state: a graph of 400
elements (level-0 lists of 2m = 16, level-1 lists of m = 8), 32 queries
that are stored rows, sorted ef-pools of true distances (partly expanded,
one half empty).  The port's ``_hop_body`` makes the E-selection and
gathers the lists, then its dense row-gather route calls ``gather_hop``,
which on the CPU runs ``gather_hop_plain``.  Cases: E = 1 (adjacency
order) and E = 4 (the Knuth-keyed dedupe), level 0 and level 1, L2,
inner product, cosine (normalized rows) and L1, f32 and bf16 rows.  The
pools must hold the same ids apart from ties and distances within
``torch_parity``'s f32 tolerance (atol 1e-4, rtol 1e-5: the two stacks
sum the same products in different orders), with the same expanded flags
and done flags.
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


def _state(seed, metric, dtype):
    """Graph arrays, values (rounded to ``dtype``, held in f32 numpy) and
    the queries' sorted pools of true distances."""
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE", "L1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("level", [0, 1])
def test_gather_hop_plain_matches_reference(metric, dtype, expand, level,
                                            monkeypatch):
    vals, nbr0, nbr_up, up_slot, qs, pool_d, pool_i, pool_x = _state(
        11 + expand + 3 * level, metric, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j = JK._hop_step(
        "dense", JMetric[metric], (jnp.asarray(vals, jdt),),
        jnp.asarray(nbr0), jnp.asarray(nbr_up), jnp.asarray(up_slot), level,
        jnp.asarray(qs, jdt), jnp.asarray(pool_d), jnp.asarray(pool_i),
        jnp.asarray(pool_x), jnp.full((Q, 8), -1, jnp.int32), EF, expand,
        vmode="off")
    jd, ji, jx, _, jdone = (np.asarray(a) for a in j)

    values = torch.from_numpy(vals).to(dtype)
    calls = []

    def spy(*a):
        calls.append(a)
        return TG.gather_hop(*a)

    monkeypatch.setattr(TK, "gather_hop", spy)
    launches = TG.gather_hop.launches
    nbrs_of = TK._neighbors_closure(torch.from_numpy(nbr0),
                                    torch.from_numpy(nbr_up),
                                    torch.from_numpy(up_slot))
    td, ti, tx, _, tdone = TK._hop_body(
        TK.make_scorer("dense", Metric[metric], values),
        lambda e: nbrs_of(e, level), torch.from_numpy(qs).to(dtype),
        torch.from_numpy(pool_d),
        torch.from_numpy(pool_i), torch.from_numpy(pool_x), EF, expand,
        metric=Metric[metric], rows=values)
    assert len(calls) == 1 and TG.gather_hop.launches == launches
    assert calls[0][1].shape == (Q, EF) and calls[0][2].shape == (Q * expand,)
    np.testing.assert_array_equal(tdone.numpy(), jdone)
    assert_same_pool(jd, ji * 2 + jx, td.numpy(),
                     ti.numpy() * 2 + tx.numpy().astype(np.int32))


@pytest.mark.parametrize("e_sel", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_hop_routes_to_plain_on_cpu(e_sel, dtype):
    """The K6 wrapper takes the plain version for CPU tensors and launches
    nothing; with E > 1 the candidates that two lists share and one that
    the pool holds are scored once."""
    case = [torch.from_numpy(a) for a in gather_hop_case(3, 8, EF, e_sel)]
    case[4] = case[4].to(dtype)
    launches = TG.gather_hop.launches
    d0, p0 = TG.gather_hop_plain(*case, EF, Metric.L2)
    d1, p1 = TG.gather_hop(*case, EF, Metric.L2)
    assert torch.equal(d0, d1) and torch.equal(p0, p1)
    assert TG.gather_hop.launches == launches
    ids = (p0 >> 1).numpy()
    for r in range(ids.shape[0]):
        live = ids[r][ids[r] >= 0]
        assert len(set(live.tolist())) == len(live)
    assert np.isfinite(d0.numpy()[0]).all()
