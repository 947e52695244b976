"""Port ops against the reference: dense scores, the tiled top-k engine,
and the plain versions of the two kernels (K1 fused top-k, K2 hop tail).

The same seeded numpy inputs go through the JAX function and its PyTorch
counterpart, on the CPU.  K1 has no interpret mode in the reference
(tests/test_pallas_topk.py skips off TPU), so its plain version is held
against the reference's own exact engine, ``ops.topk.tiled_topk``; K2's is
held against ``pallas_hop.hop_tail`` in interpret mode.

Tolerance for f32 scores: atol 1e-4, rtol 1e-5 — the two stacks sum the
same f32 products in different orders.  Ids must agree except among
candidates whose distances tie within that tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.ops import distance as JD  # noqa: E402
from pgvector_tpu.ops import topk as JT  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.ops.pallas_hop import hop_tail as jax_hop_tail  # noqa: E402
from pgvector_tpu_torch.ops import distance as TD  # noqa: E402
from pgvector_tpu_torch.ops import topk as TT  # noqa: E402
from pgvector_tpu_torch.ops.fused_topk import (  # noqa: E402
    exact_topk, fused_topk, fused_topk_plain)
from pgvector_tpu_torch.ops.hop_tail import (  # noqa: E402
    hop_tail, hop_tail_plain)
from pgvector_tpu_torch.ops.metric import Metric as TMetric  # noqa: E402
from torch_parity import ATOL, RTOL, assert_same_topk  # noqa: E402

METRICS = ["L2", "IP", "COSINE", "L1"]


def _blocks(seed, nq, n, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    db = rng.normal(size=(n, d)).astype(np.float32)
    db[5] = 0.0  # zero-norm row: cosine gives +inf
    return q, db


@pytest.mark.parametrize("metric", METRICS)
def test_dense_scores_and_pairs_match_reference(metric):
    q, db = _blocks(1, 16, 300, 24)
    want = np.asarray(JD.dense_scores(JMetric[metric], jnp.asarray(q),
                                      jnp.asarray(db)))
    got = TD.dense_scores(TMetric[metric], torch.from_numpy(q),
                          torch.from_numpy(db)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    a, b = db[:16], db[16:32]  # aligned pairs; row 5 has zero norm
    want = np.asarray(JD.dense_pair(JMetric[metric], jnp.asarray(a),
                                    jnp.asarray(b)))
    got = TD.dense_pair(TMetric[metric], torch.from_numpy(a),
                        torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("metric", METRICS)
def test_tiled_topk_matches_reference(metric):
    q, db = _blocks(2, 16, 2000, 24)
    n, k, tile = 1900, 10, 512  # ragged last tile; rows past n unused
    valid = np.random.default_rng(3).random(2000) > 0.2
    jm, tm = JMetric[metric], TMetric[metric]
    jq, tq = jnp.asarray(q), torch.from_numpy(q)
    d0, i0 = JT.tiled_topk(lambda t: JD.dense_scores(jm, jq, t),
                           (jnp.asarray(db),), n, k, tile=tile,
                           valid=jnp.asarray(valid))
    d1, i1 = TT.tiled_topk(lambda t: TD.dense_scores(tm, tq, t),
                           (torch.from_numpy(db),), n, k, tile=tile,
                           valid=torch.from_numpy(valid))
    assert i1.dtype == torch.int32
    assert_same_topk(d0, i0, d1.numpy(), i1.numpy())
    assert (i1.numpy()[np.isinf(d1.numpy())] == -1).all()


@pytest.mark.parametrize("metric,k", [("L2", 10), ("L2", 64),
                                      ("IP", 10), ("IP", 64)])
def test_fused_topk_plain_matches_tiled_reference(metric, k):
    """K1's plain version (through exact_topk, which calls the kernel) against
    the reference's exact tiled engine: 64 queries × 8,192 × 64-d, dead
    rows, and a tile that does not divide the row count."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 64)).astype(np.float32)
    db = rng.normal(size=(8192, 64)).astype(np.float32)
    valid = rng.random(8192) > 0.1
    jm = JMetric[metric]
    jq = jnp.asarray(q)
    d0, i0 = JT.tiled_topk(lambda t: JD.dense_scores(jm, jq, t),
                           (jnp.asarray(db),), 8192, k,
                           valid=jnp.asarray(valid))
    d1, i1 = exact_topk(TMetric[metric], torch.from_numpy(q),
                        torch.from_numpy(db), k,
                        valid=torch.from_numpy(valid))
    assert_same_topk(d0, i0, d1.numpy(), i1.numpy())
    assert valid[i1.numpy()].all()
    # the plain version itself, at a ragged tile, orders by (score, id)
    dbsq = torch.from_numpy(np.where(valid, (db * db).sum(1), np.inf)
                            .astype(np.float32))
    raw, ids = fused_topk_plain(torch.from_numpy(q), torch.from_numpy(db),
                                dbsq if metric == "L2" else
                                torch.where(dbsq.isinf(), dbsq, 0.0),
                                k, tile=3000)
    raw2, ids2 = fused_topk(torch.from_numpy(q), torch.from_numpy(db),
                            dbsq if metric == "L2" else
                            torch.where(dbsq.isinf(), dbsq, 0.0), k)
    assert torch.equal(ids, ids2) and torch.equal(raw, raw2)
    assert (raw[:, 1:] >= raw[:, :-1]).all()


def _hop_case(ef, w, seed):
    """Pool/candidate rows with pool duplicates, candidate duplicates and
    -1 lanes (tests/test_pallas_hop.py's cases, widened)."""
    rng = np.random.default_rng(seed)
    q = 5
    pool_d = np.sort(rng.random((q, ef)).astype(np.float32), axis=1)
    pool_i = rng.permutation(1000)[: q * ef].reshape(q, ef).astype(np.int32)
    pool_x = rng.random((q, ef)) > 0.5
    # an unfilled pool tail (early hops): -1 ids at +inf
    pool_i[1, ef // 2:] = -1
    pool_d[1, ef // 2:] = np.inf
    pool_x[1, ef // 2:] = False
    pool_p = pool_i * 2 + pool_x.astype(np.int32)
    cand_i = rng.integers(0, 1000, size=(q, w)).astype(np.int32)
    cand_d = rng.random((q, w)).astype(np.float32)
    cand_i[:, 3] = pool_i[:, 0]   # duplicate of a pool entry
    cand_d[:, 3] = pool_d[:, 0]   # same id → same distance
    cand_i[:, 5] = cand_i[:, 4]   # duplicate candidate pair
    cand_d[:, 5] = cand_d[:, 4]
    cand_i[:, 7] = -1             # masked lane
    cand_d[:, 7] = np.inf
    cand_i[2, w // 2:] = -1       # a row of empty lanes
    cand_d[2, w // 2:] = np.inf
    return pool_d, pool_p, cand_d, cand_i


@pytest.mark.parametrize("ef", [8, 48, 100])
@pytest.mark.parametrize("w", [24, 256])
def test_hop_tail_plain_equals_pallas(ef, w):
    """K2's plain version is exactly equal to the Pallas hop tail run in
    interpret mode, and the CPU wrapper takes the plain version."""
    pool_d, pool_p, cand_d, cand_i = _hop_case(ef, w, seed=ef * 1000 + w)
    d0, p0 = jax_hop_tail(pool_d, pool_p, cand_d, cand_i, ef, w)
    args = [torch.from_numpy(a) for a in (pool_d, pool_p, cand_d, cand_i)]
    d1, p1 = hop_tail_plain(*args, ef, w)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p0))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(d0))
    launches = hop_tail.launches
    d2, p2 = hop_tail(*args, ef, w)
    assert torch.equal(d1, d2) and torch.equal(p1, p2)
    assert hop_tail.launches == launches  # CPU tensors launch nothing
