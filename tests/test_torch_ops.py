"""Port ops against the reference: dense scores, the tiled top-k engine,
and the plain versions of the kernels (K1 fused top-k, K2 packed hop and
its hop tail), with a numpy rehearsal of K1's 3xTF32 precision.

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
from pgvector_tpu_torch.ops.packed_hop import (  # noqa: E402
    packed_hop, packed_hop_plain)
from torch_parity import (  # noqa: E402
    ATOL, RTOL, assert_same_pool, assert_same_topk, packed_hop_case)

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


def reference_packed_hop(pool_d, pool_p, nbr0, vals, qs, ef, e_sel, metric,
                         int8=None, pallas_tail=True):
    """The reference's packed hop from the pool: ``_hop_body`` with the
    slabs (and, for int8, their scale and norms), the visited set off and
    its Pallas tail in interpret mode (or its XLA merge).  Returns
    (pool_d, pool_p, done) as numpy."""
    from pgvector_tpu.index import hnsw_kernels as JK

    jnbr0 = jnp.asarray(nbr0)
    packed = ((jnp.asarray(vals), jnp.asarray(qs)) if int8 is None
              else (jnp.asarray(vals), jnp.asarray(qs), *map(jnp.asarray,
                                                              int8)))
    d, i, x, _, done = JK._hop_body(
        None, lambda e: jnbr0[jnp.maximum(e, 0)], jnp.asarray(qs),
        jnp.asarray(pool_d), jnp.asarray(pool_p >> 1),
        jnp.asarray((pool_p & 1) == 1), None, ef, e_sel, vmode="off",
        packed=packed, metric=JMetric[metric], pallas_tail=pallas_tail)
    d, i, x = (np.asarray(a) for a in (d, i, x))
    return d, i * 2 + x, np.asarray(done)


@pytest.mark.parametrize("ef", [24, 100])
@pytest.mark.parametrize("e_sel", [1, 8])
@pytest.mark.parametrize("slab", ["f32", "bf16"])
@pytest.mark.parametrize("metric", METRICS)
def test_packed_hop_plain_matches_reference_step(ef, e_sel, slab, metric):
    """K2's plain version, the whole hop from the pool, against the
    reference's packed Pallas-tail hop (``_hop_body``: the E-selection, the
    slab gather, ``dense_point_scores``, then ``pallas_hop.hop_tail`` in
    interpret mode) on the same seeded pools: the same pool apart from
    ties, with f32 tolerance on distances, and the same done flags; every
    query counts one hop; the CPU wrapper takes the plain version."""
    pool_d, pool_p, nbr0, vals, qs = packed_hop_case(ef * 10 + e_sel, 7, ef,
                                                     e_sel)
    tvals = torch.from_numpy(vals)
    if slab == "bf16":  # both round to nearest even
        tvals = tvals.to(torch.bfloat16)
    d0, p0, done0 = reference_packed_hop(
        pool_d, pool_p, nbr0, tvals.float().numpy(), qs, ef, e_sel, metric)
    args = [torch.from_numpy(a) for a in (pool_d, pool_p, nbr0)] + [
        tvals, torch.from_numpy(qs)]
    d1, p1, done1, left, hops = packed_hop_plain(*args, ef, e_sel,
                                                 TMetric[metric])
    assert_same_pool(d0, p0, d1.numpy(), p1.numpy())
    np.testing.assert_array_equal(done1.numpy(), done0)
    assert (p1.numpy()[np.isinf(d1.numpy())] == -2).all()
    assert (hops == 1).all() and int(left) == int((~done1).sum())
    launches = packed_hop.launches
    out = packed_hop(*args, ef, e_sel, TMetric[metric])
    for a, b in zip(out, (d1, p1, done1, left, hops)):
        assert torch.equal(a, b)
    assert packed_hop.launches == launches  # CPU tensors launch nothing


def _tf32(x):
    """cvt.rna.tf32.f32: round the f32 mantissa to 10 bits, to nearest,
    ties away from zero (the low 13 bits cleared).  K1 gives wgmma only
    values rounded so, which its truncation to TF32 leaves as they are."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split_dot(q, x, terms):
    """K1's tensor-core product in numpy: a = hi + lo, the TF32 products
    ``terms`` of (hi·hi, hi·lo, lo·hi) exact in f32.  As the wgmma ops of
    csrc/fused_topk.cu add them: per 32-dim chunk a fresh f32 sum, per k8
    slice of it one op a term in the order given, each op adding its
    slice's 8 products; the chunks' sums added in f32."""
    qh, xh = _tf32(q), _tf32(x)
    ql, xl = _tf32(q - qh), _tf32(x - xh)
    pairs = {"hh": (qh, xh), "hl": (qh, xl), "lh": (ql, xh)}
    acc = np.zeros((len(q), len(x)), np.float32)
    for c in range(0, q.shape[1], 32):
        part = np.zeros_like(acc)
        for s in range(c, min(c + 32, q.shape[1]), 8):
            for t in terms:
                a, b = pairs[t]
                part += (a[:, None, s:s + 8] * b[None, :, s:s + 8]).sum(
                    -1, dtype=np.float32)
        acc = part if c == 0 else acc + part
    return acc


def test_3xtf32_split_keeps_f32_tolerance():
    """Rehearses K1's precision without a card: on the bench's clustered
    128-d data (row norms near 400, scores near -160), the 3xTF32 score
    ``dbsq - 2·q·x`` stays within ATOL/RTOL of the f64 score, where one
    plain TF32 product does not."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import make_data

    db, qs = make_data(2048, 32, seed=0)
    dbsq = (db * db).sum(1, dtype=np.float32)
    want = dbsq[None, :].astype(np.float64) - 2.0 * (
        qs.astype(np.float64) @ db.astype(np.float64).T)
    assert np.median(want.min(axis=1)) < -100  # the cancelling regime
    # the kernel's order: row lo x query hi, row hi x query lo, hi x hi
    got = dbsq[None, :] - np.float32(2) * _split_dot(
        qs, db, ("hl", "lh", "hh"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    one = dbsq[None, :] - np.float32(2) * _split_dot(qs, db, ("hh",))
    assert not np.allclose(one, want, atol=ATOL, rtol=RTOL)


def test_k1_breakdown_cuts_apply_to_the_kernel():
    """The K1 breakdown tool's cuts still find their anchors in
    csrc/fused_topk.cu (each variant is a different source), and its data
    is bench.make_data's."""
    import os
    import sys

    from pgvector_tpu_torch.tools import k1_breakdown as K

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import make_data

    src = K.SOURCE.read_text()
    variants = {v: K.variant_source(c, src) for v, c in K.VARIANTS.items()}
    assert variants["whole"] == src
    assert len(set(variants.values())) == len(variants)
    for got, want in zip(K.clustered(3000, 40), make_data(3000, 40)):
        np.testing.assert_array_equal(got, want)


def test_k4_breakdown_cuts_apply_to_the_kernel():
    """The K4 breakdown tool's cuts still find their anchors in
    csrc/bit_scan.cu, and each variant is a different source."""
    from pgvector_tpu_torch.tools import k4_breakdown as K
    from pgvector_tpu_torch.tools.k1_breakdown import variant_source

    src = K.SOURCE.read_text()
    variants = {v: variant_source(c, src, K.CUTS)
                for v, c in K.VARIANTS.items()}
    assert variants["whole"] == src
    assert len(set(variants.values())) == len(variants)
    assert "mma_s8(acc" not in variants["loads_only"]
