"""K3's plain version (``ops/select_neighbors.select_neighbors_plain``)
against the reference's Algorithm 4 (``pgvector_tpu.index.hnsw_kernels
.select_neighbors_batch``) on the CPU: the same positions and kept flags
bit for bit, over seeded pools with ties, invalid, +inf and forced
candidates, at C below, at and far above lm, and at C = 1,100 (the
largest pool a build makes: ef_construction 1,000 + m 100).

The reference's top_k takes at most C slots, so a pool with C < lm runs
through it padded to lm with invalid candidates (which never take a
slot); the port takes the pool as it is and pads its output.  On the CPU
the wrapper ``select_neighbors`` and ``hnsw_kernels.select_neighbors``
route only to the plain version.

The Gram form (dense L2, inner product and cosine: the (T, C, C) products
and the norms, each entry formed where it is read) gives the formed
block's selects bit for bit, with NaN and ±inf among the products and
invalid lanes, from C = 1 to 1,100, and the reference's selects on the
block formed in numpy; ``hnsw_kernels._pair_block`` hands the build's
selects that form, and ``_pairwise_dists`` still forms the same block.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu_torch import Metric  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.ops import select_neighbors as TS  # noqa: E402
from torch_parity import formed_block, gram_case, select_case  # noqa: E402


def _reference(base, pair, valid, forced, lm):
    """The reference's batch select, its pool padded to lm candidates."""
    t, c = base.shape
    pad = max(lm - c, 0)
    if pad:
        base = np.concatenate([base, np.full((t, pad), np.inf, np.float32)],
                              axis=1)
        pair = np.pad(pair, ((0, 0), (0, pad), (0, pad)),
                      constant_values=np.inf)
        valid = np.concatenate([valid, np.zeros((t, pad), bool)], axis=1)
        if forced is not None:
            forced = np.concatenate([forced, np.zeros((t, pad), bool)],
                                    axis=1)
    fc = np.zeros_like(valid) if forced is None else forced
    pos, kept = JK.select_neighbors_batch(
        jnp.asarray(base), jnp.asarray(pair), jnp.asarray(valid), lm,
        jnp.asarray(fc))
    return np.asarray(pos), np.asarray(kept)


def _port(base, pair, valid, forced, lm, fn=TS.select_neighbors_plain):
    pos, kept = fn(torch.from_numpy(base), torch.from_numpy(pair),
                   torch.from_numpy(valid), lm,
                   None if forced is None else torch.from_numpy(forced))
    return pos.numpy(), kept.numpy()


@pytest.mark.parametrize("t,c,lm", [(6, 5, 8), (6, 8, 8), (6, 33, 32),
                                    (8, 80, 32), (8, 64, 32), (5, 200, 16),
                                    (2, 1100, 32)])
@pytest.mark.parametrize("forced", [False, True])
def test_select_plain_equals_reference(t, c, lm, forced):
    """Positions (-1 padded) and kept flags equal bit for bit."""
    base, pair, valid, fc = select_case(c * 7 + lm + forced, t, c, forced)
    p0, k0 = _reference(base, pair, valid, fc, lm)
    p1, k1 = _port(base, pair, valid, fc, lm)
    assert p1.dtype == np.int32 and k1.dtype == bool
    assert p1.shape == (t, lm) and k1.shape == (t, lm)
    np.testing.assert_array_equal(p1, p0)
    np.testing.assert_array_equal(k1, k0)
    assert (p1[0] == -1).all() and not k1[0].any()  # the all-invalid row


def test_select_plain_caps_forced_in_pop_order():
    """The lm cap applies in pop order to forced candidates too: with
    every candidate forced, the lm closest are kept and no backfill
    follows; a forced candidate at +inf is not forced."""
    base = np.array([[5.0, 1.0, 3.0, np.inf, 2.0, 4.0]], np.float32)
    pair = np.zeros((1, 6, 6), np.float32)
    valid = np.ones((1, 6), bool)
    forced = np.ones((1, 6), bool)
    for lm in (3, 8):
        p0, k0 = _reference(base, pair, valid, forced, lm)
        p1, k1 = _port(base, pair, valid, forced, lm)
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_array_equal(k1, k0)
    assert p1[0, :5].tolist() == [1, 4, 2, 5, 0] and p1[0, 5:].tolist() \
        == [-1] * 3
    assert k1[0, :5].all() and not k1[0, 5:].any()


@pytest.mark.parametrize("forced", [False, True])
def test_select_wrappers_route_to_plain_on_cpu(forced):
    """The K3 wrapper and the name the build calls take the plain version
    for CPU tensors and launch nothing."""
    base, pair, valid, fc = select_case(5, 6, 40, forced)
    launches = TS.select_neighbors.launches
    p0, k0 = _port(base, pair, valid, fc, 16)
    for fn in (TS.select_neighbors, TK.select_neighbors):
        p1, k1 = _port(base, pair, valid, fc, 16, fn=fn)
        np.testing.assert_array_equal(p1, p0)
        np.testing.assert_array_equal(k1, k0)
    assert TK.select_neighbors is TS.select_neighbors
    assert TS.select_neighbors.launches == launches


def _gram(ip, sq, l2):
    return TS.Gram(torch.from_numpy(ip),
                   None if sq is None else torch.from_numpy(sq), l2)


@pytest.mark.parametrize("t,c,lm", [(6, 1, 8), (6, 5, 8), (6, 33, 32),
                                    (8, 64, 32), (8, 80, 32), (5, 200, 16),
                                    (2, 1100, 32)])
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("forced", [False, True])
def test_select_gram_plain_equals_formed_block(t, c, lm, l2, forced):
    """The Gram form's plain select equals the formed block's bit for
    bit, and form_pairs forms the numpy block's bits (NaN kept)."""
    base, ip, sq, valid, fc = gram_case(c + lm + 3 * l2 + forced, t, c, l2,
                                        forced)
    block = formed_block(ip, sq, valid)
    g = _gram(ip, sq, l2)
    np.testing.assert_array_equal(
        TS.form_pairs(g, torch.from_numpy(valid)).numpy(), block)
    p0, k0 = _port(base, block, valid, fc, lm)
    p1, k1 = TS.select_neighbors_plain(
        torch.from_numpy(base), g, torch.from_numpy(valid), lm,
        None if fc is None else torch.from_numpy(fc))
    np.testing.assert_array_equal(p1.numpy(), p0)
    np.testing.assert_array_equal(k1.numpy(), k0)
    assert k0.any() or c < 2


@pytest.mark.parametrize("t,c,lm", [(6, 33, 32), (8, 80, 32), (2, 1100, 32)])
@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("forced", [False, True])
def test_select_gram_equals_reference(t, c, lm, l2, forced):
    """The wrapper on the Gram form (the plain version on the CPU) against
    the reference's select on the block formed in numpy."""
    base, ip, sq, valid, fc = gram_case(c + lm + 3 * l2 + forced, t, c, l2,
                                        forced)
    p0, k0 = _reference(base, formed_block(ip, sq, valid), valid, fc, lm)
    launches = TS.select_neighbors.launches
    p1, k1 = TK.select_neighbors(
        torch.from_numpy(base), _gram(ip, sq, l2), torch.from_numpy(valid),
        lm, None if fc is None else torch.from_numpy(fc))
    assert TS.select_neighbors.launches == launches
    np.testing.assert_array_equal(p1.numpy(), p0)
    np.testing.assert_array_equal(k1.numpy(), k0)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_pair_block_is_the_gram_form(metric):
    """_pair_block gives dense L2 / IP / cosine pools their Gram form
    (the norms for L2 only), _pairwise_dists still forms the block it
    formed, and a select over either is the same."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(300, 16)).astype(np.float32)
    if metric == "COSINE":
        vals /= np.linalg.norm(vals, axis=1, keepdims=True)
    values = torch.from_numpy(vals)
    elems = torch.from_numpy(rng.integers(0, 300, size=(20, 40))
                             .astype(np.int32))
    elems[rng.random((20, 40)) < 0.1] = -1
    m = Metric[metric]
    g = TK._pair_block("dense", m, values, elems)
    assert isinstance(g, TS.Gram) and g.l2 == (metric == "L2")
    assert (g.sq is not None) == g.l2
    v = values[torch.clamp(elems, min=0).long()]
    assert torch.equal(g.ip, TK._gram(v))
    block = TK._pairwise_dists("dense", m, values, elems)
    ok = (elems[:, :, None] >= 0) & (elems[:, None, :] >= 0)
    if metric == "L2":
        sq = torch.sum(v * v, dim=-1)
        want = torch.clamp(sq[:, :, None] - 2.0 * g.ip + sq[:, None, :],
                           min=0.0)
    else:
        want = -g.ip
    assert torch.equal(block, torch.where(ok, want, torch.inf))
    base = torch.from_numpy(rng.random((20, 40)).astype(np.float32))
    a = TK._select_from(elems, base, g, 16)
    b = TK._select_from(elems, base, block, 16)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
