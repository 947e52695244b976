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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.ops import select_neighbors as TS  # noqa: E402
from torch_parity import select_case  # noqa: E402


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
