"""The int8 packed tier through both packages, on the CPU.

- The slab: on a reference-built graph (1,500 × 24, m 8) the port's
  per-dim scale and int8 slab equal the reference's ``_nbr_scale`` and
  ``_nbr_vals`` bit for bit, and its dequantized row norms the reference's
  ``_nbr_norm2`` within f32 reassociation (both sum 24 squares, in other
  orders), for L2 and for cosine (normalized values).
- The scorer: ``int8_point_scores`` (K2-int8's plain version) against the
  reference's ``_int8_point_scores`` on seeded blocks with -1 ids: inner
  product and cosine bit for bit (the cross term is an exact integer in
  both), L2 within f32 reassociation of |q|², L1 within that of its sum.
- Invalidation: an insert and a vacuum drop the slab with its scale and
  norms, and the next int8 scan rebuilds them over every value row, the
  new rows included, equal to the reference's after the same insert.
- The ``auto`` rule as a pure function on an 80 GB card, and the modes
  the port refuses.

Every input comes from its own seeded ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import InvalidParameterValue, Metric  # noqa: E402
from pgvector_tpu_torch.index.hnsw import auto_packed_dtype  # noqa: E402
from pgvector_tpu_torch.index.hnsw_kernels import (  # noqa: E402
    int8_point_scores)
from pgvector_tpu_torch.io.convert import table_from_numpy  # noqa: E402
from torch_hnsw_pairs import port_of  # noqa: E402

#: f32 reassociation of a sum of a few dozen terms (torch_parity's)
ATOL, RTOL = 1e-4, 1e-5


def _pair(metric, seed, n=1500, d=24):
    rng = np.random.default_rng(seed)
    db = (rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d)).astype(
        np.float32)
    jt = JTable(d)
    jt.insert(db)
    ref = JHNSW(jt, JMetric[metric], m=8, ef_construction=32, wave_size=256,
                beam_expand=4, dedup=False)
    tt = table_from_numpy(db, np.ones(n, bool), device="cpu")
    return db, jt, ref, tt, port_of(ref, tt)


def _slab(idx, dtype):
    idx._ensure_nbr_vals(dtype)
    return idx._nbr_vals, idx._nbr_scale, idx._nbr_norm2


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_int8_slab_matches_reference(metric):
    _, _, ref, _, port = _pair(metric, 40)
    v0, s0, n0 = (np.asarray(a) for a in _slab(ref, jnp.int8))
    v1, s1, n1 = (a.numpy() for a in _slab(port, torch.int8))
    n = ref.n_elems
    np.testing.assert_array_equal(s1, s0)
    np.testing.assert_array_equal(v1[:n], v0[:n])
    np.testing.assert_allclose(n1[:n], n0[:n], atol=ATOL, rtol=RTOL)
    assert v1.dtype == np.int8 and np.abs(v1).max() <= 127


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE", "L1"])
def test_int8_point_scores_match_reference(metric):
    rng = np.random.default_rng({"L2": 1, "IP": 2, "COSINE": 3, "L1": 4}[metric])
    q, w, d, rows = 9, 40, 48, 300
    qs = rng.normal(size=(q, d)).astype(np.float32)
    scale = (rng.uniform(0.01, 0.05, size=d)).astype(np.float32)
    v = rng.integers(-127, 128, size=(q, w, d)).astype(np.int8)
    pnorm2 = rng.uniform(1.0, 50.0, size=rows).astype(np.float32)
    nbrs = rng.integers(0, rows, size=(q, w)).astype(np.int32)
    nbrs[rng.random((q, w)) < 0.2] = -1
    d0 = np.asarray(JK._int8_point_scores(
        JMetric[metric], jnp.asarray(qs), jnp.asarray(scale),
        jnp.asarray(pnorm2), jnp.asarray(v), jnp.asarray(nbrs)))
    d1 = int8_point_scores(
        Metric[metric], torch.as_tensor(qs), torch.as_tensor(scale),
        torch.as_tensor(pnorm2), torch.as_tensor(v),
        torch.as_tensor(nbrs)).numpy()
    assert np.isinf(d1[nbrs < 0]).all() and np.isfinite(d1[nbrs >= 0]).all()
    if metric in ("IP", "COSINE"):
        np.testing.assert_array_equal(d1, d0)
    else:
        np.testing.assert_allclose(d1, d0, atol=ATOL, rtol=RTOL)


def _quantized(values):
    """The reference's int8 fill, in numpy: (scale, q8) of value rows."""
    vf = values.astype(np.float32)
    scale = np.maximum(np.abs(vf).max(axis=0), np.float32(1e-30)) \
        / np.float32(127.0)
    q8 = np.clip(np.round(vf / scale), -127, 127).astype(np.int8)
    return scale.astype(np.float32), q8


@pytest.mark.parametrize("change", ["insert", "vacuum"])
def test_int8_scale_follows_inserts_and_vacuum(change, monkeypatch):
    """An insert of rows larger than any before (dim 0 ten times over) and
    a vacuum after deletes each drop the int8 slab, its scale and norms;
    the next int8 scan rebuilds them over every value row: the scale
    covers the new rows, and the slab is the quantized values gathered by
    the current lists."""
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "int8")
    db, jt, ref, tt, port = _pair("L2", 41)
    q = db[:20] + 0.01
    port.search(q, 10, ef_search=40)
    old_scale = port._nbr_scale.clone()
    rng = np.random.default_rng(42)
    if change == "insert":
        new = rng.normal(size=(200, db.shape[1])).astype(np.float32)
        new[:, 0] *= 10 * np.abs(db[:, 0]).max()
        rows = tt.insert(new)
        assert (jt.insert(new) == rows).all()
        ref.insert(rows)
        port.insert(rows)
    else:
        dead = rng.choice(len(db), size=150, replace=False)
        tt.delete(dead)
        port.vacuum()
    assert port._nbr_vals is None and port._nbr_scale is None \
        and port._nbr_norm2 is None
    port.search(q, 10, ef_search=40)
    values = port.values.numpy()
    scale, q8 = _quantized(values)
    np.testing.assert_array_equal(port._nbr_scale.numpy(), scale)
    nbr0 = port.nbr0.numpy()
    np.testing.assert_array_equal(port._nbr_vals.numpy(),
                                  q8[np.maximum(nbr0, 0)])
    if change == "insert":
        assert port._nbr_scale[0] > 5 * old_scale[0]
        # the reference, after the same insert, quantizes with the same
        # scale
        _, s0, _ = _slab(ref, jnp.int8)
        np.testing.assert_array_equal(port._nbr_scale.numpy(),
                                      np.asarray(s0))


GB = 80 * 10**9


@pytest.mark.parametrize("shape,metric,total,want", [
    ((1 << 20, 16, 128), "L2", GB, torch.bfloat16),   # the 1M main path
    ((200_000, 16, 960), "L2", GB, torch.bfloat16),   # phase 9's table
    ((1 << 18, 16, 960), "L2", GB, torch.bfloat16),   # its capacity, 2^18
    ((1 << 20, 16, 960), "L2", GB, torch.int8),       # GIST-1M
    ((1 << 20, 16, 960), "COSINE", GB, torch.int8),
    ((1 << 20, 16, 960), "L1", GB, None),             # no dot form
    ((4 << 20, 16, 960), "L2", GB, None),             # over the card
    ((10_000, 16, 128), "L2", GB, torch.float32),
    # the reference's own chip (16 GiB): 200k x 960 in int8, 6.1 GB
    ((200_000, 16, 960), "L2", 16 * 2**30, torch.int8),
])
def test_auto_packed_dtype(shape, metric, total, want):
    assert auto_packed_dtype(*shape, Metric[metric], total) == want


@pytest.mark.parametrize("mode,msg", [("sketch", "left out of the port"),
                                      ("int4", "not a packed tier")])
def test_refused_packed_modes(mode, msg, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", mode)
    _, _, _, _, port = _pair("L2", 43, n=300)
    with pytest.raises(InvalidParameterValue, match=msg):
        port._packed_plan()
