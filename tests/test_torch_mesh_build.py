"""The mesh build and the reference's last knobs, on the CPU.

- Mesh build: ``HNSWIndex(build_mesh=...)`` over ``["cpu"] * 8`` gives
  the port's single-device graph bit for bit (``nbr0``, ``nbr_up``, the
  kept flags, levels, entry point) for dense, bit and sparse tables and a
  small seed sweep, online inserts included; and at least 95 % of its
  level-0 lists equal, as sets, the reference's mesh build on its virtual
  8-device mesh (the port's single-device build holds the same share
  against the reference's, tests/test_torch_hnsw.py).
- Knobs, each under the same environment variable in both packages, on a
  graph the reference built and the port loaded: ``PGVECTOR_TPU_VISITED``
  (``hash1`` and ``hash2``; row gathers and the f32 packed slab) and
  ``PGVECTOR_TPU_QUERY_MAX_STEPS`` give the reference's ids apart from
  ties, distances within rtol 1e-5, and its layer-0 hop count;
  ``PGVECTOR_TPU_L_UNROLL`` clamps as the reference's does;
  ``PGVECTOR_TPU_WAVE_SYNC_EVERY`` and ``PGVECTOR_TPU_PHASE_SYNC`` leave
  the built graph unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    BitTable, DenseTable, HNSWIndex, Metric, SparseTable, SparseVec)
from pgvector_tpu_torch.index import hnsw_kernels as K  # noqa: E402
from pgvector_tpu_torch.index.hnsw import L_MAX  # noqa: E402
from pgvector_tpu_torch.parallel import make_mesh  # noqa: E402
from pgvector_tpu_torch.utils.telemetry import timers  # noqa: E402
from torch_hnsw_pairs import port_of, same_lists  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

#: a wave of 128 gives each of 8 devices 16 queries (SHARD_MIN_QUERIES)
BUILD_KW = dict(m=8, ef_construction=32, wave_size=128, dedup=False)
LEVEL0_SAME = 0.95


def _mesh():
    return make_mesh(8, devices=["cpu"] * 8)


def _fresh_table(kind, seed, n=700):
    """A fresh random dataset per (kind, seed), as the reference's sweep."""
    rng = np.random.default_rng(seed)
    if kind == "bit":
        table = BitTable(96, capacity=1024, device="cpu")
        table.insert(rng.random((n, 96)) > 0.5)
        return table, Metric.HAMMING
    if kind == "dense":
        table = DenseTable(16, capacity=1024, device="cpu")
        table.insert(rng.normal(size=(n, 16)).astype(np.float32))
        return table, Metric.L2
    dim, nnz = 120, 8
    sidx = np.sort(np.argpartition(rng.random((n, dim)), nnz,
                                   axis=1)[:, :nnz], axis=1).astype(np.int32)
    sval = rng.normal(size=(n, nnz)).astype(np.float32)
    sval[sval == 0] = 1.0
    table = SparseTable(dim, nnz_cap=nnz, capacity=1024, device="cpu")
    table.insert([SparseVec(dim, sidx[i], sval[i], _checked=True)
                  for i in range(n)])
    return table, Metric.IP


def _assert_same_graph(a, b):
    for name in ("nbr0", "nbr_up", "kept0", "kept_up"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.levels, b.levels)
    assert (a.entry, a.entry_level) == (b.entry, b.entry_level)


@pytest.mark.parametrize("kind,seed", [("dense", 1000), ("dense", 1002),
                                       ("bit", 1002), ("bit", 1004),
                                       ("sparse", 1002), ("sparse", 1004)])
def test_mesh_build_bit_identical(kind, seed):
    table, metric = _fresh_table(kind, seed)
    one = HNSWIndex(table, metric, seed=9, **BUILD_KW)
    calls = []
    orig = K.connect_level_sharded

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    K.connect_level_sharded = spy
    try:
        par = HNSWIndex(table, metric, seed=9, build_mesh=_mesh(), **BUILD_KW)
    finally:
        K.connect_level_sharded = orig
    assert calls, "the mesh connect ran"
    _assert_same_graph(one, par)


def test_mesh_build_inserts_and_reference_lists():
    """Online inserts keep the mesh-built graph equal to the single-device
    one, and the mesh build's level-0 lists match the reference's mesh
    build on the same data and seed."""
    rng = np.random.default_rng(21)
    db = rng.normal(size=(1500, 16)).astype(np.float32)
    jt = JTable(16, capacity=2048)
    jt.insert(db[:1200])
    ref = JHNSW(jt, JMetric.L2, seed=4, build_mesh=jax.sharding.Mesh(
        np.array(jax.devices()[:8]), ("shard",)), **BUILD_KW)
    table = DenseTable(16, capacity=2048, device="cpu")
    table.insert(db[:1200])
    one = HNSWIndex(table, Metric.L2, seed=4, **BUILD_KW)
    par = HNSWIndex(table, Metric.L2, seed=4, build_mesh=_mesh(), **BUILD_KW)
    _assert_same_graph(one, par)
    n = ref.n_elems
    np.testing.assert_array_equal(par.levels[:n], ref.levels[:n])
    share = same_lists(par.nbr0[:n].numpy(), np.asarray(ref.nbr0[:n]))
    assert share >= LEVEL0_SAME, share
    rows = table.insert(db[1200:])
    one.insert(rows)
    par.insert(rows)
    _assert_same_graph(one, par)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    d1, r1 = one.search(q, 5, ef_search=40)
    d2, r2 = par.search(q, 5, ef_search=40)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)


# ---------------------------------------------------------------------------
# the knobs, on a reference-built graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(22)
    db = rng.normal(size=(2000, 16)).astype(np.float32)
    q = np.concatenate([db[:10] + 0.01,
                        rng.normal(size=(20, 16)).astype(np.float32)])
    jt = JTable(16)
    jt.insert(db)
    ref = JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=256,
                beam_expand=4, dedup=False)
    table = DenseTable(16, device="cpu")
    table.insert(db)
    return dict(db=db, q=q, ref=ref, port=port_of(ref, table))


@pytest.mark.parametrize("packed", ["off", "f32"])
@pytest.mark.parametrize("vmode", ["hash1", "hash2"])
def test_visited_modes_match_reference(graph, vmode, packed, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", vmode)
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", packed)
    assert K.visited_mode() == vmode
    for ef in (16, 48):
        d0, r0 = graph["ref"].search(graph["q"], 10, ef_search=ef)
        d1, r1 = graph["port"].search(graph["q"], 10, ef_search=ef)
        assert_same_topk(d0, r0, d1, r1, atol=1e-6, rtol=1e-5)
        assert graph["port"]._last_scan_steps == int(
            graph["ref"]._last_scan_steps)
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "hash3")
    with pytest.raises(ValueError, match="PGVECTOR_TPU_VISITED"):
        K.visited_mode()


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_query_max_steps_matches_reference(graph, steps, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "off")
    monkeypatch.setenv("PGVECTOR_TPU_QUERY_MAX_STEPS", str(steps))
    d0, r0 = graph["ref"].search(graph["q"], 10, ef_search=40)
    d1, r1 = graph["port"].search(graph["q"], 10, ef_search=40)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6, rtol=1e-5)
    hops = graph["port"]._last_scan_steps
    assert hops == int(graph["ref"]._last_scan_steps) and hops <= steps


def test_l_unroll_env_clamped(monkeypatch):
    """The reference's clamp (its own build at 99, which compiles once;
    the other values follow the same min(L_MAX, max(1, value)))."""
    for env, want in (("99", L_MAX), ("0", 1), ("3", 3)):
        monkeypatch.setenv("PGVECTOR_TPU_L_UNROLL", env)
        t = DenseTable(4, device="cpu")
        t.insert(np.zeros((4, 4), np.float32))
        idx = HNSWIndex(t, Metric.L2, m=4, ef_construction=16, dedup=False)
        assert idx._l_unroll == want and idx.nbr_up.shape[1] == want
        if env == "99":
            jt = JTable(4)
            jt.insert(np.zeros((4, 4), np.float32))
            ref = JHNSW(jt, JMetric.L2, m=4, ef_construction=16,
                        dedup=False)
            assert ref._l_unroll == want


def test_sync_knobs_leave_the_graph_unchanged(monkeypatch, capsys):
    rng = np.random.default_rng(23)
    table = DenseTable(16, device="cpu")
    table.insert(rng.normal(size=(900, 16)).astype(np.float32))
    base = HNSWIndex(table, Metric.L2, seed=5, **BUILD_KW)
    monkeypatch.setenv("PGVECTOR_TPU_WAVE_SYNC_EVERY", "2")
    monkeypatch.setenv("PGVECTOR_TPU_PHASE_SYNC", "1")
    timers.enabled = True
    try:
        synced = HNSWIndex(table, Metric.L2, seed=5, **BUILD_KW)
    finally:
        timers.enabled = False
    _assert_same_graph(base, synced)
    err = capsys.readouterr().err
    assert "hnsw build: wave 2/8" in err and "hnsw build: wave 6/8" in err
