"""The mesh paths of the port (``pgvector_tpu_torch.parallel``) against the
reference's (``pgvector_tpu.parallel``), on the CPU: the port on meshes of
``["cpu"] * S``, the reference on the same shapes of its virtual 8-device
CPU mesh (tests/conftest.py); inputs from each test's own seeded
``default_rng``.

Tolerances: f32 distances within ``torch_parity.ATOL`` / ``RTOL`` (atol
1e-4, rtol 1e-5: the two stacks sum the same products in other orders),
ids equal apart from ties inside that tolerance (``assert_same_topk``).
Where the port runs the same code on one device and on many (fan-out
against the 1-D mesh, replication against one index), ids and distances
are equal bit for bit.  ``jax.random`` cannot be matched, so the keyed
k-means step and ``train_centers_sharded`` are held by what they must
give (reseeds are samples, full probes are exhaustive) and by recall.
"""

import json
import os
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu import parallel as JP  # noqa: E402
from pgvector_tpu.errors import FeatureNotSupported as JFeature  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    BitTable, DataException, DenseTable, FeatureNotSupported, FlatIndex,
    HNSWIndex, IVFFlatIndex, Metric, SparseTable, SparseVec)
from pgvector_tpu_torch import parallel as TP  # noqa: E402
from pgvector_tpu_torch.runtime import BatchingExecutor  # noqa: E402
from torch_hnsw_pairs import recall  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

DENSE = ["L2", "IP", "COSINE", "L1"]


def _jmesh(n):
    """The reference's 1-D mesh over its first ``n`` virtual devices."""
    from jax.sharding import Mesh

    assert len(jax.devices()) >= 8, "tests need the virtual 8-device mesh"
    return Mesh(np.array(jax.devices()[:n]), ("shard",))


def _tmesh(n):
    return TP.make_mesh(n, devices=["cpu"] * n)


def _tables(db):
    jt = JTable(db.shape[1])
    jt.insert(db)
    tt = DenseTable(db.shape[1], device="cpu")
    tt.insert(db)
    return jt, tt


def _np(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_shard_rows_meshes_and_axes(monkeypatch):
    for n, s in ((0, 3), (7, 3), (100, 8), (1001, 4)):
        assert TP.shard_rows(n, s) == JP.shard_rows(n, s)
    m2 = TP.make_mesh2(2, 4, devices=["cpu"] * 8)
    assert m2.shape == dict(JP.make_mesh2(2, 4).shape)
    assert m2.axis_names == ("shard", "qp") and m2.size == 8
    assert TP.make_mesh(3, devices=["cpu"] * 8).shape == {"shard": 3}
    with pytest.raises(ValueError, match="needs 8 devices"):
        TP.make_mesh2(4, 2, devices=["cpu"] * 4)
    # no card and no devices: an error, never a quiet CPU mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DataException, match="no CUDA device"):
        TP.make_mesh()
    with pytest.raises(DataException, match="no CUDA device"):
        TP.make_mesh2(2, 2)
    # an unknown query axis, in both packages
    rng = np.random.default_rng(1)
    jt, tt = _tables(rng.normal(size=(32, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="no axis"):
        JP.DeviceShardedHNSWIndex(JP.make_mesh(2), jt, JMetric.L2,
                                  qaxis="qp", m=4, ef_construction=16,
                                  wave_size=32)
    for cls, kw in ((TP.DeviceShardedHNSWIndex, dict(m=4, ef_construction=16,
                                                     wave_size=32)),
                    (TP.DeviceShardedIVFFlatIndex, dict(lists=2))):
        with pytest.raises(ValueError, match="no axis"):
            cls(_tmesh(2), tt, Metric.L2, qaxis="qp", **kw)


# ---------------------------------------------------------------------------
# exact search, row- and dim-sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", DENSE)
def test_sharded_exact_matches_reference(metric):
    rng = np.random.default_rng(11)
    db = rng.normal(size=(603, 24)).astype(np.float32)  # 603 % 8 != 0
    q = rng.normal(size=(9, 24)).astype(np.float32)
    valid = rng.random(603) > 0.1
    for k in (10, 100):  # 100 > a shard's 76 rows
        d0, i0 = JP.sharded_exact_search(
            _jmesh(8), JMetric[metric], jnp.asarray(db), jnp.asarray(q), k,
            valid=jnp.asarray(valid))
        d1, i1 = TP.sharded_exact_search(
            _tmesh(8), Metric[metric], torch.as_tensor(db), q, k,
            valid=torch.as_tensor(valid))
        assert i1.dtype == torch.int32 and tuple(d1.shape) == (9, k)
        assert_same_topk(_np(d0), _np(i0), _np(d1), _np(i1))
        assert not np.isin(_np(i1), np.flatnonzero(~valid)).any()


def test_sharded_flat_index_matches_reference():
    """ShardedFlatIndex over a table with a deleted row (operator
    distances), and k past the table's rows padded with inf / -1."""
    rng = np.random.default_rng(12)
    db = rng.normal(size=(500, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    jt, tt = _tables(db)
    jt.delete([3])
    tt.delete([3])
    d0, i0 = JP.ShardedFlatIndex(_jmesh(8), jt, JMetric.L2).search(q, 5)
    idx = TP.ShardedFlatIndex(_tmesh(8), tt, Metric.L2)
    d1, i1 = idx.search(q, 5)
    assert_same_topk(d0, i0, d1, i1)
    e_d, e_i = FlatIndex(tt, Metric.L2).search(q, 5)
    assert_same_topk(e_d, e_i, d1, i1)
    d, i = idx.search(db[:3], 600)
    assert d.shape == (3, 600)
    assert (i[:, 499:] == -1).all() and np.isinf(d[:, 499:]).all()


@pytest.mark.parametrize("metric", DENSE)
def test_dim_sharded_matches_reference(metric):
    rng = np.random.default_rng(13)
    db = rng.normal(size=(400, 37)).astype(np.float32)  # 37 % 8 != 0
    q = rng.normal(size=(9, 37)).astype(np.float32)
    d0, i0 = JP.dim_sharded_exact_search(_jmesh(8), JMetric[metric],
                                         jnp.asarray(db), jnp.asarray(q), 10)
    d1, i1 = TP.dim_sharded_exact_search(_tmesh(8), Metric[metric], db, q, 10)
    assert_same_topk(_np(d0), _np(i0), _np(d1), _np(i1))
    # and against the port's single-device exact scan (stored distances)
    tt = DenseTable(37, device="cpu")
    tt.insert(db)
    e_d, e_i = FlatIndex(tt, Metric[metric]).search(q, 10)
    d1 = _np(d1)
    assert_same_topk(e_d, e_i, np.sqrt(d1) if metric == "L2" else d1,
                     _np(i1))


def test_dim_sharded_validity_and_k_overflow():
    rng = np.random.default_rng(14)
    db = rng.normal(size=(6, 16)).astype(np.float32)
    valid = np.array([True, False, True, True, False, True])
    d0, i0 = JP.dim_sharded_exact_search(
        _jmesh(8), JMetric.L2, jnp.asarray(db), jnp.asarray(db[:2]), 8,
        valid=jnp.asarray(valid))
    d1, i1 = TP.dim_sharded_exact_search(_tmesh(8), Metric.L2, db, db[:2], 8,
                                         valid=valid)
    assert_same_topk(_np(d0), _np(i0), _np(d1), _np(i1))
    i1 = _np(i1)
    assert not np.isin(i1, [1, 4]).any()
    assert (i1[:, 4:] == -1).all()  # four live rows; the rest padded


def test_bit_metrics_refused():
    db = np.zeros((4, 8), np.float32)
    with pytest.raises(JFeature, match="decompose"):
        JP.dim_sharded_exact_search(_jmesh(8), JMetric.HAMMING,
                                    jnp.asarray(db), jnp.asarray(db[:1]), 2)
    with pytest.raises(FeatureNotSupported, match="decompose"):
        TP.dim_sharded_exact_search(_tmesh(8), Metric.HAMMING, db, db[:1], 2)
    for m in (Metric.HAMMING, Metric.JACCARD):
        with pytest.raises(ValueError, match="not a dense metric"):
            TP.sharded_exact_search(_tmesh(8), m, db, db[:1], 2)


# ---------------------------------------------------------------------------
# sharded k-means
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spherical", [False, True])
def test_sharded_kmeans_step_matches_reference(spherical):
    rng = np.random.default_rng(15)
    data = rng.normal(size=(803, 8)).astype(np.float32)
    # two centers far outside the data get no members: they keep theirs
    cs = np.vstack([data[:8], 500.0 + np.zeros((2, 8), np.float32)])
    ref = np.asarray(JP.sharded_kmeans_step(
        _jmesh(8), jnp.asarray(data), jnp.asarray(cs), spherical=spherical))
    got = TP.sharded_kmeans_step(_tmesh(8), data, cs, spherical=spherical)
    np.testing.assert_allclose(_np(got), ref, atol=1e-4, rtol=1e-5)
    if not spherical:
        np.testing.assert_array_equal(_np(got)[8:], cs[8:])


def test_sharded_kmeans_reseeds_and_trains():
    rng = np.random.default_rng(16)
    data = rng.normal(size=(800, 8)).astype(np.float32)
    cs = np.vstack([data[:8], 500.0 + np.zeros((2, 8), np.float32)])
    g = torch.Generator().manual_seed(3)
    new = _np(TP.sharded_kmeans_step(_tmesh(8), data, cs, key=g))
    for j in (8, 9):  # reseeded from actual samples
        assert np.any(np.all(data == new[j][None, :], axis=1))
    # train_centers_sharded through IVFFlatIndex(mesh=...): full probes are
    # exhaustive, and recall at 4 of 16 probes stays near the reference's
    db = rng.normal(size=(3000, 8)).astype(np.float32)
    q = rng.normal(size=(40, 8)).astype(np.float32)
    jt, tt = _tables(db)
    port = IVFFlatIndex(tt, Metric.L2, lists=16, seed=1, mesh=_tmesh(8))
    ref = JIVF(jt, JMetric.L2, lists=16, seed=1, mesh=_jmesh(8))
    assert port.kmeans_iters >= 1
    e_d, e_i = FlatIndex(tt, Metric.L2).search(q, 10)
    d, i = port.search(q, 10, probes=16)
    assert_same_topk(e_d, e_i, d, i)
    rec_port = recall(port.search(q, 10, probes=4)[1], e_i)
    rec_ref = recall(ref.search(q, 10, probes=4)[1], e_i)
    assert rec_port >= rec_ref - 0.05, (rec_port, rec_ref)
    assert rec_port >= 0.8, rec_port
    c = TP.train_centers_sharded(_tmesh(8), db[:200], 16, seed=2)
    assert tuple(c.shape) == (16, 8) and torch.isfinite(c).all()


# ---------------------------------------------------------------------------
# device-sharded indexes across packages
# ---------------------------------------------------------------------------

HNSW_KW = dict(m=8, ef_construction=32, wave_size=256, dedup=False)


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    """The reference's 4-shard HNSW and IVFFlat over 1,200 rows, and their
    sharded checkpoints."""
    rng = np.random.default_rng(17)
    db = rng.normal(size=(1400, 12)).astype(np.float32)
    q = np.concatenate([db[:6] + 0.01,
                        rng.normal(size=(10, 12)).astype(np.float32)])
    jt, tt = _tables(db[:1200])
    h = JP.DeviceShardedHNSWIndex(_jmesh(4), jt, JMetric.L2, seed=1,
                                  **HNSW_KW)
    iv = JP.DeviceShardedIVFFlatIndex(_jmesh(4), jt, JMetric.L2, lists=8,
                                      seed=1)
    path = tmp_path_factory.mktemp("sharded")
    h.save(str(path / "h"))
    iv.save(str(path / "iv"))
    return dict(db=db, q=q, jt=jt, tt=tt, h=h, iv=iv, path=path)


def test_load_reference_sharded_checkpoints(ref_sharded, monkeypatch):
    """The reference's sharded_hnsw / sharded_ivfflat checkpoints load
    into the port and answer as the reference does: HNSW with the
    reference's hash2 visited set (whatever PGVECTOR_TPU_VISITED says),
    IVF at probes below the list count."""
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")
    r = ref_sharded
    h = TP.DeviceShardedHNSWIndex.load(_tmesh(4), r["tt"],
                                       str(r["path"] / "h"))
    iv = TP.DeviceShardedIVFFlatIndex.load(_tmesh(4), r["tt"],
                                           str(r["path"] / "iv"))
    assert [len(g) for g in h.g_rows] == [300] * 4
    for ef in (10, 40):
        d0, i0 = r["h"].search(r["q"], 10, ef_search=ef)
        d1, i1 = h.search(r["q"], 10, ef_search=ef)
        assert_same_topk(d0, i0, d1, i1)
    for probes in (2, 8):
        d0, i0 = r["iv"].search(r["q"], 10, probes=probes)
        d1, i1 = iv.search(r["q"], 10, probes=probes)
        assert_same_topk(d0, i0, d1, i1)


def test_port_sharded_save_loads_in_reference(ref_sharded, tmp_path):
    r = ref_sharded
    h = TP.DeviceShardedHNSWIndex(_tmesh(4), r["tt"], Metric.L2, seed=2,
                                  **HNSW_KW)
    iv = TP.DeviceShardedIVFFlatIndex(_tmesh(4), r["tt"], Metric.L2, lists=8,
                                      seed=2)
    h.save(str(tmp_path / "h"))
    iv.save(str(tmp_path / "iv"))
    with open(tmp_path / "h" / "manifest.json") as f:
        man = json.load(f)
    assert man["object"] == "sharded_hnsw" and man["n_shards"] == 4
    jh = JP.DeviceShardedHNSWIndex.load(_jmesh(4), r["jt"],
                                        str(tmp_path / "h"))
    jiv = JP.DeviceShardedIVFFlatIndex.load(_jmesh(4), r["jt"],
                                            str(tmp_path / "iv"))
    d0, i0 = jh.search(r["q"], 10, ef_search=40)
    d1, i1 = h.search(r["q"], 10, ef_search=40)
    assert_same_topk(d0, i0, d1, i1)
    d0, i0 = jiv.search(r["q"], 10, probes=3)
    d1, i1 = iv.search(r["q"], 10, probes=3)
    assert_same_topk(d0, i0, d1, i1)


def test_insert_routing_and_vacuum_match_reference(ref_sharded, tmp_path):
    """From the same state (the reference's checkpoints), an insert sends
    each new row to the shard the reference sends it to; after deletes
    and a vacuum neither package returns a dead row and both keep their
    recall."""
    r = ref_sharded
    from pgvector_tpu_torch.io import checkpoint

    jt = JTable(12)
    jt.insert(r["db"][:1200])
    tt = DenseTable(12, device="cpu")
    tt.insert(r["db"][:1200])
    jh = JP.DeviceShardedHNSWIndex.load(_jmesh(4), jt, str(r["path"] / "h"))
    jiv = JP.DeviceShardedIVFFlatIndex.load(_jmesh(4), jt,
                                            str(r["path"] / "iv"))
    h = TP.DeviceShardedHNSWIndex.load(_tmesh(4), tt, str(r["path"] / "h"))
    iv = TP.DeviceShardedIVFFlatIndex.load(_tmesh(4), tt,
                                           str(r["path"] / "iv"))
    # three rows into the HNSW shards first: the next batch then starts
    # from the least-loaded shard, not shard 0
    rows_a = jt.insert(r["db"][1200:1203])
    np.testing.assert_array_equal(tt.insert(r["db"][1200:1203]), rows_a)
    jh.insert(rows_a)
    h.insert(rows_a)
    rows_b = jt.insert(r["db"][1203:])
    np.testing.assert_array_equal(tt.insert(r["db"][1203:]), rows_b)
    jh.insert(rows_b)
    h.insert(rows_b)
    jiv.insert(np.concatenate([rows_a, rows_b]))
    iv.insert(np.concatenate([rows_a, rows_b]))
    for a, b in ((jh, h), (jiv, iv)):
        for ga, gb in zip(a.g_rows, b.g_rows):
            np.testing.assert_array_equal(np.asarray(ga), gb)
        assert [s.count for s in a.subs] == [s.count for s in b.subs]
    dead = np.arange(0, 1400, 7)
    jt.delete(dead)
    tt.delete(dead)
    for a, b in ((jh, h), (jiv, iv)):
        a.vacuum()
        b.vacuum()
    e_d, e_i = FlatIndex(tt, Metric.L2).search(r["q"], 10)
    _, i0 = jh.search(r["q"], 10, ef_search=60)
    _, i1 = h.search(r["q"], 10, ef_search=60)
    for i in (i0, i1):
        assert not np.isin(i, dead).any()
    assert recall(i1, e_i) >= recall(i0, e_i) - 0.05
    assert recall(i1, e_i) >= 0.85
    d0, i0 = jiv.search(r["q"], 10, probes=8)
    d1, i1 = iv.search(r["q"], 10, probes=8)
    assert_same_topk(e_d, e_i, d1, i1)  # all probes: exhaustive
    assert_same_topk(d0, i0, d1, i1)
    assert not np.isin(i1, dead).any()
    # the routed rows are reachable through a saved and loaded replica
    h.save(str(tmp_path / "h"))
    h2 = TP.DeviceShardedHNSWIndex.load(_tmesh(4), tt, str(tmp_path / "h"))
    live = np.setdiff1d(np.arange(1205, 1215), dead)[:4]
    _, rh = h2.search(r["db"][live], 5, ef_search=60)
    assert (rh[:, 0] == live).all()
    with open(os.path.join(tmp_path, "h", "manifest.json")) as f:
        assert json.load(f)["magic"] == checkpoint.MAGIC


# ---------------------------------------------------------------------------
# query fan-out (2-D meshes) and the executor
# ---------------------------------------------------------------------------


def test_fanout_equals_1d_bit_for_bit(monkeypatch):
    """A (2 shards × 4 replicas) mesh returns exactly what the 2-shard 1-D
    mesh returns, HNSW and IVFFlat, a batch that does not split evenly;
    shard=1 × replica=8 is one HNSW index replicated and equals it."""
    rng = np.random.default_rng(18)
    db = rng.normal(size=(1200, 12)).astype(np.float32)
    q = rng.normal(size=(13, 12)).astype(np.float32)
    _, tt = _tables(db)
    kw = dict(HNSW_KW, seed=3)
    m1, m2 = _tmesh(2), TP.make_mesh2(2, 4, devices=["cpu"] * 8)
    base = TP.DeviceShardedHNSWIndex(m1, tt, Metric.L2, **kw)
    fan = TP.DeviceShardedHNSWIndex(m2, tt, Metric.L2, qaxis="qp", **kw)
    d1, r1 = base.search(q, 10, ef_search=60)
    d2, r2 = fan.search(q, 10, ef_search=60)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)
    ib = TP.DeviceShardedIVFFlatIndex(m1, tt, Metric.L2, lists=8, seed=1)
    ifan = TP.DeviceShardedIVFFlatIndex(m2, tt, Metric.L2, lists=8, seed=1,
                                        qaxis="qp")
    d1, r1 = ib.search(q, 10, probes=4)
    d2, r2 = ifan.search(q, 10, probes=4)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)
    # pure replication against the single index, both scanning with hash2
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "hash2")
    single = HNSWIndex(tt, Metric.L2, **kw)
    rep = TP.DeviceShardedHNSWIndex(TP.make_mesh2(1, 8, devices=["cpu"] * 8),
                                    tt, Metric.L2, qaxis="qp", **kw)
    d1, r1 = single.search(q, 10, ef_search=60)
    d2, r2 = rep.search(q, 10, ef_search=60)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)


def test_executor_over_fanout_index():
    """BatchingExecutor batches concurrent callers into one search, the
    2-D mesh splits it over replica columns, and a write (delete +
    vacuum) serializes between read batches."""
    rng = np.random.default_rng(19)
    db = rng.normal(size=(800, 8)).astype(np.float32)
    _, tt = _tables(db)
    idx = TP.DeviceShardedHNSWIndex(TP.make_mesh2(2, 4, devices=["cpu"] * 8),
                                    tt, Metric.L2, m=8, ef_construction=32,
                                    wave_size=128, qaxis="qp", seed=7)
    ex = BatchingExecutor(idx, max_batch=32, max_wait_ms=1.0, ef_search=40)
    try:
        futs = [ex.submit(db[i], 5) for i in range(48)]
        wf = ex.submit_write(lambda ix: (tt.delete(np.arange(8)),
                                         ix.vacuum()))
        futs += [ex.submit(db[i], 5) for i in range(48, 96)]
        done, _ = wait(futs + [wf], timeout=120)
        assert len(done) == len(futs) + 1
        wf.result(timeout=10)
        for i, f in enumerate(futs):
            _, r = f.result(timeout=10)
            assert int(r[0]) == i or i < 8  # self-hit unless deleted
        _, r = ex.search(db[3], 5, timeout=60)
        assert not np.isin(r, np.arange(8)).any()
    finally:
        ex.shutdown()
    assert not ex._thread.is_alive()


# ---------------------------------------------------------------------------
# host fan-out wrappers over every table kind
# ---------------------------------------------------------------------------


def test_sharded_wrappers_dense_bit_and_sparse():
    rng = np.random.default_rng(20)
    db = rng.normal(size=(2000, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    _, tt = _tables(db)
    e_d, e_i = FlatIndex(tt, Metric.L2).search(q, 10)
    d, i = TP.ShardedIVFFlatIndex(tt, Metric.L2, n_shards=4, lists=8,
                                  seed=1).search(q, 10, probes=8)
    assert_same_topk(e_d, e_i, d, i)  # full probes on every shard
    sh = TP.ShardedHNSWIndex(tt, Metric.L2, n_shards=2, m=8,
                             ef_construction=32, wave_size=128, seed=1)
    _, r = sh.search(q, 10, ef_search=60)
    assert recall(r, e_i) >= 0.9
    bits = rng.random((600, 64)) > 0.5
    bt = BitTable(64, device="cpu")
    rows = bt.insert(bits)
    bt.delete(rows[:10])
    sb = TP.ShardedHNSWIndex(bt, Metric.HAMMING, n_shards=2, m=8,
                             ef_construction=32, wave_size=128, seed=1)
    d, i = sb.search(bits[20:24], 5)
    assert not np.isin(i, rows[:10]).any()
    assert (i[:, 0] == np.arange(20, 24)).all() and (d[:, 0] == 0).all()
    svs = [SparseVec(32, np.sort(rng.choice(32, 4, replace=False)),
                     rng.normal(size=4).astype(np.float32))
           for _ in range(400)]
    st = SparseTable(32, nnz_cap=8, device="cpu")
    st.insert(svs)
    ss = TP.ShardedHNSWIndex(st, Metric.L2, n_shards=2, m=8,
                             ef_construction=32, wave_size=128, seed=1)
    # rows as their own queries (a few of these sparse rows are reachable
    # from almost no list, in the reference's graph too): self-matches
    # and recall against the exact scan
    rows = np.r_[0:40, 300:340]
    qv = [svs[j] for j in rows]
    d, i = ss.search(qv, 5)
    assert np.mean((i[:, 0] == rows) & (d[:, 0] <= 1e-5)) >= 0.95
    _, e_i = FlatIndex(st, Metric.L2).search(qv, 5)
    assert recall(i, e_i) >= 0.95


def test_device_sharded_ivf_chunked_rescore_matches():
    """The per-shard candidate re-score streams chunks under
    SEARCH_CHUNK_BYTES; a tiny budget gives the same result."""
    from pgvector_tpu_torch.parallel import sharded as sh

    rng = np.random.default_rng(21)
    db = rng.normal(size=(2000, 16)).astype(np.float32)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    _, tt = _tables(db)
    idx = sh.DeviceShardedIVFFlatIndex(_tmesh(8), tt, Metric.L2, lists=16,
                                       seed=2)
    d1, r1 = idx.search(q, 10, probes=16)
    old = sh.SEARCH_CHUNK_BYTES
    try:
        sh.SEARCH_CHUNK_BYTES = 4096  # many chunks at (6, 16)
        d2, r2 = idx.search(q, 10, probes=16)
    finally:
        sh.SEARCH_CHUNK_BYTES = old
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)
    e_d, e_i = FlatIndex(tt, Metric.L2).search(q, 10)
    assert_same_topk(e_d, e_i, d1, r1)
