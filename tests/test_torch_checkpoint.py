"""Checkpoints shared by both packages, on the CPU.

The port's ``io.checkpoint`` writes and reads the reference's directory
format (manifest with magic, version and epoch; epoch-tagged ``.npy``
files; bfloat16 arrays as uint16 under the ``.bf16`` tag).  Each way
round, one package saves a dense table, an HNSW graph (with or without
heap-TID dedup, incremental backlinks, vacuumed) or an IVFFlat index, and
the other loads it with the same bookkeeping and answers the same queries
with the same ids apart from ties (distances within atol 1e-6).  The same
holds for bit and sparse tables, Hamming and sparse inner-product graphs
and bit IVFFlat indexes; bit words travel as the reference's uint32.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.io import checkpoint as jck  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import BitTable as JBitTable  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu.store.table import SparseTable as JSparseTable  # noqa: E402
from pgvector_tpu.types import SparseVec as JSparseVec  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    BitTable, DataException, DenseTable, FeatureNotSupported, HNSWIndex,
    IVFFlatIndex, Metric, SparseTable, SparseVec)
from pgvector_tpu_torch.io import checkpoint as tck  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

K = 10
DTYPES = ["float32", "bfloat16", "float16"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    db = rng.normal(size=(1200, 8)).astype(np.float32)
    q = np.concatenate([db[:10] + 0.01,
                        rng.normal(size=(10, 8)).astype(np.float32)])
    return db, q


@pytest.fixture
def hnsw_env(monkeypatch):
    """Both packages scan rows (no packed slab cache), visited set off."""
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "off")
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")


def _ref_table(db, dtype="float32", dead=()):
    jt = JTable(db.shape[1], dtype=jnp.dtype(dtype))
    jt.insert(db)
    if len(dead):
        jt.delete(np.asarray(dead))
    return jt


def _port_table(db, dtype="float32", dead=()):
    tt = DenseTable(db.shape[1], dtype=getattr(torch, dtype), device="cpu")
    tt.insert(db)
    if len(dead):
        tt.delete(np.asarray(dead))
    return tt


def _assert_same_table(jt, tt):
    assert (tt.count, tt.dim) == (jt.count, jt.dim)
    assert str(tt.dtype).replace("torch.", "") == str(np.dtype(jt.dtype))
    np.testing.assert_array_equal(
        tt.data[: tt.count].float().numpy(),
        np.asarray(jt.data[: jt.count]).astype(np.float32))
    np.testing.assert_array_equal(tt.valid[: tt.count].numpy(),
                                  np.asarray(jt.valid[: jt.count]))


# ------------------------------------------------------------ tables
@pytest.mark.parametrize("dtype", DTYPES)
def test_table_reference_to_port(data, dtype, tmp_path):
    db, _ = data
    jt = _ref_table(db, dtype, dead=[3, 500, 1199])
    jck.save_table(jt, str(tmp_path))
    tt = tck.load_table(str(tmp_path), device="cpu")
    _assert_same_table(jt, tt)
    assert tt.device.type == "cpu"


@pytest.mark.parametrize("dtype", DTYPES)
def test_table_port_to_reference(data, dtype, tmp_path):
    db, _ = data
    tt = _port_table(db, dtype, dead=[0, 7, 800])
    tck.save_table(tt, str(tmp_path))
    if dtype == "bfloat16":
        assert os.path.exists(tmp_path / "data.1.bf16.npy")
    _assert_same_table(jck.load_table(str(tmp_path)), tt)


# ------------------------------------------------------------ HNSW
def _ref_hnsw(jt):
    return JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=256,
                 beam_expand=4, dedup=False)


def test_hnsw_reference_to_port(data, tmp_path, hnsw_env):
    db, q = data
    ref = _ref_hnsw(_ref_table(db))
    jck.save_hnsw(ref, str(tmp_path))
    port = tck.load_hnsw(_port_table(db), str(tmp_path))
    assert port.n_elems == ref.n_elems and port.entry == ref.entry
    np.testing.assert_array_equal(port.levels[: port.n_elems],
                                  ref.levels[: ref.n_elems])
    d0, r0 = ref.search(q, K, ef_search=40)
    d1, r1 = port.search(q, K, ef_search=40)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6)
    # the level draws go on where the saved index stopped
    assert port._rng.random() == ref._rng.random()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hnsw_port_to_reference(data, dtype, tmp_path, hnsw_env):
    """A bf16 table's graph stores bf16 values (the ``.bf16`` tag)."""
    db, q = data
    tt = _port_table(db, dtype)
    port = HNSWIndex(tt, Metric.L2, m=8, ef_construction=32, wave_size=256,
                     beam_expand=4, dedup=False)
    tck.save_hnsw(port, str(tmp_path))
    assert os.path.exists(tmp_path / ("values0.1.bf16.npy" if dtype ==
                                      "bfloat16" else "values0.1.npy"))
    ref = jck.load_hnsw(_ref_table(db, dtype), str(tmp_path))
    assert ref.n_elems == port.n_elems and not ref.dedup
    d0, r0 = ref.search(q, K, ef_search=40)
    d1, r1 = port.search(q, K, ef_search=40)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6)
    # and back: the port reads its own checkpoint
    again = tck.load_hnsw(tt, str(tmp_path))
    d2, r2 = again.search(q, K, ef_search=40)
    assert_same_topk(d1, r1, d2, r2, atol=0, rtol=0)


def _live_rows(db):
    """300 rows of which 20 repeat earlier ones (heap-TID dedup merges
    them) and 30 are deleted (a vacuum frees them)."""
    rows = np.concatenate([db[:280], db[:20]])
    return rows, np.arange(5, 300, 10)


def _row_map(idx):
    """row_to_elem over the rows the elements hold: a vacuum drops dead
    rows from elem_rows but leaves them in the in-memory map (in both
    packages); the loaders rebuild the map from elem_rows."""
    return {r: e for r, e in idx.row_to_elem.items()
            if r in idx.elem_rows[e]}


def _assert_same_graph_books(a, b):
    n = a.n_elems
    assert (b.n_elems, b.entry, b.entry_level) == (n, a.entry, a.entry_level)
    assert (b.dedup, b.backlink_mode) == (a.dedup, a.backlink_mode)
    assert list(b.free_slots) == list(a.free_slots)
    assert _row_map(b) == _row_map(a) and b._dup_index == a._dup_index
    np.testing.assert_array_equal(b.elem_rows[:n], a.elem_rows[:n])
    np.testing.assert_array_equal(b.levels[:n], a.levels[:n])


@pytest.mark.parametrize("kw,what", [
    ({"dedup": True}, "dedup"),
    ({"dedup": False, "backlink_mode": "incremental"}, "incremental"),
    ({"dedup": True}, "vacuumed")])
def test_hnsw_checkpoint_the_port_cannot_hold(data, kw, what, tmp_path,
                                              hnsw_env):
    """Graphs the port could not hold before — heap-TID dedup, incremental
    backlinks, vacuumed with free slots — now round trip both ways: each
    package saves its own build and the other loads it with the same
    bookkeeping and answers with the same ids."""
    db, q = data
    rows, dead = _live_rows(db)
    opts = dict(m=8, ef_construction=32, wave_size=64, **kw)
    jt, tt = _ref_table(rows), _port_table(rows)
    ref = JHNSW(jt, JMetric.L2, **opts)
    port = HNSWIndex(tt, Metric.L2, **opts)
    if what == "vacuumed":
        for t, idx in ((jt, ref), (tt, port)):
            t.delete(dead)
            idx.vacuum()
        assert len(port.free_slots) == len(ref.free_slots) > 0
    for saver, loader, src, table in (
            (jck.save_hnsw, tck.load_hnsw, ref, tt),
            (tck.save_hnsw, jck.load_hnsw, port, jt)):
        path = str(tmp_path / type(src).__module__)
        saver(src, path)
        got = loader(table, path)
        _assert_same_graph_books(src, got)
        d0, r0 = src.search(q, K, ef_search=40)
        d1, r1 = got.search(q, K, ef_search=40)
        assert_same_topk(d0, r0, d1, r1, atol=1e-6)
        assert not np.isin(r1, dead if what == "vacuumed" else []).any()


def test_hnsw_reference_defaults_vacuumed_to_port(data, tmp_path, hnsw_env):
    """A reference graph built with its defaults (dedup on), then vacuumed,
    loads into the port, which answers plain and iterative scans as the
    reference does and reuses the freed slots in the reference's order."""
    from pgvector_tpu import config as jconfig
    from pgvector_tpu_torch import config

    db, q = data
    rows, dead = _live_rows(db)
    jt, tt = _ref_table(rows, dead=dead), _port_table(rows, dead=dead)
    ref = JHNSW(_ref_table(rows), JMetric.L2)
    ref.table.delete(dead)
    ref.vacuum()
    jck.save_hnsw(ref, str(tmp_path))
    port = tck.load_hnsw(tt, str(tmp_path))
    ref = jck.load_hnsw(jt, str(tmp_path))
    _assert_same_graph_books(ref, port)
    for mode in ("off", "relaxed_order", "strict_order"):
        with jconfig.local(**{"hnsw.iterative_scan": mode}):
            d0, r0 = ref.search(q, K, ef_search=20)
        with config.local(**{"hnsw.iterative_scan": mode}):
            d1, r1 = port.search(q, K, ef_search=20)
        assert_same_topk(d0, r0, d1, r1, atol=1e-6)
    new = np.random.default_rng(4).normal(size=(12, 8)).astype(np.float32)
    np.testing.assert_array_equal(jt.insert(new), tt.insert(new))
    ref.insert(np.arange(300, 312))
    port.insert(np.arange(300, 312))
    _assert_same_graph_books(ref, port)


# ------------------------------------------------------------ IVFFlat
def test_ivfflat_reference_to_port(data, tmp_path):
    db, q = data
    jt = _ref_table(db, dead=np.arange(0, 1200, 9))
    ref = JIVF(jt, JMetric.COSINE, lists=12, seed=1)
    jck.save_ivfflat(ref, str(tmp_path))
    port = tck.load_ivfflat(_port_table(db, dead=np.arange(0, 1200, 9)),
                            str(tmp_path))
    np.testing.assert_array_equal(port.postings, ref.postings)
    for probes in (1, 4):
        d0, r0 = ref.search(q, K, probes=probes)
        d1, r1 = port.search(q, K, probes=probes)
        assert_same_topk(d0, r0, d1, r1)


def test_ivfflat_port_to_reference(data, tmp_path):
    db, q = data
    tt = _port_table(db)
    port = IVFFlatIndex(tt, Metric.IP, lists=12, seed=1)
    tck.save_ivfflat(port, str(tmp_path))
    ref = jck.load_ivfflat(_ref_table(db), str(tmp_path))
    np.testing.assert_array_equal(ref.postings, port.postings)
    for probes in (1, 4):
        d0, r0 = ref.search(q, K, probes=probes)
        d1, r1 = port.search(q, K, probes=probes)
        assert_same_topk(d0, r0, d1, r1)


def test_bit_checkpoints_the_port_cannot_hold(tmp_path):
    """Bit tables and bit IVFFlat indexes, each way round (the port holds
    them now; the name is the one the earlier refusal had)."""
    rng = np.random.default_rng(2)
    bits = rng.random((600, 40)) < 0.5
    q = rng.random((6, 40)) < 0.5
    jt = JBitTable(40)
    jt.insert(bits)
    jt.delete(np.arange(0, 600, 11))
    jck.save_table(jt, str(tmp_path / "t"))
    tt = tck.load_table(str(tmp_path / "t"), device="cpu")
    assert isinstance(tt, BitTable) and (tt.count, tt.dim) == (600, 40)
    np.testing.assert_array_equal(tt.data[:600].numpy().view(np.uint32),
                                  np.asarray(jt.data[:600]))
    np.testing.assert_array_equal(tt.valid[:600].numpy(),
                                  np.asarray(jt.valid[:600]))
    ref = JIVF(jt, JMetric.HAMMING, lists=4, seed=1)
    jck.save_ivfflat(ref, str(tmp_path / "i"))
    port = tck.load_ivfflat(tt, str(tmp_path / "i"))
    np.testing.assert_array_equal(port.postings, ref.postings)
    d0, r0 = ref.search(q, K, probes=2)
    d1, r1 = port.search(q, K, probes=2)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(r1, r0)
    # port → reference
    tck.save_table(tt, str(tmp_path / "t2"))
    tck.save_ivfflat(port, str(tmp_path / "i2"))
    jt2 = jck.load_table(str(tmp_path / "t2"))
    np.testing.assert_array_equal(np.asarray(jt2.data[:600]),
                                  np.asarray(jt.data[:600]))
    ref2 = jck.load_ivfflat(jt2, str(tmp_path / "i2"))
    d2, r2 = ref2.search(q, K, probes=2)
    np.testing.assert_array_equal(r2, r0)
    with pytest.raises(DataException, match="cannot index"):
        tck.load_ivfflat(DenseTable(40, device="cpu"), str(tmp_path / "i"))


def _sparse_rows(seed, n, dim, nnz):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = np.sort(rng.choice(dim, rng.integers(1, nnz + 1), replace=False))
        out.append((c, rng.normal(size=len(c)).astype(np.float32)))
    return out


def test_sparse_table_checkpoints_both_ways(tmp_path):
    rows = _sparse_rows(3, 300, 50, 6)
    jt = JSparseTable(50, nnz_cap=8)
    jt.insert([JSparseVec(50, i, v) for i, v in rows])
    jt.delete(np.arange(0, 300, 7))
    jck.save_table(jt, str(tmp_path / "t"))
    tt = tck.load_table(str(tmp_path / "t"), device="cpu")
    assert isinstance(tt, SparseTable) and tt.nnz_cap == 8
    np.testing.assert_array_equal(tt.idx[:300].numpy(), np.asarray(jt.idx[:300]))
    np.testing.assert_array_equal(tt.val[:300].numpy(), np.asarray(jt.val[:300]))
    np.testing.assert_array_equal(tt.valid[:300].numpy(),
                                  np.asarray(jt.valid[:300]))
    assert tt.get(5) == SparseVec(50, *rows[5])
    tck.save_table(tt, str(tmp_path / "t2"))
    jt2 = jck.load_table(str(tmp_path / "t2"))
    np.testing.assert_array_equal(np.asarray(jt2.idx[:300]),
                                  np.asarray(jt.idx[:300]))
    np.testing.assert_array_equal(np.asarray(jt2.valid[:300]),
                                  np.asarray(jt.valid[:300]))


@pytest.mark.parametrize("kind", ["bit", "sparse"])
def test_bit_and_sparse_graphs_both_ways(kind, tmp_path, hnsw_env):
    """A Hamming graph and a sparse inner-product graph: the reference's
    checkpoint searched by the port, and the port's by the reference."""
    rng = np.random.default_rng(4)
    if kind == "bit":
        vals = rng.random((800, 64)) < 0.5
        q = rng.random((8, 64)) < 0.5
        jt, tt = JBitTable(64), BitTable(64, device="cpu")
        jt.insert(vals)
        tt.insert(vals)
        metric = "HAMMING"
        jq, tq = q, q
    else:
        rows = _sparse_rows(5, 800, 40, 6)
        jt = JSparseTable(40, nnz_cap=8)
        tt = SparseTable(40, nnz_cap=8, device="cpu")
        jt.insert([JSparseVec(40, i, v) for i, v in rows])
        tt.insert([SparseVec(40, i, v) for i, v in rows])
        metric = "IP"
        qrows = _sparse_rows(6, 8, 40, 6)
        jq = [JSparseVec(40, i, v) for i, v in qrows]
        tq = [SparseVec(40, i, v) for i, v in qrows]
    ref = JHNSW(jt, JMetric[metric], m=8, ef_construction=32, wave_size=128,
                beam_expand=4)
    jck.save_hnsw(ref, str(tmp_path / "h"))
    port = tck.load_hnsw(tt, str(tmp_path / "h"))
    assert port.kind == kind and port.n_elems == ref.n_elems
    assert port._dup_index == ref._dup_index
    d0, r0 = ref.search(jq, K, ef_search=40)
    d1, r1 = port.search(tq, K, ef_search=40)
    tol = 0.0 if kind == "bit" else 1e-6
    assert_same_topk(d0, r0, d1, r1, atol=tol, rtol=1e-5 if tol else 0.0)
    tck.save_hnsw(port, str(tmp_path / "h2"))
    ref2 = jck.load_hnsw(jt, str(tmp_path / "h2"))
    d2, r2 = ref2.search(jq, K, ef_search=40)
    assert_same_topk(d0, r0, d2, r2, atol=tol, rtol=1e-5 if tol else 0.0)
    with pytest.raises(DataException, match="cannot index"):
        tck.load_hnsw(DenseTable(8, device="cpu"), str(tmp_path / "h"))


# ------------------------------------------------------------ the format
def test_saves_are_epoch_tagged_and_checked(data, tmp_path):
    db, _ = data
    tt = _port_table(db[:50])
    path = str(tmp_path)
    tck.save_table(tt, path)
    tck.save_table(tt, path)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert (manifest["magic"], manifest["version"], manifest["epoch"]) == \
        ("pgvector-tpu", 1, 2)
    assert sorted(os.listdir(path)) == ["data.2.npy", "manifest.json",
                                        "valid.2.npy"]
    # an orphan of a crashed save is skipped over, then collected
    np.save(tmp_path / "data.7.npy", np.zeros(1))
    tck.save_table(tt, path)
    assert sorted(os.listdir(path)) == ["data.8.npy", "manifest.json",
                                        "valid.8.npy"]
    with pytest.raises(DataException, match="expected an ivfflat"):
        tck.load_ivfflat(tt, path)
    (tmp_path / "manifest.json").write_text(
        json.dumps(dict(manifest, magic="other")))
    with pytest.raises(DataException, match="bad magic"):
        tck.load_table(path, device="cpu")
    with pytest.raises(DataException, match="no manifest"):
        tck.load_table(str(tmp_path / "absent"), device="cpu")
