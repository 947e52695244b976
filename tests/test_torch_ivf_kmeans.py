"""IVFFlat build through both packages, on the CPU.

- Pieces: ``_build_work_items`` and ``_adaptive_item_shape`` equal the
  reference's on tests/test_ivf_workitems.py's cases; Lloyd's loop from
  the reference's k-means++ centers gives the same iterations, the same
  assignments and centers within 1e-5 (clustered 2,000 × 16, 16 centers,
  no cluster left empty; L2, spherical and binary); ``_load_postings``
  lays the same assignments out in the same blocks.
- Build: the port's own k-means samples the reference's rows; its recall
  and inertia hold against the reference's (k-means++ draws from
  ``jax.random`` in the reference, so the centers differ).
- Behavior: zero-norm cosine rows, the little-data notice, an empty
  table, the lists bounds and the opclasses behave as the reference's
  (tests/test_ivfflat.py:52-116).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pgvector_tpu import errors as jerrors  # noqa: E402
from pgvector_tpu.index import ivf_kmeans as jkm  # noqa: E402
from pgvector_tpu.index import ivfflat as jivf  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    DataException, DenseTable, FeatureNotSupported, IVFFlatIndex, Metric)
from pgvector_tpu_torch.index import ivf_kmeans as tkm  # noqa: E402
from pgvector_tpu_torch.index import ivfflat as tivf  # noqa: E402
from pgvector_tpu_torch.io.convert import table_from_numpy  # noqa: E402
from torch_ivf_pairs import (  # noqa: E402
    K, LISTS, exact_topk, recall, reference_data, tables)


@pytest.fixture(scope="module")
def data():
    return reference_data()


@pytest.fixture(scope="module")
def references(data):
    """The reference's own build per metric (lists 20, seed 1)."""
    db, _ = data
    cache = {}

    def get(metric):
        if metric not in cache:
            jt = JTable(16)
            jt.insert(db)
            cache[metric] = JIVF(jt, JMetric[metric], lists=LISTS, seed=1)
        return cache[metric]

    return get


# ------------------------------------------------------------ pieces
def _geometry(lens, cs):
    occ = (np.asarray(lens) + cs - 1) // cs
    bs = np.zeros(len(lens) + 1, np.int64)
    bs[1:] = np.cumsum(occ)
    return bs, occ


def _workitem_case(case, cs):
    """tests/test_ivf_workitems.py's inputs: (sel, blk_start, blk_occ)."""
    if case == "coverage":
        rng = np.random.default_rng(3)
        lens = np.array([0, 1, 7 * cs + 3, cs, 2 * cs - 1, 5, 0, 12 * cs])
        sel = rng.integers(0, len(lens), size=(37, 5))
    elif case == "geometry":
        rng = np.random.default_rng(5)
        lens = rng.integers(0, 9 * cs, size=30)
        sel = rng.integers(0, len(lens), size=(64, 7))
    else:
        lens = np.zeros(4, np.int64)
        sel = np.zeros((3, 2), np.int64)
    bs, occ = _geometry(lens, cs)
    return sel, bs, occ


def _assert_work_equal(ref, got):
    if ref is None:
        assert got is None
        return
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case,cs,Qc,Wb", [
    ("coverage", 512, 64, 2), ("coverage", 8, 4, 2), ("coverage", 128, 8, 1),
    ("geometry", 512, 64, 2), ("geometry", 8, 4, 4), ("empty", 8, 4, 2)])
def test_work_items_equal_reference(case, cs, Qc, Wb):
    sel, bs, occ = _workitem_case(case, cs)
    _assert_work_equal(jivf._build_work_items(sel, bs, occ, Qc, Wb),
                       tivf._build_work_items(sel, bs, occ, Qc, Wb))
    args = (sel.reshape(-1), occ, cs, Qc, Wb * cs)
    assert tivf._adaptive_item_shape(*args) == jivf._adaptive_item_shape(*args)


@pytest.mark.parametrize("shape", ["1M", "10M"])
def test_adaptive_item_shape_equals_reference(shape):
    """The 1M- and 10M-shaped edge sets of
    test_adaptive_item_shape_10m_regression, and their work items."""
    rng = np.random.default_rng(9)
    occ = np.full(1000, 2, np.int64)
    sel = rng.integers(0, 1000, size=(4000, 10))
    if shape == "10M":
        occ = np.clip(rng.poisson(5, 4000), 1, None).astype(np.int64)
        sel = rng.integers(0, 4000, size=(4000, 63))
    bs = np.zeros(len(occ) + 1, np.int64)
    bs[1:] = np.cumsum(occ)
    args = (sel.reshape(-1), occ, 512, 64, 1024)
    qc, wb = jivf._adaptive_item_shape(*args)
    assert tivf._adaptive_item_shape(*args) == (qc, wb)
    _assert_work_equal(jivf._build_work_items(sel, bs[:-1], occ, qc, wb),
                       tivf._build_work_items(sel, bs[:-1], occ, qc, wb))


def _clustered(kind):
    """2,000 × 16 rows around 16 well-separated centers (unit rows for
    the spherical case, 0/1 rows for the binary one)."""
    rng = np.random.default_rng(21)
    if kind == "binary":
        protos = rng.random((16, 16)) < 0.5
        x = protos[np.repeat(np.arange(16), 125)]
        return (x ^ (rng.random(x.shape) < 0.03)).astype(np.float32)
    centers = rng.normal(size=(16, 16)) * 8.0
    x = centers[np.repeat(np.arange(16), 125)] + rng.normal(size=(2000, 16))
    if kind == "spherical":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["l2", "spherical", "binary"])
def test_lloyd_equals_reference(kind):
    x = _clustered(kind)
    spherical, binary = kind == "spherical", kind == "binary"
    init = np.asarray(jkm._kmeanspp_init(jnp.asarray(x), jax.random.PRNGKey(0),
                                         16, spherical))
    if binary:
        init = (init > 0.5).astype(np.float32)
    c0, a0, it0 = jkm._kmeans_device(jnp.asarray(x), jnp.asarray(init),
                                     jax.random.PRNGKey(1), 16, spherical,
                                     binary)
    c1, a1, it1 = tkm.lloyd(torch.tensor(x), torch.tensor(init),
                            tkm.make_generator(1, "cpu"), 16, spherical,
                            binary)
    a0 = np.asarray(a0)
    assert (np.bincount(a0, minlength=16) > 0).all()
    assert it1 == int(it0) and it1 > 1
    np.testing.assert_array_equal(a1.numpy(), a0)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c0), atol=1e-5)


def test_kmeanspp_falls_back_to_uniform():
    """All-zero weights (every sample identical) draw uniformly, as the
    reference's guard does, and Lloyd's stops after two rounds."""
    x = torch.ones((50, 4))
    g = tkm.make_generator(0, "cpu")
    init = tkm._kmeanspp_init(x, g, 5, False)
    assert torch.equal(init, torch.ones((5, 4)))
    centers, iters = tkm.train_centers(x, 5, seed=0)
    assert iters == 2 and torch.isfinite(centers).all()


@pytest.mark.parametrize("pattern,metric,dtype", [
    ("skewed", "L2", "float32"), ("holes", "COSINE", "float32"),
    ("long", "L2", "bfloat16"), ("small", "IP", "float16")])
def test_load_postings_equals_reference(pattern, metric, dtype):
    rng = np.random.default_rng(31)
    n, lists = 3000, 12
    db = rng.normal(size=(n, 8)).astype(np.float32)
    a = rng.integers(0, lists, size=n)
    if pattern == "skewed":
        a[: 1500] = 3            # 3 blocks of 512
    elif pattern == "holes":
        a[rng.random(n) < 0.2] = -1
        a[a == 5] = 7            # an empty list
        db[11] = 0.0             # a zero row (normalized to 0)
    elif pattern == "long":
        a[: 1100] = 0
    else:
        a = a[:40]               # cap < 512: blocks of cap slots
    jt, tt = tables(db, dtype)
    assign = np.full(jt.capacity, -1, np.int64)
    assign[: len(a)] = a
    ref = JIVF(jt, JMetric[metric], lists=lists, build=False)
    ref._load_postings(assign.copy())
    port = IVFFlatIndex(tt, Metric[metric], lists=lists, build=False)
    port._load_postings(assign.copy())
    assert port._post_cs == ref._post_cs
    for name in ("postings", "_blk_start", "_blk_occ", "list_lens"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    np.testing.assert_array_equal(port.postings_flat.numpy(),
                                  np.asarray(ref.postings_flat))
    np.testing.assert_allclose(port.post_values.float().numpy(),
                               np.asarray(ref.post_values).astype(np.float32),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.post_vsq.numpy(),
                               np.asarray(ref.post_vsq), rtol=1e-6)
    assert port.post_values.dtype == getattr(torch, dtype)


# ------------------------------------------------------------ build
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_port_build_recall_and_inertia(references, data, metric):
    db, q = data
    ref = references(metric)
    tt = table_from_numpy(db, np.ones(len(db), bool), device="cpu")
    built = IVFFlatIndex(tt, Metric[metric], lists=LISTS, seed=1)
    assert 1 < built.kmeans_iters <= tkm.KMEANS_MAX_ITERATIONS
    gt = exact_topk(metric, db, q)
    r_ref = recall(ref.search(q, K, probes=5)[1], gt)
    r_port = recall(built.search(q, K, probes=5)[1], gt)
    assert r_port >= max(r_ref - 0.02, 0.75), (r_port, r_ref)
    assert recall(built.search(q, K, probes=LISTS)[1], gt) >= 0.99
    i_ref = _inertia(metric, db, np.asarray(ref.centroids_f32),
                     ref.assignments)
    i_port = _inertia(metric, db, built.centroids.numpy(), built.assignments)
    assert abs(i_port - i_ref) <= 0.05 * i_ref, (i_port, i_ref)


def _inertia(metric, db, centers, assignments):
    """kmeans_metrics' inertia for L2 and cosine.  For IP it is the
    objective spherical k-means minimizes, Σ (1 − cos) over unit rows:
    kmeans_metrics clips the raw (unnormalized) rows' ip at 1, so its IP
    inertia counts only the rows whose projection falls below 1 and
    moves by more than 5 % from one seed to the next within either
    package, while Σ (1 − cos) does not."""
    a = assignments[: len(db)]
    if metric == "L2":
        return float(((db - centers[a]) ** 2).sum())
    x = db / np.linalg.norm(db, axis=1, keepdims=True)
    cos = np.clip((x * centers[a]).sum(1), -1.0, 1.0)
    if metric == "IP":
        return float((1.0 - cos).sum())
    return float((np.arccos(cos) / np.pi).sum())


class _Sampled(Exception):
    pass


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_port_samples_the_reference_rows(metric, monkeypatch):
    """Past 10,000 live rows both draw the same reservoir sample from
    ``np.random.default_rng(seed)``; cosine drops the zero rows in it."""
    rng = np.random.default_rng(4)
    db = rng.normal(size=(12000, 4)).astype(np.float32)
    db[::97] = 0.0
    got = {}

    def grab(name):
        def train(samples, *a, **kw):
            got[name] = np.asarray(samples, np.float32)
            raise _Sampled
        return train

    monkeypatch.setattr(jivf, "train_centers", grab("ref"))
    monkeypatch.setattr(tivf, "train_centers", grab("port"))
    jt, tt = tables(db)
    jt.delete(np.arange(0, 12000, 5))
    tt.delete(np.arange(0, 12000, 5))
    with pytest.raises(_Sampled):
        JIVF(jt, JMetric[metric], lists=LISTS, seed=7)
    with pytest.raises(_Sampled):
        IVFFlatIndex(tt, Metric[metric], lists=LISTS, seed=7)
    assert got["ref"].shape[0] <= 10000
    np.testing.assert_allclose(got["port"], got["ref"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("metric", ["L2", "COSINE"])
def test_empty_table_centers_equal_reference(metric):
    """An empty table's random centers come from the same numpy draw."""
    jt, tt = JTable(8), DenseTable(8, device="cpu")
    ref = JIVF(jt, JMetric[metric], lists=6, seed=3)
    port = IVFFlatIndex(tt, Metric[metric], lists=6, seed=3)
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids_f32), rtol=1e-6)
    d, r = port.search(np.ones(8, np.float32), 3, probes=6)
    assert (r == -1).all() and np.isinf(d).all()


# ------------------------------------------------------------ behavior
def test_cosine_zero_vectors_not_indexed():
    rng = np.random.default_rng(3)
    db = rng.normal(size=(200, 8)).astype(np.float32)
    db[7] = 0.0
    jt, tt = tables(db)
    ref = JIVF(jt, JMetric.COSINE, lists=5, seed=1)
    port = IVFFlatIndex(tt, Metric.COSINE, lists=5, seed=1)
    np.testing.assert_array_equal(port.indexed_mask, ref.indexed_mask)
    assert not port.indexed_mask[7]
    port.insert(tt.insert(np.zeros((1, 8), np.float32)))
    assert not port.indexed_mask[200]
    _, r = port.search(db[:1], 201, probes=5)
    assert not {7, 200} & set(r[0].tolist())


def test_little_data_notice():
    db = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    jt, tt = tables(db)
    got = {"ref": [], "port": []}
    JIVF(jt, JMetric.L2, lists=10, notice_hook=got["ref"].append)
    IVFFlatIndex(tt, Metric.L2, lists=10, notice_hook=got["port"].append)
    assert got["port"] == got["ref"] and "little data" in got["port"][0]


@pytest.mark.parametrize("lists", [0, 40000])
def test_lists_bounds(lists):
    with pytest.raises(jerrors.DataException) as e0:
        JIVF(JTable(4), JMetric.L2, lists=lists, build=False)
    with pytest.raises(DataException) as e1:
        IVFFlatIndex(DenseTable(4, device="cpu"), Metric.L2, lists=lists,
                     build=False)
    assert str(e1.value) == str(e0.value)


@pytest.mark.parametrize("metric", ["L1", "HAMMING", "JACCARD"])
def test_unsupported_opclass(metric):
    with pytest.raises(jerrors.FeatureNotSupported) as e0:
        JIVF(JTable(4), JMetric[metric], build=False)
    with pytest.raises(FeatureNotSupported) as e1:
        IVFFlatIndex(DenseTable(4, device="cpu"), Metric[metric], build=False)
    assert str(e1.value) == str(e0.value)


