"""IVFFlat search through both packages, on the CPU.

``ivfflat_from_numpy`` carries the reference's trained state (5,000 × 16,
lists 20, seed 1; the arrays ``io.checkpoint.save_ivfflat`` writes) into
the port, and both search it with every combination of metric (L2, IP,
cosine), probes (1, 5, 20), probe route (inverted, blocks), deletes +
filter mask and iterative scan, and over a bf16 table.  Ids agree apart
from ties, distances within tests/torch_parity.py's tolerance, and
``stats`` counts the same rounds.  Insert (in place and re-laid) and
vacuum keep the same postings and answers; k-means diagnostics agree.
The build's pieces are in tests/test_torch_ivf_kmeans.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu import config as jconfig  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    DataException, DenseTable, FeatureNotSupported, IVFFlatIndex, Metric,
    config)
from pgvector_tpu_torch.io.convert import ivfflat_from_numpy  # noqa: E402
from torch_ivf_pairs import (  # noqa: E402
    K, LISTS, reference_pairs, reference_data, reference_on, reference_state,
    tables)
from torch_parity import assert_same_topk  # noqa: E402


@pytest.fixture(scope="module")
def data():
    return reference_data()


@pytest.fixture(scope="module")
def pairs(data):
    return reference_pairs(data[0])


# ------------------------------------------------------------ search
@pytest.mark.parametrize("iterative", ["off", "relaxed_order"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("route", ["inverted", "blocks"])
@pytest.mark.parametrize("probes", [1, 5, 20])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_search_on_reference_centers(pairs, data, metric, probes, route,
                                     filtered, iterative, monkeypatch):
    """``filtered``: every 7th row deleted (no vacuum) and a filter that
    passes every 50th row, so probes=1 finds fewer than k and an
    iterative scan keeps probing."""
    _, q = data
    ref, port = pairs(metric, filtered)
    cov = 10**9 if route == "inverted" else 0
    monkeypatch.setattr(JIVF, "INVERT_COVERAGE", cov)
    monkeypatch.setattr(IVFFlatIndex, "INVERT_COVERAGE", cov)
    fmask = None
    if filtered:
        fmask = np.zeros(5000, bool)
        fmask[::50] = True
    gucs = {"ivfflat.iterative_scan": iterative, "ivfflat.max_probes": 20}
    s0, s1 = ref.stats.searches, port.stats.searches
    with jconfig.local(**gucs), config.local(**gucs):
        d0, r0 = ref.search(q, K, probes=probes, filter_mask=fmask)
        d1, r1 = port.search(q, K, probes=probes, filter_mask=fmask)
    assert port.last_path == route
    assert_same_topk(d0, r0, d1, r1)
    assert r1.dtype == np.int32 and d1.dtype == np.float32
    assert port.stats.searches - s1 == ref.stats.searches - s0
    if filtered:
        assert (r1[r1 >= 0] % 50 == 0).all() and (r1[r1 >= 0] % 7 != 0).all()


def test_search_bf16_table(data):
    db, q = data
    jt, tt = tables(db, "bfloat16")
    ref = JIVF(jt, JMetric.L2, lists=LISTS, seed=1)
    port = ivfflat_from_numpy(tt, *reference_state(ref))
    assert port.post_values.dtype == torch.bfloat16
    for probes in (1, 5):
        d0, r0 = ref.search(q, K, probes=probes)
        d1, r1 = port.search(q, K, probes=probes)
        assert_same_topk(d0, r0, d1, r1)


def test_probe_order_ties_to_lower_list(data):
    """Duplicate centers tie exactly: the lower list id comes first, as
    lax.top_k orders them."""
    db, q = data
    jt, tt = tables(db)
    arrays, meta = reference_state(JIVF(jt, JMetric.L2, lists=LISTS, seed=1))
    arrays["centroids_f32"] = arrays["centroids_f32"].copy()
    arrays["centroids_f32"][10:] = arrays["centroids_f32"][:10]
    port = ivfflat_from_numpy(tt, arrays, meta)
    got = port._probe_order(port._form_queries(q), LISTS).numpy()
    for row in got:
        first = {}
        for pos, lid in enumerate(row):
            first.setdefault(lid % 10, (pos, lid))
        assert all(lid < 10 for _, lid in first.values()), row


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_kmeans_metrics_equal_reference(pairs, metric):
    ref, port = pairs(metric)
    m0, m1 = ref.kmeans_metrics(), port.kmeans_metrics()
    np.testing.assert_allclose(m1["inertia"], m0["inertia"], rtol=1e-5)
    np.testing.assert_allclose(m1["davies_bouldin"], m0["davies_bouldin"],
                               rtol=1e-5)


# ------------------------------------------------------------ maintenance
@pytest.mark.parametrize("split", [4900, 1000])
def test_insert_equals_reference(pairs, data, split, monkeypatch):
    """Both packages insert the same rows into the same lists: in place
    while lists fit their blocks, re-laid otherwise."""
    db, q = data
    jt, tt = tables(db[:split])
    ref = reference_on(jt, "L2", pairs("L2")[0].centroids_f32)
    port = ivfflat_from_numpy(tt, *reference_state(ref))
    relaid = {"ref": 0, "port": 0}
    for name, cls in (("ref", JIVF), ("port", IVFFlatIndex)):
        orig = cls._load_postings

        def spy(self, a, _orig=orig, _name=name):
            relaid[_name] += 1
            return _orig(self, a)

        monkeypatch.setattr(cls, "_load_postings", spy)
    ref.insert(jt.insert(db[split:]))
    port.insert(tt.insert(db[split:]))
    assert relaid["ref"] == relaid["port"] == (split == 1000)
    for name in ("postings", "list_lens", "indexed_mask"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    np.testing.assert_array_equal(port.postings_flat.numpy(),
                                  np.asarray(ref.postings_flat))
    np.testing.assert_allclose(port.post_vsq.numpy(), np.asarray(ref.post_vsq),
                               rtol=1e-6)
    for probes in (5, LISTS):
        d0, r0 = ref.search(q, K, probes=probes)
        d1, r1 = port.search(q, K, probes=probes)
        assert_same_topk(d0, r0, d1, r1)


def test_vacuum_equals_reference(pairs, data):
    db, q = data
    jt, tt = tables(db)
    ref = reference_on(jt, "L2", pairs("L2")[0].centroids_f32)
    port = ivfflat_from_numpy(tt, *reference_state(ref))
    kill = np.arange(0, 2500)
    jt.delete(kill)
    tt.delete(kill)
    ref.vacuum()
    port.vacuum()
    np.testing.assert_array_equal(port.postings, ref.postings)
    np.testing.assert_array_equal(port.list_lens, ref.list_lens)
    d0, r0 = ref.search(q, K, probes=5)
    d1, r1 = port.search(q, K, probes=5)
    assert_same_topk(d0, r0, d1, r1)
    assert (~np.isin(r1, kill)).all()


def test_unbuilt_index_and_bittables():
    port = IVFFlatIndex(DenseTable(4, device="cpu"), Metric.L2, build=False)
    with pytest.raises(DataException, match="has not been built"):
        port.search(np.zeros(4, np.float32), 1)
    # not a bit table: the hamming opclass does not apply, as in the
    # reference
    with pytest.raises(FeatureNotSupported,
                       match="operator <~> is not supported by ivfflat"):
        IVFFlatIndex(object(), Metric.HAMMING, build=False)
    arrays = {"centroids_f32": np.zeros((100, 4), np.float32),
              "list_lens": np.zeros(100, np.int64),
              "assignments": np.full(1024, -1, np.int64)}
    meta = {"metric": "L2", "lists": 100, "seed": 0, "is_bit": False}
    assert ivfflat_from_numpy(port.table, arrays, meta).list_lens.sum() == 0
    with pytest.raises(DataException, match="is_bit=True cannot index"):
        ivfflat_from_numpy(port.table, arrays, dict(meta, is_bit=True))
    with pytest.raises(DataException, match="disagree"):
        ivfflat_from_numpy(port.table, dict(arrays, list_lens=np.ones(100)),
                           meta)
