"""The re-ranking pipelines (README.md:558-663) through both packages, on
the CPU: the cases of tests/test_rerank.py, each run by the reference and
by the port on the same seeded data and held to the same floors, with the
exact re-rank equal in both.

- ``exact_rerank`` re-orders shuffled true candidates into the exact top-k.
- ``BinaryQuantizedIndex`` (Hamming HNSW over sign bits, dedup off) and
  ``SubvectorIndex`` beat their floors; inserts reach the shadow table.
- ``ExpressionIndex`` keeps its shadow ↔ source row map through deletes,
  vacuum and out-of-order inserts, with float and bool expressions.
- ``rerank=False`` runs one shadow search and never pairs a finite
  distance with a deleted source row.
- the derived ``ef_search`` stays within 1..1000.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu import rerank as JR  # noqa: E402
from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    BinaryQuantizedIndex, BitTable, DenseTable, ExpressionIndex, FlatIndex,
    HNSWIndex, IVFFlatIndex, Metric, SubvectorIndex, exact_rerank)

#: both packages, side by side: name → (table class, table kw, Metric,
#: FlatIndex)
PACKAGES = {
    "reference": (JTable, {}, JMetric, JFlat),
    "port": (DenseTable, {"device": "cpu"}, Metric, FlatIndex),
}


def recall(r, e):
    return sum(len(set(map(int, a)) & set(map(int, b)))
               for a, b in zip(r, e)) / np.asarray(r).size


def _pipelines(pkg):
    if pkg == "reference":
        return JR.BinaryQuantizedIndex, JR.SubvectorIndex, \
            JR.ExpressionIndex, JR.exact_rerank
    return BinaryQuantizedIndex, SubvectorIndex, ExpressionIndex, exact_rerank


def _table(pkg, db, **kw):
    cls, tkw, _, _ = PACKAGES[pkg]
    t = cls(db.shape[1], **kw, **tkw)
    t.insert(db)
    return t


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    db = rng.normal(size=(1500, 32)).astype(np.float32)
    q = rng.normal(size=(10, 32)).astype(np.float32)
    return db, q


def test_exact_rerank_matches_reference(data):
    db, q = data
    jt, tt = _table("reference", db), _table("port", db)
    e_d, e_i = FlatIndex(tt, Metric.L2).search(q, 30)
    shuffled = np.stack([np.random.default_rng(0).permutation(row)
                         for row in e_i])
    d1, i1 = exact_rerank(tt, Metric.L2, q, shuffled, 5)
    np.testing.assert_array_equal(i1, e_i[:, :5])
    np.testing.assert_allclose(d1, e_d[:, :5], rtol=1e-4, atol=1e-4)
    shuffled[:, -3:] = -1  # padded candidate lists
    for metric in ("L2", "IP", "COSINE", "L1"):
        d0, i0 = JR.exact_rerank(jt, JMetric[metric], q, shuffled, 5)
        d1, i1 = exact_rerank(tt, Metric[metric], q, shuffled, 5)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_allclose(d1, d0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_binary_quantized_pipeline(data, pkg):
    db, q = data
    t = _table(pkg, db)
    metric, flat = PACKAGES[pkg][2], PACKAGES[pkg][3]
    bq = _pipelines(pkg)[0]
    idx = bq(t, metric.L2, m=8, ef_construction=32, rerank_factor=16,
             wave_size=256)
    assert idx.index.dedup is False  # the bit shadow keeps one row each
    _, e_i = flat(t, metric.L2).search(q, 10)
    d, r = idx.search(q, 10, ef_search=200)
    # 32 sign bits on gaussian data is BQ's worst case: well above random
    assert recall(r, e_i) >= 0.35
    rows = t.insert(db[:5] + 0.01)
    idx.insert(rows)
    assert idx.shadow.count == 1505
    if pkg == "port":
        assert isinstance(idx.bit_table, BitTable)
        # the derived ef stays within hnsw.ef_search's range
        d, r = idx.search(q[:2], 251)
        assert r.shape == (2, 251) and (r >= 0).all()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_subvector_pipeline(data, pkg):
    db, q = data
    t = _table(pkg, db)
    metric, flat = PACKAGES[pkg][2], PACKAGES[pkg][3]
    idx = _pipelines(pkg)[1](t, metric.L2, sub_dim=16, m=8,
                             ef_construction=32, rerank_factor=16,
                             wave_size=256)
    assert idx.sub_table.dim == 16
    _, e_i = flat(t, metric.L2).search(q, 10)
    _, r = idx.search(q, 10, ef_search=200)
    assert recall(r, e_i) >= 0.65


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_halfvec_bf16_indexes(data, pkg):
    db, q = data
    if pkg == "reference":
        t = _table(pkg, db, dtype=jnp.bfloat16)
        hnsw_cls, ivf_cls = JHNSW, JIVF
    else:
        t = _table(pkg, db, dtype=torch.bfloat16)
        hnsw_cls, ivf_cls = HNSWIndex, IVFFlatIndex
    metric, flat = PACKAGES[pkg][2], PACKAGES[pkg][3]
    _, e_i = flat(t, metric.L2).search(q, 10)
    hnsw = hnsw_cls(t, metric.L2, m=8, ef_construction=32, wave_size=256)
    _, r = hnsw.search(q, 10, ef_search=80)
    assert recall(r, e_i) >= 0.85
    ivf = ivf_cls(t, metric.L2, lists=8, seed=1)
    _, r = ivf.search(q, 10, probes=8)
    assert recall(r, e_i) >= 0.95


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_expression_index_out_of_order_inserts(pkg):
    rng = np.random.default_rng(21)
    db = rng.normal(size=(900, 16)).astype(np.float32)
    t = _table(pkg, db[:600])
    rows0 = np.arange(600)
    metric, flat = PACKAGES[pkg][2], PACKAGES[pkg][3]
    expr_cls = _pipelines(pkg)[2]
    idx = expr_cls(t, expr=lambda v: v[:, :8], metric=metric.L2, m=8,
                   ef_construction=32, wave_size=128, beam_expand=4,
                   rerank_factor=10)
    # source deletes, a shadow vacuum, then more inserts: shadow ids and
    # source ids diverge
    t.delete(rows0[:100])
    idx.vacuum()
    rows1 = t.insert(db[600:])
    idx.insert(rows1)
    q = db[:6] + 0.01
    _, e_i = flat(t, metric.L2).search(q, 10)
    _, r = idx.search(q, 10, ef_search=80)
    assert recall(r, e_i) >= 0.7  # half the dims on isotropic data
    assert not np.isin(r, rows0[:100]).any()
    idx2 = expr_cls(t, expr=lambda v: v > 0, metric=metric.L2, m=8,
                    ef_construction=32, wave_size=128, beam_expand=4)
    _, r2 = idx2.search(q, 10, ef_search=80)
    assert (r2 >= 0).any() and not np.isin(r2, rows0[:100]).any()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_no_rerank_single_search_masks_deleted(data, pkg):
    db, q = data
    t = _table(pkg, db)
    metric = PACKAGES[pkg][2]
    ei = _pipelines(pkg)[2](t, expr=lambda v: v[:, :8], metric=metric.L2,
                            m=8, ef_construction=32, rerank=False)
    calls = []
    inner = ei.index.search

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    ei.index.search = counted
    # sources deleted without a vacuum: their shadow rows map to dead rows
    t.delete(np.arange(50))
    d, r = ei.search(q, 10)
    assert len(calls) == 1
    assert not np.isin(r, np.arange(50)).any()
    assert np.isinf(d[r == -1]).all()
    assert np.isfinite(d[r >= 0]).all()
