"""Relation through both packages: the cases of tests/test_relation.py run
on a reference ``Relation`` and a port ``Relation`` over the same rows.

Where a case builds an index, the port's relation takes the reference's
graph or centers (loaded through ``io.convert``), so the planner sees the
same ``entry_level`` and ``lists`` and the scans walk the same graph:
the plans (EXPLAIN lines, costs, the chosen path) are equal as text, the
``knn`` ids equal apart from ties, distances within torch_parity's
tolerance, and the scan statistics equal.  DML then runs through each
package's own index code."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.config import config as jconfig  # noqa: E402
from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.relation import Relation as JRelation  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import (DataException, DenseTable, FlatIndex,  # noqa: E402
                                Metric, Relation, config)
from pgvector_tpu_torch.io.convert import ivfflat_from_numpy  # noqa: E402
from torch_hnsw_pairs import port_of  # noqa: E402
from torch_ivf_pairs import reference_state  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402


def _rels(db):
    jr = JRelation(JTable(db.shape[1]))
    tr = Relation(DenseTable(db.shape[1], device="cpu"))
    np.testing.assert_array_equal(jr.insert(db), tr.insert(db))
    return jr, tr


def _plan_lines(plan):
    return [l for l in plan.splitlines() if not l.startswith("Execution")]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return ("raise", type(exc).__name__, str(exc))


def test_end_to_end():
    rng = np.random.default_rng(61)
    db = rng.normal(size=(2000, 8)).astype(np.float32)
    jr, tr = _rels(db)
    jh = jr.create_index("hnsw", JMetric.L2, m=8, ef_construction=32,
                         wave_size=256)
    tr.indexes.append(port_of(jh, tr.table))
    q = db[:5]
    dj, ij = jr.knn(q, 5, ef_search=60)
    dt, it = tr.knn(q, 5, ef_search=60)
    assert_same_topk(dj, ij, dt, it)
    assert (it[:, 0] == np.arange(5)).all()  # own row nearest
    # the exact override equals FlatIndex and the reference's exact path
    d2, i2 = tr.knn(q, 5, use_index=False)
    e_d, e_i = FlatIndex(tr.table, Metric.L2).search(q, 5)
    np.testing.assert_array_equal(i2, e_i)
    np.testing.assert_array_equal(d2, e_d)
    # against the reference away from stored rows (an L2 distance near 0
    # is cancellation noise of the expanded form in either package)
    qr = rng.normal(size=(20, 8)).astype(np.float32)
    assert_same_topk(*jr.knn(qr, 5, use_index=False),
                     *tr.knn(qr, 5, use_index=False))
    # DML flows through each package's index
    rows = tr.insert(db[:3] + 10.0)
    np.testing.assert_array_equal(rows, jr.insert(db[:3] + 10.0))
    for rel in (jr, tr):
        _, i3 = rel.knn((db[0] + 10.0)[None, :], 1, ef_search=40)
        assert i3[0, 0] == rows[0]
        rel.delete([0])
        rel.vacuum()
        _, i4 = rel.knn(db[:1], 1, ef_search=40)
        assert i4[0, 0] != 0
    assert len(tr) == len(jr) == 2002
    assert_same_topk(*jr.knn(qr, 5, use_index=False),
                     *tr.knn(qr, 5, use_index=False))


def test_explain_equal():
    rng = np.random.default_rng(62)
    jr, tr = _rels(rng.normal(size=(500, 8)).astype(np.float32))
    ji = jr.create_index("ivfflat", JMetric.L2, lists=4, seed=1)
    tr.indexes.append(ivfflat_from_numpy(tr.table, *reference_state(ji)))
    for knobs in ({}, {"probes": 4}, {"probes": 2}):
        plan = tr.explain(Metric.L2, **knobs)
        assert plan == jr.explain(JMetric.L2, **knobs)
        assert "Seq Scan" in plan and "ivfflat" in plan and "chosen" in plan
    assert tr.explain(Metric.COSINE) == jr.explain(JMetric.COSINE)


def test_bad_am_equal():
    jr, tr = JRelation(JTable(4)), Relation(DenseTable(4, device="cpu"))
    for args in (("gist", "L2"), ("hnsw", None), ("ivfflat", None),
                 ("brin", None)):
        a = _outcome(lambda: jr.create_index(
            args[0], JMetric[args[1]] if args[1] else None))
        b = _outcome(lambda: tr.create_index(
            args[0], Metric[args[1]] if args[1] else None))
        assert b == a and a[0] == "raise", (a, b)
    with pytest.raises(DataException,
                       match='access method "gist" does not exist'):
        tr.create_index("gist", Metric.L2)


def test_knn_exact_path_honors_filter_mask():
    rng = np.random.default_rng(63)
    db = rng.normal(size=(300, 8)).astype(np.float32)
    jr, tr = _rels(db)
    for rel in (jr, tr):
        mask = np.ones(rel.table.capacity, bool)
        mask[:150] = False
        rel.mask = mask
    out = []
    for rel, metric in ((jr, JMetric.L2), (tr, Metric.L2)):
        d, i = rel.knn(db[0], k=5, metric=metric, filter_mask=rel.mask)
        d2, i2 = rel.knn(db[0], k=5, metric=metric, use_index=False,
                         filter_mask=rel.mask)
        assert (i >= 150).all() and (i2 >= 150).all()
        out.append((d, i, d2, i2))
    assert_same_topk(out[0][0], out[0][1], out[1][0], out[1][1])
    assert_same_topk(out[0][2], out[0][3], out[1][2], out[1][3])


def test_default_metric_skips_btree_index():
    rng = np.random.default_rng(64)
    db = rng.normal(size=(64, 4)).astype(np.float32)
    jr, tr = _rels(db)
    for rel in (jr, tr):
        rel.create_index("btree")
    dj, ij = jr.knn(db[0], k=3)
    dt, it = tr.knn(db[0], k=3)
    assert_same_topk(dj, ij, dt, it)
    assert it[0, 0] == 0
    jr.create_index("hnsw", JMetric.IP, m=4, ef_construction=16)
    tr.create_index("hnsw", Metric.IP, m=4, ef_construction=16)
    assert jr._default_metric() is JMetric.IP
    assert tr._default_metric() is Metric.IP


def test_scan_stats_and_explain_analyze_equal():
    rng = np.random.default_rng(65)
    db = rng.normal(size=(4000, 8)).astype(np.float32)
    jr, tr = _rels(db)
    jh = jr.create_index("hnsw", JMetric.L2, m=8, ef_construction=32,
                         wave_size=512)
    th = port_of(jh, tr.table)
    tr.indexes.append(th)
    zero = {"scans": 0, "queries": 0, "searches": 0, "tuples_returned": 0}
    assert th.stats.as_dict() == jh.stats.as_dict() == zero
    assert_same_topk(*jr.knn(db[:6], k=5), *tr.knn(db[:6], k=5))
    s = th.stats.as_dict()
    assert s == jh.stats.as_dict()
    assert s["scans"] == 1 and s["queries"] == 6 and s["searches"] == 6
    # iterative resumes bump nsearches past the query count, alike
    for rel, cfg in ((jr, jconfig), (tr, config)):
        mask = np.zeros(rel.table.capacity, bool)
        mask[:40] = True
        with cfg.local(**{"hnsw.iterative_scan": "relaxed_order"}):
            rel.knn(db[0], k=10, ef_search=12, filter_mask=mask)
    s2 = th.stats.as_dict()
    assert s2 == jh.stats.as_dict()
    assert s2["searches"] > s["searches"] + 1
    pj = jr.explain(JMetric.L2, analyze=True, q=db[0], k=5, ef_search=40)
    pt = tr.explain(Metric.L2, analyze=True, q=db[0], k=5, ef_search=40)
    assert _plan_lines(pt) == _plan_lines(pj)
    assert "Rows Returned: 5" in pt and "Index Searches: 1" in pt
    assert "Execution Time:" in pt
    assert _outcome(lambda: jr.explain(JMetric.L2, analyze=True)) == \
        _outcome(lambda: tr.explain(Metric.L2, analyze=True))
    # the exact path's EXPLAIN ANALYZE has no Index Searches line
    pe = _plan_lines(tr.explain(Metric.COSINE, analyze=True, q=db[0], k=3))
    assert pe == _plan_lines(jr.explain(JMetric.COSINE, analyze=True,
                                        q=db[0], k=3))


def test_knn_knobs_route_to_the_chosen_index():
    """ef_search reaches HNSW and probes IVFFlat whichever the planner
    picks, as in the reference; drop_index takes a path away."""
    rng = np.random.default_rng(66)
    db = rng.normal(size=(3000, 8)).astype(np.float32)
    jr, tr = _rels(db)
    jh = JHNSW(jr.table, JMetric.L2, m=8, ef_construction=32, wave_size=512)
    ji = JIVF(jr.table, JMetric.L2, lists=30, seed=1)
    jr.indexes += [jh, ji]
    th = port_of(jh, tr.table)
    ti = ivfflat_from_numpy(tr.table, *reference_state(ji))
    tr.indexes += [th, ti]
    q = db[100:110] + 0.01
    for knobs in ({"ef_search": 50}, {"probes": 30}, {"probes": 2},
                  {"ef_search": 1000, "probes": 3}):
        assert repr(tr.explain(Metric.L2, **knobs)) == \
            repr(jr.explain(JMetric.L2, **knobs))
        assert_same_topk(*jr.knn(q, 5, **knobs), *tr.knn(q, 5, **knobs))
    jr.drop_index(jh)
    tr.drop_index(th)
    assert tr.explain(Metric.L2) == jr.explain(JMetric.L2)
    assert "hnsw" not in tr.explain(Metric.L2)
    assert_same_topk(*jr.knn(q, 5, probes=30), *tr.knn(q, 5, probes=30))
    e_d, e_i = JFlat(jr.table, JMetric.L2).search(q, 5)
    assert_same_topk(e_d, e_i, *tr.knn(q, 5, probes=30))
