"""The planner through both packages: the tuple-visit cost model
(hnswcostestimate, ivfflatcostestimate), the access-path choice and the
calibrated device-time model of ``pgvector_tpu.planner`` against
``pgvector_tpu_torch.planner``.

The graph and the IVF centers are the reference's, loaded into the port
through ``io.convert``, so ``entry_level``, ``m`` and ``lists`` are the
same and every cost agrees to 1e-9 (the same float arithmetic).  The
calibration is held with injected constants and a fake clock; no test
here compares wall-clock times on the CPU; the calibrated pick is timed
on the card (``tests/test_torch_cuda.py``, ``cuda`` marker)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu import planner as JPL  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu_torch import Metric  # noqa: E402
from pgvector_tpu_torch import planner as TPL  # noqa: E402
from pgvector_tpu_torch.io.convert import ivfflat_from_numpy  # noqa: E402
from torch_hnsw_pairs import port_of, tables  # noqa: E402
from torch_ivf_pairs import reference_state  # noqa: E402

TOL = 1e-9


@pytest.fixture(scope="module")
def pair():
    """(reference table, [ref hnsw, ref ivf, ref cosine ivf], port table,
    [port hnsw, port ivf, port cosine ivf]) over the same 2,000 rows, 40
    of them deleted."""
    rng = np.random.default_rng(41)
    db = rng.normal(size=(2000, 8)).astype(np.float32)
    jt, tt = tables(db)
    dead = np.arange(0, 2000, 50)
    jt.delete(dead)
    tt.delete(dead)
    jh = JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=256)
    ji = JIVF(jt, JMetric.L2, lists=10, seed=1)
    jc = JIVF(jt, JMetric.COSINE, lists=7, seed=2)
    th = port_of(jh, tt)
    ti, tc = (ivfflat_from_numpy(tt, *reference_state(r)) for r in (ji, jc))
    assert (th.entry_level, th.m) == (jh.entry_level, jh.m)
    return jt, [jh, ji, jc], tt, [th, ti, tc]


@pytest.mark.parametrize("n", [0, 1, 2, 60, 10_000, 10**6, 10**9])
def test_scan_tuples_equal(n):
    for m in (2, 4, 16, 100):
        for ef in (1, 2, 40, 1000):
            for lvl in (-1, 0, 3):
                a = JPL.hnsw_scan_tuples(n, m, ef, lvl)
                b = TPL.hnsw_scan_tuples(n, m, ef, lvl)
                assert abs(a - b) <= TOL * max(abs(a), 1.0), (n, m, ef, lvl)
    for lists in (1, 7, 1000):
        for probes in (1, 5, 2000):
            assert TPL.ivfflat_scan_tuples(n, lists, probes) == \
                JPL.ivfflat_scan_tuples(n, lists, probes)


KNOBS = [{}, {"ef_search": 10}, {"ef_search": 200}, {"probes": 1},
         {"probes": 5}, {"probes": 10}, {"ef_search": 64, "probes": 3}]


@pytest.mark.parametrize("knobs", KNOBS, ids=[str(k) for k in KNOBS])
def test_estimate_cost_equal(pair, knobs):
    jt, jidx, tt, tidx = pair
    for j, t in zip([None] + jidx, [None] + tidx):
        metric = (j.metric.name if j is not None else "L2")
        a = JPL.estimate_cost(j, jt, JMetric[metric], **knobs)
        b = TPL.estimate_cost(t, tt, Metric[metric], **knobs)
        assert abs(a - b) <= TOL * max(a, 1.0), (type(t), a, b)


CHOICES = [
    ("L2", {}, True), ("L2", {"probes": 10}, True),
    ("L2", {"ef_search": 400}, True), ("L2", {"ef_search": 1000,
                                              "probes": 9}, True),
    ("L2", {}, False), ("COSINE", {}, True), ("COSINE", {"probes": 7}, True),
    ("IP", {}, True), ("L1", {"ef_search": 40}, True),
]


@pytest.mark.parametrize("metric,knobs,order_by", CHOICES,
                         ids=[f"{m}-{k}-{o}" for m, k, o in CHOICES])
def test_choose_path_equal(pair, metric, knobs, order_by):
    jt, jidx, tt, tidx = pair
    for subset in ([0, 1, 2], [0], [1, 2], []):
        a = JPL.choose_path(jt, [jidx[i] for i in subset], JMetric[metric],
                            order_by=order_by, **knobs)
        b = TPL.choose_path(tt, [tidx[i] for i in subset], Metric[metric],
                            order_by=order_by, **knobs)
        assert b.kind == a.kind and repr(b) == repr(a)
        assert abs(a.cost - b.cost) <= TOL * max(a.cost, 1.0)
        ia = None if a.index is None else jidx.index(a.index)
        ib = None if b.index is None else tidx.index(b.index)
        assert ia == ib


class _FakeTable:
    def __init__(self, n):
        self.live_count = n


def test_crossover_equal(pair):
    """Exact grows linearly, HNSW ~log: both packages flip at the same
    table size."""
    _, jidx, _, tidx = pair
    for n in (10, 100, 300, 1000, 3000, 10**5, 10**7):
        for ef in (10, 40, 200):
            a = (JPL.estimate_cost(None, _FakeTable(n), JMetric.L2),
                 JPL.estimate_cost(jidx[0], _FakeTable(n), JMetric.L2,
                                   ef_search=ef))
            b = (TPL.estimate_cost(None, _FakeTable(n), Metric.L2),
                 TPL.estimate_cost(tidx[0], _FakeTable(n), Metric.L2,
                                   ef_search=ef))
            assert np.allclose(a, b, rtol=TOL, atol=0), (n, ef, a, b)
            assert (a[0] > a[1]) == (b[0] > b[1])


@pytest.mark.parametrize("q_count", [1, 32, 512, 8000])
def test_calibration_predict_and_pick_equal(pair, q_count):
    """Injected constants (fixed s, per-query s): the same predictions and
    the same pick; an index without constants is not offered."""
    jt, jidx, tt, tidx = pair
    consts = [(0.004, 2e-6), (0.0007, 9e-6), (0.0002, 4e-5)]
    for keep in (3, 2, 1):
        cj = JPL.Calibration({"exact": (0.002, 5e-6), **{
            id(i): c for i, c in zip(jidx[:keep - 1], consts[1:])}})
        ct = TPL.Calibration({"exact": (0.002, 5e-6), **{
            id(i): c for i, c in zip(tidx[:keep - 1], consts[1:])}})
        assert ct.predict("exact", q_count) == cj.predict("exact", q_count)
        a = JPL.choose_path(jt, jidx, JMetric.L2, calibration=cj,
                            q_count=q_count)
        b = TPL.choose_path(tt, tidx, Metric.L2, calibration=ct,
                            q_count=q_count)
        assert (b.kind, repr(b)) == (a.kind, repr(a))
        assert abs(a.cost - b.cost) <= TOL * a.cost


def test_time_path_fit_equal(monkeypatch):
    """The two-point fit on a fake clock: a path costing 3 ms + 20 µs a
    query gives those constants in both packages."""
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])

    def search(qb):
        now[0] += 0.003 + 2e-5 * len(qb)

    q = np.zeros((300, 4), np.float32)
    a = JPL._time_path(search, q, (32, 256))
    b = TPL._time_path(search, q, (32, 256))
    assert np.allclose(a, b, rtol=TOL, atol=1e-15)
    assert np.allclose(b, (0.003, 2e-5), rtol=1e-6)


class _FakePath:
    """A path whose batch time follows ``cost(Q)`` on the fake clock."""

    def __init__(self, now, cost, metric=None):
        self.now, self.cost, self.metric = now, cost, metric

    def search(self, q, k, **kw):
        self.now[0] += self.cost(len(q))


def test_calibrate_times_the_planned_batch(monkeypatch):
    """The port also times the whole query set it is given, so a path whose
    time is not linear in the batch is predicted where the caller plans:
    K1-like (linear) against HNSW-like (flat past 256 queries; the shapes
    measured on the card, PERF.md §6).  The reference's fit through 32 and
    256 queries alone picks the exact scan at 8,000 queries; the port the
    HNSW path, which is faster there."""
    import pgvector_tpu.index.flat as jflat
    import pgvector_tpu_torch.index.flat as tflat

    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    exact = lambda q: 0.003 + 7.1e-6 * q  # noqa: E731
    hnsw = lambda q: (0.015 + 5.4e-5 * q if q <= 256  # noqa: E731
                      else 0.0288 + 1.1e-6 * (q - 256))
    for mod in (jflat, tflat):
        monkeypatch.setattr(mod, "FlatIndex",
                            lambda t, m: _FakePath(now, exact))
    q = np.zeros((8000, 4), np.float32)
    table = _FakeTable(10**6)
    table.device = torch.device("cpu")
    picks = {}
    for name, pl, metric in (("ref", JPL, JMetric.L2),
                             ("port", TPL, Metric.L2)):
        h = _FakePath(now, hnsw, metric)
        cal = pl.calibrate(table, [h], metric, q, sizes=(32, 256))
        picks[name] = pl.choose_path(table, [h], metric, calibration=cal,
                                     q_count=8000)
        if name == "port":
            for key, path in (("exact", exact), (id(h), hnsw)):
                assert np.isclose(cal.predict(key, 8000), path(8000),
                                  rtol=1e-9)
                assert np.isclose(cal.predict(key, 32), path(32), rtol=1e-9)
    # (the kind is the index's class name, here the fake's)
    assert picks["ref"].index is None and picks["port"].index is not None


def test_calibrate_offers_same_metric_paths(pair):
    """calibrate times the exact scan and every index of the metric (on
    the CPU: only the keys and the constants' signs are checked)."""
    _, _, tt, tidx = pair
    q = np.random.default_rng(3).normal(size=(40, 8)).astype(np.float32)
    cal = TPL.calibrate(tt, tidx, Metric.L2, q, k=5, sizes=(8, 32))
    assert set(cal.constants) == {"exact", id(tidx[0]), id(tidx[1])}
    for fixed, per_q in cal.constants.values():
        assert np.isfinite(fixed) and fixed >= 0
        assert np.isfinite(per_q) and per_q >= 0
    pick = TPL.choose_path(tt, tidx, Metric.L2, calibration=cal,
                           q_count=40)
    assert pick.kind in ("exact", "hnsw", "ivfflat")


def test_hbm_accounting(pair, monkeypatch):
    """table_hbm_bytes equals the reference's for the same table (same
    capacity growth, same dtypes); the index counts are the sums of their
    tensors' bytes, the aliased values counted 0, the slab cache only
    when asked for."""
    from pgvector_tpu.store.table import BitTable as JBitTable
    from pgvector_tpu.store.table import DenseTable as JTable
    from pgvector_tpu.store.table import SparseTable as JSparseTable
    from pgvector_tpu.utils import table_hbm_bytes as j_table_bytes
    from pgvector_tpu_torch import (BitTable, DenseTable, HNSWIndex,
                                    SparseTable)
    from pgvector_tpu_torch.utils import (hbm_bytes, hnsw_hbm_bytes,
                                          ivfflat_hbm_bytes, table_hbm_bytes)
    import jax.numpy as jnp

    jt, _, tt, tidx = pair
    assert table_hbm_bytes(tt) == j_table_bytes(jt)
    assert table_hbm_bytes(tt) == tt.capacity * (8 * 4 + 1)
    for dtype in ("bfloat16", "float16"):
        a = JTable(5, dtype=jnp.dtype(dtype), capacity=3000)
        b = DenseTable(5, dtype=getattr(torch, dtype), capacity=3000,
                       device="cpu")
        assert table_hbm_bytes(b) == j_table_bytes(a)
    assert table_hbm_bytes(BitTable(70, device="cpu")) == \
        j_table_bytes(JBitTable(70))
    assert table_hbm_bytes(SparseTable(9, nnz_cap=6, device="cpu")) == \
        j_table_bytes(JSparseTable(9, nnz_cap=6))
    th, ti = tidx[0], tidx[1]
    assert not th._alias_values
    assert hnsw_hbm_bytes(th) == hbm_bytes(th.values, th.nbr0, th.nbr_up)
    assert ivfflat_hbm_bytes(ti) == hbm_bytes(
        ti.centroids, ti.postings_flat, ti.post_values, ti.post_vsq) > 0
    fresh = DenseTable(8, device="cpu")
    fresh.insert(np.random.default_rng(4).normal(size=(500, 8)))
    built = HNSWIndex(fresh, Metric.L2, m=8, ef_construction=32,
                      wave_size=512, dedup=False)
    assert built._alias_values  # the values are the table's own rows
    graph = hbm_bytes(built.nbr0, built.nbr_up)
    assert hnsw_hbm_bytes(built) == graph
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "bf16")
    built.search(np.zeros((1, 8), np.float32), 3)
    slab = built._nbr_vals
    assert slab.dtype == torch.bfloat16
    assert hnsw_hbm_bytes(built) == graph
    assert hnsw_hbm_bytes(built, slab=True) == graph + slab.numel() * 2
    assert hbm_bytes(None, (slab, None)) == slab.numel() * 2
