"""Exact search through both packages: DenseTable + FlatIndex at 6,000 ×
32 rows with deleted rows.  With the default engine (PGVECTOR_TPU_EXACT
unset, ``grouped``) L2 and inner product take the port's K1 gate (its
plain version on the CPU) and cosine the grouped engine, against the
reference's plain engine (PGVECTOR_TPU_EXACT=xla for its call).  Then the
grouped engine against the reference's under ``grouped``: L2, inner
product and cosine over f32, bf16 and f16 tables of 5,000 rows with
deletes and a filter, at k 10 and at k 100 through the chunked refine;
and the ``pallas`` and ``xla`` mappings.  Tolerance as in test_torch_ops
(f32 reassociation)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import DenseTable, FlatIndex, Metric  # noqa: E402
from pgvector_tpu_torch.ops.fused_topk import (  # noqa: E402
    k1_l2_error_bound, l2_root_bound)
from torch_parity import assert_same_topk  # noqa: E402


@pytest.mark.parametrize("metric,path", [("L2", "fused"), ("IP", "fused"),
                                         ("COSINE", "grouped")])
def test_flat_search_matches_reference(metric, path, monkeypatch):
    monkeypatch.delenv("PGVECTOR_TPU_EXACT", raising=False)
    rng = np.random.default_rng(6)
    db = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    dead = rng.choice(6000, size=300, replace=False)
    jt, tt = JTable(32), DenseTable(32, device="cpu")
    jt.insert(db)
    tt.insert(db)
    jt.delete(dead)
    tt.delete(dead)
    with monkeypatch.context() as mp:
        mp.setenv("PGVECTOR_TPU_EXACT", "xla")
        d0, i0 = JFlat(jt, JMetric[metric]).search(q, 10)
    flat = FlatIndex(tt, Metric[metric])
    d1, i1 = flat.search(q, 10)
    assert flat.last_path == path
    assert_same_topk(d0, i0, d1, i1)
    assert not np.isin(i1, dead).any()


@pytest.mark.parametrize("dim", [32, 128])
def test_l2_root_bound_at_a_self_match(dim, monkeypatch):
    """Queries equal to stored rows: the reference's L2 distances against
    the port's on the K1 route (its plain version here) within the root
    bound derived from K1's (ops/fused_topk.l2_root_bound over
    k1_l2_error_bound).  Then the port's squared distances moved by the
    squared bound E pass, and moved by 4E fail, at the self-match (root
    sqrt(E)) and at a far row (root E / r): the root tolerance is the
    derivation's, neither looser nor tighter."""
    monkeypatch.delenv("PGVECTOR_TPU_EXACT", raising=False)
    rng = np.random.default_rng(21 + dim)
    db = (rng.normal(size=(5000, dim)) * 2).astype(np.float32)
    pick = np.array([3, 700, 4999])
    q = db[pick]
    jt, tt = JTable(dim), DenseTable(dim, device="cpu")
    jt.insert(db)
    tt.insert(db)
    with monkeypatch.context() as mp:
        mp.setenv("PGVECTOR_TPU_EXACT", "xla")
        d0, i0 = JFlat(jt, JMetric.L2).search(q, 10)
    flat = FlatIndex(tt, Metric.L2)
    d1, i1 = flat.search(q, 10)
    assert flat.last_path == "fused"
    np.testing.assert_array_equal(i0[:, 0], pick)
    np.testing.assert_array_equal(i1[:, 0], pick)
    e = k1_l2_error_bound(torch.as_tensor(q), torch.as_tensor(db), i0, i1)
    atol = l2_root_bound(e, d0).numpy()
    assert_same_topk(d0, i0, d1, i1, atol=atol, rtol=0.0)
    e = e.numpy().astype(np.float64)
    r = d0.astype(np.float64)
    assert (atol[:, 0] > np.sqrt(e[:, 0])).all()  # sqrt(E) at r = 0
    # the reference's squared distances moved by E: within the bound
    at_bound = np.sqrt(r * r + e).astype(np.float32)
    assert_same_topk(d0, i0, at_bound, i0, atol=atol, rtol=0.0)
    for pos in (0, 9):  # the self-match, the tenth row
        over = d0.copy()
        over[:, pos] = np.sqrt(r[:, pos] ** 2 + 4 * e[:, pos])
        with pytest.raises(AssertionError, match="beyond their bound"):
            assert_same_topk(d0, i0, over, i0, atol=atol, rtol=0.0)


_DTYPES = {"f32": (np.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "f16": (np.float16, torch.float16)}


@pytest.fixture(scope="module")
def grouped_data():
    rng = np.random.default_rng(31)
    db = rng.normal(size=(5000, 32)).astype(np.float32)
    db[17] = 0.0  # a zero row: +inf for cosine in both
    q = rng.normal(size=(12, 32)).astype(np.float32)
    dead = rng.choice(5000, size=400, replace=False)
    fmask = rng.random(5000) > 0.3
    return db, q, dead, fmask


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_grouped_matches_reference(grouped_data, metric, dtype, k,
                                   monkeypatch):
    """The port's default engine against the reference's grouped engine:
    K1 inside its gate (f32 L2/IP at k 10), the grouped engine for the
    rest.  At k 100 the port's refine is chunked (REFINE_BYTES cut to 64
    candidates a chunk, 25 chunks) and the reference's is whole: the
    running merge is exact, so both give the same top-k."""
    import pgvector_tpu_torch.ops.topk as TK

    monkeypatch.setenv("PGVECTOR_TPU_EXACT", "grouped")
    db, q, dead, fmask = grouped_data
    jdt, tdt = _DTYPES[dtype]
    jt, tt = JTable(32, dtype=jdt), DenseTable(32, dtype=tdt, device="cpu")
    jt.insert(db)
    tt.insert(db)
    jt.delete(dead)
    tt.delete(dead)
    if k == 100:
        monkeypatch.setattr(TK, "REFINE_BYTES", len(q) * 32 * 4 * 64)
    ref, flat = JFlat(jt, JMetric[metric]), FlatIndex(tt, Metric[metric])
    for f in (None, fmask):
        d0, i0 = ref.search(q, k, filter_mask=f)
        d1, i1 = flat.search(q, k, filter_mask=f)
        assert ref.last_path == "grouped"
        fused = metric != "COSINE" and dtype == "f32" and k <= 64
        assert flat.last_path == ("fused" if fused else "grouped")
        assert_same_topk(d0, i0, d1, i1)
        assert not np.isin(i1, dead).any()
        if f is not None:
            assert f[i1[i1 >= 0]].all()


@pytest.mark.parametrize("mode,case,path", [
    ("pallas", ("L2", 10, 5000), "fused"),
    ("pallas", ("L2", 100, 5000), "tiled"),
    ("pallas", ("COSINE", 10, 5000), "tiled"),
    ("xla", ("L2", 10, 5000), "tiled"),
    ("xla", ("COSINE", 100, 5000), "tiled"),
    ("grouped", ("L2", 10, 5000), "fused"),
    ("grouped", ("L2", 100, 5000), "grouped"),
    ("grouped", ("L1", 10, 5000), "tiled"),
    ("grouped", ("COSINE", 10, 4095), "tiled"),
])
def test_exact_mode_routes(grouped_data, mode, case, path, monkeypatch):
    """``pallas`` is K1 inside its gate and the tiled scan outside it,
    ``xla`` always the tiled scan; ``grouped`` leaves L1 and tables under
    4,096 rows to the tiled scan.  Every route gives the tiled scan's
    top-k."""
    metric, k, n = case
    db, q, _, _ = grouped_data
    tt = DenseTable(32, device="cpu")
    tt.insert(db[:n])
    monkeypatch.setenv("PGVECTOR_TPU_EXACT", "xla")
    d0, i0 = FlatIndex(tt, Metric[metric]).search(q, k)
    monkeypatch.setenv("PGVECTOR_TPU_EXACT", mode)
    flat = FlatIndex(tt, Metric[metric])
    d1, i1 = flat.search(q, k)
    assert flat.last_path == path
    assert_same_topk(d0, i0, d1, i1)


def test_table_without_device_needs_a_card(monkeypatch):
    """A table that names no device lives on the card; without one it
    raises and names the way out, and never moves to the CPU quietly."""
    from pgvector_tpu_torch.errors import DataException
    from pgvector_tpu_torch.io.convert import table_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DataException, match='device="cpu"'):
        DenseTable(8)
    with pytest.raises(DataException, match='device="cpu"'):
        table_from_numpy(np.zeros((4, 8), np.float32), np.ones(4, bool))
    t = DenseTable(8, device="cpu")
    t.insert(np.ones((3, 8), np.float32))
    assert t.device.type == "cpu" and t.data.device.type == "cpu"
    assert t.count == 3


_VALUES = [
    ("Vector", [1.0, -2.5, 3.0]),
    ("Vector", []),
    ("Vector", [[1.0, 2.0]]),
    ("Vector", [1.0, float("nan")]),
    ("Vector", [float("inf"), 0.0]),
    ("Vector", np.zeros(16001)),
    ("HalfVec", [0.5, -2.0, 1.0 / 3.0]),
    ("HalfVec", [1e6, 0.0]),  # overflows float16: refused as infinite
    ("HalfVec", np.zeros(16001)),
]


@pytest.mark.parametrize("kind,values", _VALUES)
def test_value_types_match_reference(kind, values):
    """The port's value types take and refuse what the reference's
    constructors take and refuse, with the same error class and text."""
    import pgvector_tpu.types as JT
    import pgvector_tpu_torch.types as TT

    out = []
    for mod in (JT, TT):
        try:
            with np.errstate(over="ignore"):
                out.append(getattr(mod, kind)(values))
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append((type(e).__name__, str(e)))
    ref, got = out
    if isinstance(ref, tuple):
        assert got == ref
    else:
        assert got.x.dtype == ref.x.dtype and got.dim == ref.dim
        np.testing.assert_array_equal(got.x, ref.x)


def test_flat_search_takes_value_types():
    """A Vector, a HalfVec or a list of them as the query gives the same
    results as the array, in both packages."""
    from pgvector_tpu.types import HalfVec as JHalf, Vector as JVec
    from pgvector_tpu_torch import HalfVec, Vector

    rng = np.random.default_rng(7)
    db = rng.normal(size=(500, 8)).astype(np.float32)
    q = rng.normal(size=(3, 8)).astype(np.float16).astype(np.float32)
    jt, tt = JTable(8), DenseTable(8, device="cpu")
    jt.insert(db)
    tt.insert([Vector(r) for r in db])
    jflat, flat = JFlat(jt, JMetric.L2), FlatIndex(tt, Metric.L2)
    d_arr, i_arr = flat.search(q, 5)
    for query, jquery in (([Vector(r) for r in q], [JVec(r) for r in q]),
                          ([HalfVec(r) for r in q], [JHalf(r) for r in q])):
        d1, i1 = flat.search(query, 5)
        np.testing.assert_array_equal(i1, i_arr)
        np.testing.assert_array_equal(d1, d_arr)
        d0, i0 = jflat.search(jquery, 5)
        assert_same_topk(d0, i0, d1, i1)
    d1, i1 = flat.search(Vector(q[0]), 5)
    np.testing.assert_array_equal(i1, i_arr[:1])
