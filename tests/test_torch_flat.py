"""Exact search through both packages: DenseTable + FlatIndex at 6,000 ×
32 rows with deleted rows.  L2 and inner product take the port's K1 gate
(its plain version on the CPU); cosine takes the tiled scan.  The
reference runs its plain engine (PGVECTOR_TPU_EXACT=xla), as its own
tests do off TPU.  Tolerance as in test_torch_ops (f32 reassociation)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import DenseTable, FlatIndex, Metric  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402


@pytest.mark.parametrize("metric,path", [("L2", "fused"), ("IP", "fused"),
                                         ("COSINE", "tiled")])
def test_flat_search_matches_reference(metric, path, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_EXACT", "xla")
    rng = np.random.default_rng(6)
    db = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(20, 32)).astype(np.float32)
    dead = rng.choice(6000, size=300, replace=False)
    jt, tt = JTable(32), DenseTable(32)
    jt.insert(db)
    tt.insert(db)
    jt.delete(dead)
    tt.delete(dead)
    d0, i0 = JFlat(jt, JMetric[metric]).search(q, 10)
    flat = FlatIndex(tt, Metric[metric])
    d1, i1 = flat.search(q, 10)
    assert flat.last_path == path
    assert_same_topk(d0, i0, d1, i1)
    assert not np.isin(i1, dead).any()


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
    jt, tt = JTable(8), DenseTable(8)
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
