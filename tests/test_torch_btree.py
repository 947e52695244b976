"""The btree opclass index through both packages: the same rows in a
reference table and a port table (dense f32 / bf16 / f16, bit, sparse),
and ``OrderedIndex`` on each.  Scans, equality lookups and range
predicates return the same rows in the same order exactly — the order
is the total value order with row ids breaking ties, ``-0.0`` equal to
``+0.0``, sparse rows compared as if dense — before and after online
inserts, deletes and vacuums; errors carry the same class and message
(test/sql/btree.sql, tests/test_btree.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index.btree import OrderedIndex as JOrdered  # noqa: E402
from pgvector_tpu.relation import Relation as JRelation  # noqa: E402
from pgvector_tpu.store.table import BitTable as JBitTable  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu.store.table import SparseTable as JSparseTable  # noqa: E402
from pgvector_tpu.types import Bit as JBit  # noqa: E402
from pgvector_tpu.types import SparseVec as JSparseVec  # noqa: E402
from pgvector_tpu_torch import (Bit, BitTable, DenseTable, Relation,  # noqa: E402
                                SparseTable, SparseVec)
from pgvector_tpu_torch.index.btree import OrderedIndex  # noqa: E402


def _outcome(fn):
    try:
        return ("ok", np.asarray(fn()).tolist())
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return ("raise", type(exc).__name__, str(exc))


def _same(fj, ft):
    a, b = _outcome(fj), _outcome(ft)
    assert b == a, (a, b)
    return a


def _dense_rows(seed, n=300, d=3):
    """Rows with duplicates, ±0.0, a low-cardinality column (long equal
    runs) and values that differ only in late dims."""
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    db[:, 0] = rng.integers(-2, 3, n)  # ties in the first dim
    db[10] = db[20]
    db[30, :] = 0.0
    db[31, :] = -0.0
    db[32, 0] = -0.0
    db[33] = db[32]
    db[33, 0] = 0.0
    db[40:44] = db[45]
    return db


def _dense_pair(db, dtype):
    jt = JTable(db.shape[1], dtype=jnp.dtype(dtype))
    jt.insert(db)
    tt = DenseTable(db.shape[1], dtype=getattr(torch, dtype), device="cpu")
    tt.insert(db)
    return jt, tt


def _check_queries(ji, ti, probes, bounds):
    _same(ji.scan, ti.scan)
    _same(lambda: ji.scan(ascending=False), lambda: ti.scan(ascending=False))
    for j, t in probes:
        _same(lambda: ji.search_eq(j), lambda: ti.search_eq(t))
    for (jl, tl), (jh, th) in bounds:
        for li in (True, False):
            for hi in (True, False):
                _same(lambda: ji.search_range(jl, jh, li, hi),
                      lambda: ti.search_range(tl, th, li, hi))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dense_orders_equal(dtype):
    db = _dense_rows(5)
    jt, tt = _dense_pair(db, dtype)
    ji, ti = JOrdered(jt), OrderedIndex(tt)
    stored = np.asarray(jt.data[: jt.count]).astype(np.float32)
    probes = [(stored[r], stored[r]) for r in (0, 10, 30, 31, 32, 41, 299)]
    probes += [(np.zeros(3, np.float32), np.zeros(3, np.float32)),
               (np.float32([-0.0, 0.0, -0.0]),) * 2,
               (np.float32([9, 9, 9]),) * 2]
    bounds = [((stored[3], stored[3]), (stored[7], stored[7])),
              ((None, None), (stored[30], stored[30])),
              ((stored[31], stored[31]), (None, None)),
              ((np.float32([-1, 0, 0]),) * 2, (np.float32([1, 0, 0]),) * 2),
              ((None, None), (None, None))]
    _check_queries(ji, ti, probes, bounds)


def test_dense_online_maintenance_equal():
    """Build over 200 rows, insert 100 more out of order, delete, vacuum:
    equal orders at each step, and equal to a rebuild."""
    db = _dense_rows(6, n=300, d=4)
    jt, tt = _dense_pair(db[:200], "float32")
    ji, ti = JOrdered(jt), OrderedIndex(tt)
    rows = jt.insert(db[200:])
    np.testing.assert_array_equal(rows, tt.insert(db[200:]))
    order = np.random.default_rng(1).permutation(rows)
    ji.insert(order)
    ti.insert(order)
    _same(ji.scan, ti.scan)
    assert ti._rows == OrderedIndex(tt)._rows
    dead = np.arange(0, 300, 7)
    jt.delete(dead)
    tt.delete(dead)
    _same(ji.scan, ti.scan)  # dead rows filtered before vacuum
    _same(lambda: ji.search_eq(db[14]), lambda: ti.search_eq(db[14]))
    ji.vacuum()
    ti.vacuum()
    assert ti._rows == ji._rows
    assert ti._keys == ji._keys


def test_bulk_insert_matches_rebuild_and_reference():
    rng = np.random.default_rng(7)
    db = rng.integers(0, 4, size=(20_000, 2)).astype(np.float32)
    jt, tt = _dense_pair(db[:2_000], "float32")
    ji, ti = JOrdered(jt), OrderedIndex(tt)
    for lo in range(2_000, 20_000, 6_000):
        rows = tt.insert(db[lo:lo + 6_000])
        jt.insert(db[lo:lo + 6_000])
        ti.insert(rows)
        ji.insert(rows)
    rebuilt = OrderedIndex(tt)
    assert ti._rows == rebuilt._rows == ji._rows
    assert ti._keys == rebuilt._keys == ji._keys


def test_bit_orders_equal():
    rng = np.random.default_rng(8)
    bits = rng.random((120, 37)) < 0.5
    bits[5] = bits[6]
    bits[7] = False
    bits[8] = True
    jt, tt = JBitTable(37), BitTable(37, device="cpu")
    jt.insert(bits)
    tt.insert(bits)
    ji, ti = JOrdered(jt), OrderedIndex(tt)
    probes = [(JBit(bits[r]), Bit(bits[r])) for r in (0, 5, 7, 8, 119)]
    probes.append((bits[3], bits[3]))
    bounds = [((JBit(bits[2]), Bit(bits[2])), (JBit(bits[9]), Bit(bits[9]))),
              ((None, None), (JBit(bits[7]), Bit(bits[7])))]
    _check_queries(ji, ti, probes, bounds)
    t2, j2 = BitTable(3, device="cpu"), JBitTable(3)
    t2.insert([Bit(s) for s in ("000", "001", "010", "110", "111")])
    j2.insert([JBit(s) for s in ("000", "001", "010", "110", "111")])
    _same(lambda: JOrdered(j2).search_range(JBit("010"), JBit("110")),
          lambda: OrderedIndex(t2).search_range(Bit("010"), Bit("110")))


def _sparse_rows(seed, n=150, d=9):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((n, d)) < 0.7, 0.0,
                     rng.integers(-3, 4, (n, d))).astype(np.float32)
    dense[3] = dense[4]
    dense[5] = 0.0
    dense[6, :] = 0.0
    dense[6, 0] = -1.0
    return dense


def test_sparse_orders_equal():
    dense = _sparse_rows(9)
    jt, tt = JSparseTable(9, nnz_cap=9), SparseTable(9, nnz_cap=9,
                                                     device="cpu")
    jt.insert([JSparseVec.from_dense(r) for r in dense])
    tt.insert([SparseVec.from_dense(r) for r in dense])
    ji, ti = JOrdered(jt), OrderedIndex(tt)
    probes = [(JSparseVec.from_dense(dense[r]), SparseVec.from_dense(dense[r]))
              for r in (0, 3, 5, 6, 149)]
    zero = np.zeros(9, np.float32)
    bounds = [((JSparseVec.from_dense(zero), SparseVec.from_dense(zero)),
               (JSparseVec.from_dense(dense[1]),
                SparseVec.from_dense(dense[1]))),
              ((JSparseVec.from_dense(dense[6]),
                SparseVec.from_dense(dense[6])), (None, None))]
    _check_queries(ji, ti, probes, bounds)
    extra = _sparse_rows(10, n=30)
    rows = tt.insert([SparseVec.from_dense(r) for r in extra])
    jt.insert([JSparseVec.from_dense(r) for r in extra])
    ti.insert(rows)
    ji.insert(rows)
    _same(ji.scan, ti.scan)


def test_errors_equal():
    jt, tt = _dense_pair(np.zeros((2, 3), np.float32), "float32")
    ji, ti = JOrdered(jt), OrderedIndex(tt)
    assert _same(lambda: ji.search_eq([1.0, 2.0]),
                 lambda: ti.search_eq([1.0, 2.0]))[0] == "raise"
    jb, tb = JBitTable(4), BitTable(4, device="cpu")
    assert _same(lambda: JOrdered(jb).search_eq(JBit("101")),
                 lambda: OrderedIndex(tb).search_eq(Bit("101")))[0] == "raise"
    js, ts = JSparseTable(4), SparseTable(4, device="cpu")
    assert _same(lambda: JOrdered(js).search_eq([1, 2, 3, 4]),
                 lambda: OrderedIndex(ts).search_eq([1, 2, 3, 4]))[0] == \
        "raise"
    assert _same(
        lambda: JOrdered(js).search_eq(JSparseVec.from_dense([1, 2])),
        lambda: OrderedIndex(ts).search_eq(SparseVec.from_dense([1, 2])))[0] \
        == "raise"
    assert _same(lambda: JOrdered(object()), lambda: OrderedIndex(object()))[
        0] == "raise"


def test_relation_btree_ddl_equal():
    rng = np.random.default_rng(8)
    db = rng.normal(size=(50, 4)).astype(np.float32)
    jr, tr = JRelation(JTable(4)), Relation(DenseTable(4, device="cpu"))
    jr.insert(db)
    tr.insert(db)
    ji, ti = jr.create_index("btree"), tr.create_index("btree")
    _same(lambda: ji.search_eq(db[3]), lambda: ti.search_eq(db[3]))
    jr.insert(db[:2])
    tr.insert(db[:2])
    assert _same(lambda: ji.search_eq(db[0]),
                 lambda: ti.search_eq(db[0])) == ("ok", [0, 50])
    assert _same(lambda: jr.create_index("hnsw"),
                 lambda: tr.create_index("hnsw"))[0] == "raise"
