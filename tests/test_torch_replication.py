"""Replication delta logs through both packages (test/t/001_wal.pl,
tests/test_replication.py).

The record format is the reference's, so a log written by either package
replays in the other: a primary in one package logs inserts, deletes and
vacuums; a replica in the other starts from the primary's base
checkpoint and replays the log.  The replica's table then equals the
primary's row for row, its HNSW bookkeeping (levels, element rows, free
slots, entry point) and IVF lists equal the primary's, and its searches
return the primary's ids apart from ties, distances within
torch_parity's tolerance (the graphs' neighbor lists are each package's
own build).  Within the port replay is bit-deterministic: graph arrays
and search results are equal bit for bit.  The gap, magic, version and
divergent-replica errors are the reference's, class and message."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.io import checkpoint as jck  # noqa: E402
from pgvector_tpu.io import replication as jrep  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import BitTable as JBitTable  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu.store.table import SparseTable as JSparseTable  # noqa: E402
from pgvector_tpu.types import SparseVec as JSparseVec  # noqa: E402
from pgvector_tpu_torch import (BitTable, DenseTable, FlatIndex,  # noqa: E402
                                HNSWIndex, IVFFlatIndex, Metric, Relation,
                                SparseTable, SparseVec)
from pgvector_tpu_torch.io import checkpoint as tck  # noqa: E402
from pgvector_tpu_torch.io import replication as trep  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402


@pytest.fixture(autouse=True)
def _row_scans(monkeypatch):
    """Both packages scan rows (no packed slab cache), visited set off."""
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "off")
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")


def _data():
    rng = np.random.default_rng(31)
    db = rng.normal(size=(1000, 10)).astype(np.float32)
    q = rng.normal(size=(12, 10)).astype(np.float32)
    return db, q


def _dense_rows(t):
    x = t.data[: t.count]
    return (x.float().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x).astype(np.float32))


def _valid(t):
    v = t.valid[: t.count]
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _assert_same_state(pt, ph, pi, rt, rh, ri, q):
    """Primary (pt, ph, pi) against replica (rt, rh, ri), either package
    on either side."""
    assert pt.count == rt.count
    np.testing.assert_array_equal(_dense_rows(pt), _dense_rows(rt))
    np.testing.assert_array_equal(_valid(pt), _valid(rt))
    n = ph.n_elems
    assert rh.n_elems == n
    np.testing.assert_array_equal(ph.levels[:n], rh.levels[:n])
    np.testing.assert_array_equal(ph.elem_rows[:n], rh.elem_rows[:n])
    assert list(ph.free_slots) == list(rh.free_slots)
    assert (ph.entry, ph.entry_level) == (rh.entry, rh.entry_level)
    np.testing.assert_array_equal(pi.list_lens, ri.list_lens)
    np.testing.assert_array_equal(pi.assignments, ri.assignments)
    # ef and probes wide enough to be exhaustive on this table
    assert_same_topk(*ph.search(q, 10, ef_search=400),
                     *rh.search(q, 10, ef_search=400))
    assert_same_topk(*pi.search(q, 10, probes=pi.lists),
                     *ri.search(q, 10, probes=ri.lists))


def _primary_ops(table, idxs, log, db):
    """Two insert / delete / vacuum cycles, each op logged (one insert
    wave each)."""
    for lo, hi, dele in ((600, 728, (0, 60)), (728, 856, (60, 130))):
        rows = table.insert(db[lo:hi])
        for ix in idxs:
            ix.insert(rows)
        log.log_insert(table, rows)
        dead = np.arange(*dele)
        table.delete(dead)
        log.log_delete(dead)
        for ix in idxs:
            ix.vacuum()
        log.log_vacuum()


def test_reference_log_replays_on_port(tmp_path):
    db, q = _data()
    jt = JTable(10)
    jt.insert(db[:600])
    jh = JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=128,
               beam_expand=4, seed=5)
    ji = JIVF(jt, JMetric.L2, lists=8, seed=3)
    jck.save_table(jt, str(tmp_path / "t"))
    jck.save_hnsw(jh, str(tmp_path / "h"))
    jck.save_ivfflat(ji, str(tmp_path / "i"))
    rt = tck.load_table(str(tmp_path / "t"), device="cpu")
    rh = tck.load_hnsw(rt, str(tmp_path / "h"))
    ri = tck.load_ivfflat(rt, str(tmp_path / "i"))
    log = jrep.ReplicationLog(str(tmp_path / "log"))
    _primary_ops(jt, [jh, ji], log, db)
    assert trep.apply_deltas(rt, [rh, ri], str(tmp_path / "log")) == 6
    _assert_same_state(jt, jh, ji, rt, rh, ri, q)
    e = JFlat(jt, JMetric.L2).search(q, 10)
    assert_same_topk(*e, *FlatIndex(rt, Metric.L2).search(q, 10))


def test_port_log_replays_on_reference(tmp_path):
    db, q = _data()
    tt = DenseTable(10, device="cpu")
    tt.insert(db[:600])
    th = HNSWIndex(tt, Metric.L2, m=8, ef_construction=32, wave_size=128,
                   beam_expand=4, seed=5)
    ti = IVFFlatIndex(tt, Metric.L2, lists=8, seed=3)
    tck.save_table(tt, str(tmp_path / "t"))
    tck.save_hnsw(th, str(tmp_path / "h"))
    tck.save_ivfflat(ti, str(tmp_path / "i"))
    jt = jck.load_table(str(tmp_path / "t"))
    jh = jck.load_hnsw(jt, str(tmp_path / "h"))
    ji = jck.load_ivfflat(jt, str(tmp_path / "i"))
    log = trep.ReplicationLog(str(tmp_path / "log"))
    _primary_ops(tt, [th, ti], log, db)
    assert jrep.apply_deltas(jt, [jh, ji], str(tmp_path / "log")) == 6
    _assert_same_state(tt, th, ti, jt, jh, ji, q)


def test_port_replay_is_bit_deterministic(tmp_path):
    """A port replica of a port primary wired through Relation (HNSW with
    dedup, IVFFlat, btree): the same graph arrays and bitwise-equal search
    results after every catch-up."""
    db, q = _data()
    rel = Relation(DenseTable(10, device="cpu"))
    rel.insert(db[:600])
    rel.insert(db[:5])  # duplicates: dedup attaches them
    h = rel.create_index("hnsw", Metric.L2, m=8, ef_construction=32,
                         wave_size=128, beam_expand=4, seed=5)
    iv = rel.create_index("ivfflat", Metric.L2, lists=8, seed=3)
    bt = rel.create_index("btree")
    tck.save_table(rel.table, str(tmp_path / "t"))
    tck.save_hnsw(h, str(tmp_path / "h"))
    tck.save_ivfflat(iv, str(tmp_path / "i"))
    rt = tck.load_table(str(tmp_path / "t"), device="cpu")
    replica = Relation(rt)
    replica.indexes = [tck.load_hnsw(rt, str(tmp_path / "h")),
                       tck.load_ivfflat(rt, str(tmp_path / "i"))]
    replica.create_index("btree")
    rel.replication_log = trep.ReplicationLog(str(tmp_path / "log"))
    applied = 0
    for lo, hi, dele in ((600, 800, (0, 60)), (800, 1000, (60, 130))):
        rel.insert(db[lo:hi])
        rel.delete(np.arange(*dele))
        rel.vacuum()
        applied = trep.apply_deltas(rt, replica.indexes,
                                    str(tmp_path / "log"), start_seq=applied)
        rh, ri, rb = replica.indexes
        n = h.n_elems
        assert rh.n_elems == n
        assert torch.equal(h.nbr0[:n], rh.nbr0[:n])
        assert torch.equal(h.values[:n], rh.values[:n])
        assert torch.equal(rel.table.data[: rel.table.count],
                           rt.data[: rt.count])
        assert torch.equal(rel.table.valid[: rel.table.count],
                           rt.valid[: rt.count])
        assert rb._rows == bt._rows
        for kw in ({"ef_search": 40}, {"probes": 3}):
            dp, ip = rel.knn(q, 10, **kw)
            dr, ir = replica.knn(q, 10, **kw)
            np.testing.assert_array_equal(ip, ir)
            np.testing.assert_array_equal(dp, dr)
    assert applied == 6
    # nothing new: a no-op at the same seq
    assert trep.apply_deltas(rt, replica.indexes, str(tmp_path / "log"),
                             start_seq=applied) == applied


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_delta_roundtrip_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(34)
    vals = rng.normal(size=(32, 8)).astype(np.float32)
    jp = JTable(8, dtype=jnp.dtype(dtype))
    tp = DenseTable(8, dtype=getattr(torch, dtype), device="cpu")
    jlog = jrep.ReplicationLog(str(tmp_path / "jlog"))
    tlog = trep.ReplicationLog(str(tmp_path / "tlog"))
    jlog.log_insert(jp, jp.insert(vals))
    tlog.log_insert(tp, tp.insert(vals))
    tr = DenseTable(8, dtype=getattr(torch, dtype), device="cpu")
    jr = JTable(8, dtype=jnp.dtype(dtype))
    assert trep.apply_deltas(tr, [], str(tmp_path / "jlog")) == 1
    assert jrep.apply_deltas(jr, [], str(tmp_path / "tlog")) == 1
    for t in (tp, tr, jr):
        np.testing.assert_array_equal(_dense_rows(t), _dense_rows(jp))


def _kind_rows(t):
    """A bit table's words as uint32, a sparse table's (idx, val)."""
    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if hasattr(t, "idx"):
        return host(t.idx[: t.count]), host(t.val[: t.count])
    return host(t.data[: t.count]).view(np.uint32)


def test_bit_and_sparse_logs_both_ways(tmp_path):
    rng = np.random.default_rng(35)
    bits = rng.random((40, 37)) < 0.5
    dense = np.where(rng.random((40, 9)) < 0.6, 0.0,
                     rng.normal(size=(40, 9))).astype(np.float32)
    prim = {"ref": (JBitTable(37), JSparseTable(9, nnz_cap=9), JSparseVec,
                    jrep),
            "port": (BitTable(37, device="cpu"),
                     SparseTable(9, nnz_cap=9, device="cpu"), SparseVec,
                     trep)}
    for name, (b, s, sv, rep) in prim.items():
        rep.ReplicationLog(str(tmp_path / name / "bit")).log_insert(
            b, b.insert(bits))
        rep.ReplicationLog(str(tmp_path / name / "sparse")).log_insert(
            s, s.insert([sv.from_dense(r) for r in dense]))
    for writer, reader in (("ref", "port"), ("port", "ref")):
        b, s, _, rep = prim[reader]
        rb, rs = type(b)(37, **({"device": "cpu"} if reader == "port"
                                else {})), None
        rs = (SparseTable(9, nnz_cap=9, device="cpu") if reader == "port"
              else JSparseTable(9, nnz_cap=9))
        assert rep.apply_deltas(rb, [], str(tmp_path / writer / "bit")) == 1
        assert rep.apply_deltas(rs, [],
                                str(tmp_path / writer / "sparse")) == 1
        np.testing.assert_array_equal(_kind_rows(rb), _kind_rows(b))
        for x, y in zip(_kind_rows(rs), _kind_rows(s)):
            np.testing.assert_array_equal(x, y)


def _log_with_three(tmp_path, rep):
    rng = np.random.default_rng(36)
    t = DenseTable(4, device="cpu") if rep is trep else JTable(4)
    log = rep.ReplicationLog(str(tmp_path / "log"))
    for _ in range(3):
        log.log_insert(t, t.insert(rng.normal(size=(4, 4)).astype(
            np.float32)))
    return str(tmp_path / "log")


def _corrupt(path, field, value):
    p = os.path.join(path, "delta_00000001", "record.json")
    with open(p) as f:
        rec = json.load(f)
    rec[field] = value
    with open(p, "w") as f:
        json.dump(rec, f)


FAULTS = {
    "gap": lambda p: shutil.rmtree(os.path.join(p, "delta_00000001")),
    "magic": lambda p: _corrupt(p, "magic", "not-a-delta"),
    "version": lambda p: _corrupt(p, "version", 9),
    "seq": lambda p: _corrupt(p, "seq", 7),
    "op": lambda p: _corrupt(p, "op", "truncate"),
    "divergent": lambda p: None,
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return ("raise", type(exc).__name__, str(exc))


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_replay_errors_equal(tmp_path, writer, fault):
    """A faulty log (written by either package) fails replay in both with
    the same class and message; a log re-opened past a gap never re-issues
    a sequence number."""
    path = _log_with_three(tmp_path, jrep if writer == "ref" else trep)
    FAULTS[fault](path)
    jr, tr = JTable(4), DenseTable(4, device="cpu")
    if fault == "divergent":  # an extra row shifts the replica's ids
        jr.insert(np.zeros((1, 4), np.float32))
        tr.insert(np.zeros((1, 4), np.float32))
    a = _outcome(lambda: jrep.apply_deltas(jr, [], path))
    b = _outcome(lambda: trep.apply_deltas(tr, [], path))
    assert b == a and a[0] == "raise", (a, b)
    assert trep.ReplicationLog(path).seq == jrep.ReplicationLog(path).seq == 3


def test_crashed_append_is_invisible_and_recoverable(tmp_path, monkeypatch):
    rng = np.random.default_rng(33)
    db = rng.normal(size=(60, 6)).astype(np.float32)
    table = DenseTable(6, device="cpu")
    log = trep.ReplicationLog(str(tmp_path / "log"))
    log.log_insert(table, table.insert(db[:30]))
    rows1 = table.insert(db[30:])
    real_save = np.save
    monkeypatch.setattr(np, "save", lambda *a, **k: (_ for _ in ()).throw(
        KeyboardInterrupt))
    with pytest.raises(KeyboardInterrupt):
        log.log_insert(table, rows1)
    monkeypatch.setattr(np, "save", real_save)
    names = sorted(os.listdir(tmp_path / "log"))
    assert "delta_00000001.tmp" in names and "delta_00000001" not in names
    # the reference's replay sees only the committed record too
    jr = JTable(6)
    assert jrep.apply_deltas(jr, [], str(tmp_path / "log")) == 1
    r_table = DenseTable(6, device="cpu")
    assert trep.apply_deltas(r_table, [], str(tmp_path / "log")) == 1
    assert r_table.live_count == jr.live_count == 30
    log2 = trep.ReplicationLog(str(tmp_path / "log"))
    assert log2.seq == 1
    log2.log_insert(table, rows1)
    assert trep.apply_deltas(r_table, [], str(tmp_path / "log"),
                             start_seq=1) == 2
    assert r_table.live_count == 60


def test_prune_up_to_checkpoint_base(tmp_path):
    rng = np.random.default_rng(34)
    db = rng.normal(size=(90, 6)).astype(np.float32)
    table = DenseTable(6, device="cpu")
    log = trep.ReplicationLog(str(tmp_path / "log"))
    for lo in (0, 30, 60):
        log.log_insert(table, table.insert(db[lo:lo + 30]))
    chk = DenseTable(6, device="cpu")
    base_seq = trep.apply_deltas(chk, [], str(tmp_path / "log"))
    assert base_seq == 3
    tck.save_table(chk, str(tmp_path / "base"))
    log.log_insert(table, table.insert(
        rng.normal(size=(10, 6)).astype(np.float32)))
    assert log.prune(base_seq) == 3
    r = tck.load_table(str(tmp_path / "base"), device="cpu")
    assert trep.apply_deltas(r, [], str(tmp_path / "log"),
                             start_seq=base_seq) == 4
    assert r.live_count == 100
    # the reference reads the pruned log and the port's base alike
    jr = jck.load_table(str(tmp_path / "base"))
    assert jrep.apply_deltas(jr, [], str(tmp_path / "log"),
                             start_seq=base_seq) == 4
    a = _outcome(lambda: jrep.apply_deltas(JTable(6), [],
                                           str(tmp_path / "log")))
    b = _outcome(lambda: trep.apply_deltas(DenseTable(6, device="cpu"), [],
                                           str(tmp_path / "log")))
    assert b == a and "gap" in a[2]
