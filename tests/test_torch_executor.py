"""The batching executor of the port (tests/test_executor.py's cases):
concurrent single-query submits coalesce into batches and return each
query's own result — the same as the reference's executor over the same
rows (ids equal apart from ties, distances within torch_parity's
tolerance); writes run strictly between read batches, so reads submitted
before a write see the state before it and reads after it the state
after; a failing batch or write sets its exception on every waiter and
the dispatcher carries on.  Every ``result()`` and ``shutdown`` has a
timeout and every test shuts its executor down in ``finally``."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.runtime import BatchingExecutor as JExecutor  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import (DenseTable, FlatIndex, HNSWIndex,  # noqa: E402
                                Metric)
from pgvector_tpu_torch.runtime import BatchingExecutor  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

T = 60  # seconds any single wait may take


def _flat(db):
    t = DenseTable(db.shape[1], device="cpu")
    t.insert(db)
    return t, FlatIndex(t, Metric.L2)


def _threads(fn, n):
    th = [threading.Thread(target=fn, args=(j,)) for j in range(n)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=T)
    assert not any(t.is_alive() for t in th)


def test_concurrent_submits_match_reference():
    rng = np.random.default_rng(123)
    db = rng.normal(size=(500, 8)).astype(np.float32)
    q = db[:20] + rng.normal(scale=0.3, size=(20, 8)).astype(np.float32)
    jt = JTable(8)
    jt.insert(db)
    _, flat = _flat(db)
    out = {}
    for name, ex in (("ref", JExecutor(JFlat(jt, JMetric.L2), max_batch=16,
                                       max_wait_ms=5)),
                     ("port", BatchingExecutor(flat, max_batch=16,
                                               max_wait_ms=5))):
        res = [None] * 20
        try:
            def worker(j):
                res[j] = ex.search(q[j], 5, timeout=T)
            _threads(worker, 20)
        finally:
            ex.shutdown()
        out[name] = (np.stack([r[0] for r in res]),
                     np.stack([r[1] for r in res]))
    assert_same_topk(*out["ref"], *out["port"])
    assert_same_topk(*flat.search(q, 5), *out["port"])


def test_mixed_k():
    rng = np.random.default_rng(124)
    db = rng.normal(size=(100, 4)).astype(np.float32)
    _, flat = _flat(db)
    ex = BatchingExecutor(flat, max_wait_ms=1)
    try:
        f1, f2 = ex.submit(db[0], 3), ex.submit(db[1], 7)
        d1, i1 = f1.result(timeout=T)
        d2, i2 = f2.result(timeout=T)
        assert len(i1) == 3 and len(i2) == 7
        assert i1[0] == 0 and i2[0] == 1
        with pytest.raises(ValueError, match="single query"):
            ex.submit(db[:2], 1)
    finally:
        ex.shutdown()


def test_shutdown_rejects():
    _, flat = _flat(np.zeros((4, 4), np.float32))
    ex = BatchingExecutor(flat)
    ex.shutdown()
    assert not ex._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(np.zeros(4, np.float32), 1)
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit_write(lambda idx: None)


def test_failing_batch_and_write_reach_every_waiter():
    """A search that raises fails every query of its batch; a write that
    raises fails its own future; the dispatcher then serves on."""
    rng = np.random.default_rng(125)
    db = rng.normal(size=(50, 4)).astype(np.float32)
    _, flat = _flat(db)
    ex = BatchingExecutor(flat, max_batch=8, max_wait_ms=1)
    gate = threading.Event()
    try:
        # a write holds the dispatcher while four reads queue behind it,
        # so they form one batch; a query of the wrong width fails all four
        held = ex.submit_write(lambda idx: gate.wait(T))
        bad = [ex.submit(db[j], 3) for j in range(3)]
        bad.append(ex.submit(db[3, :3], 3))
        gate.set()
        assert held.result(timeout=T) is True
        for f in bad:
            with pytest.raises(ValueError):
                f.result(timeout=T)
        wf = ex.submit_write(lambda idx: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            wf.result(timeout=T)
        assert ex._thread.is_alive()
        d, i = ex.search(db[5], 3, timeout=T)
        assert i[0] == 5
        assert ex.write(lambda idx: "ok", timeout=T) == "ok"
    finally:
        ex.shutdown()


def test_reads_around_a_write_see_its_snapshot():
    """Queue order decides: reads submitted before a write equal the
    index's search on the state before it, reads after it the state
    after it."""
    rng = np.random.default_rng(126)
    db = rng.normal(size=(900, 8)).astype(np.float32)
    table = DenseTable(8, device="cpu")
    table.insert(db[:600])
    idx = HNSWIndex(table, Metric.L2, m=8, ef_construction=32,
                    wave_size=128, beam_expand=4)
    q = db[600:700] + 0.01  # the write inserts their neighbours
    before = idx.search(q, 5, ef_search=40)
    ex = BatchingExecutor(idx, max_batch=16, max_wait_ms=1, ef_search=40)
    lock, order, futs = threading.Lock(), [0], {}

    def submit(j):
        with lock:
            futs[j] = (order[0], ex.submit(q[j], 5))
            order[0] += 1

    def insert(index):
        rows = table.insert(db[600:])
        index.insert(rows)

    try:
        for j in range(50):
            submit(j)
        with lock:
            w_at = order[0]
            wf = ex.submit_write(insert)
            order[0] += 1
        _threads(lambda j: submit(50 + j), 50)
        wf.result(timeout=T)
        res = {j: (s, f.result(timeout=T)) for j, (s, f) in futs.items()}
    finally:
        ex.shutdown()
    after = idx.search(q, 5, ef_search=40)
    pre = [j for j, (s, _) in res.items() if s < w_at]
    post = [j for j, (s, _) in res.items() if s > w_at]
    assert len(pre) == 50 and len(post) == 50
    for js, ref in ((pre, before), (post, after)):
        got_d = np.stack([res[j][1][0] for j in js])
        got_i = np.stack([res[j][1][1] for j in js])
        assert_same_topk(ref[0][js], ref[1][js], got_d, got_i)
    # the write changed the answers: post reads find the new rows
    assert (after[1][:, 0] >= 600).mean() > 0.9


def test_writer_serialized_with_reads():
    """Reader threads hammer searches while inserts and a vacuum flow
    through submit_write(): every (distance, row) pair matches the row's
    true stored vector, and the final state matches exact search."""
    rng = np.random.default_rng(99)
    db = rng.normal(size=(1200, 8)).astype(np.float32)
    table = DenseTable(8, device="cpu")
    rows0 = table.insert(db[:600])
    idx = HNSWIndex(table, Metric.L2, m=8, ef_construction=32,
                    wave_size=128, beam_expand=4)
    ex = BatchingExecutor(idx, max_batch=8, max_wait_ms=1)
    queries = db[:24] + 0.01
    stop = threading.Event()
    failures = []

    def reader(j):
        while not stop.is_set():
            try:
                d, r = ex.search(queries[j % 24], 5, timeout=T)
            except Exception as exc:  # pragma: no cover
                failures.append(exc)
                return
            for dd, rr in zip(d, r):
                if rr < 0:
                    continue
                true = np.sqrt(((queries[j % 24] - db[int(rr)]) ** 2).sum())
                if abs(dd - true) > 1e-3:
                    failures.append(AssertionError(
                        f"torn read: row {rr} d={dd} true={true}"))
                    return

    readers = [threading.Thread(target=reader, args=(j,)) for j in range(4)]
    for t in readers:
        t.start()
    try:
        for s in range(600, 1200, 200):
            chunk = db[s: s + 200]

            def do_insert(index, chunk=chunk):
                rows = table.insert(chunk)
                index.insert(rows)
                return rows

            ex.write(do_insert, timeout=T)

        def do_vacuum(index):
            table.delete(rows0[:100])
            index.vacuum()

        ex.write(do_vacuum, timeout=T)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=T)
        ex.shutdown()
    assert not any(t.is_alive() for t in readers)
    assert not failures, failures[:3]
    exact_d, exact_i = FlatIndex(table, Metric.L2).search(queries, 5)
    d, r = idx.search(queries, 5, ef_search=64)
    hits = sum(len(set(map(int, a)) & set(map(int, e)))
               for a, e in zip(r, exact_i))
    assert hits / (5 * len(queries)) >= 0.9


def test_lone_write_does_not_busy_spin():
    _, flat = _flat(np.zeros((4, 4), np.float32))
    ex = BatchingExecutor(flat, max_wait_ms=0.5)
    try:
        assert ex.write(lambda idx: 42, timeout=T) == 42
        time.sleep(0.2)
        assert not ex._wake.is_set()
        t0 = time.process_time()
        time.sleep(0.5)
        assert time.process_time() - t0 < 0.25  # idle, not spinning
    finally:
        ex.shutdown()
