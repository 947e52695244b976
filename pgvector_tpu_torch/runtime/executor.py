"""Micro-batching query executor + serialized writer — the serving runtime
around the kernels, counterpart of ``pgvector_tpu.runtime.executor``.

In the reference, Postgres's executor owns concurrency: each backend runs
one scan, sharing buffers under a documented lock hierarchy (hnsw.h:232-252
LWLocks, HNSW_UPDATE_LOCK/HNSW_SCAN_LOCK page locks, hnswinsert.c:705-731),
so inserts, scans and vacuums race safely.  The port gets the same
property structurally: ALL reads and mutations of the index are funneled
through one dispatcher thread, which is the only thread that touches the
index's tensors and host-side metadata while the executor runs.  A read
batch and a write op never interleave — every search batch sees the
index exactly as some prefix of the write history left it
(snapshot-consistent reads), which is the library-appropriate form of the
reference's lock handshakes.

**Single-writer contract**: `HNSWIndex`/`IVFFlatIndex` methods are NOT
thread-safe against each other.  Concurrent use requires either external
serialization or this executor: `submit()` for reads, `submit_write()` for
mutations.  The contract is pinned by tests/test_executor.py's threaded
insert/vacuum-vs-scan races (the pgbench methodology of test/t/016,
046-048).

Latency/throughput knobs mirror a production server: ``max_batch`` (pad
target) and ``max_wait_ms`` (batching window).

The dispatcher is a Python thread that launches CUDA work.  It makes the
index's card its current device, so every launch goes to that card's
default stream, which its kernels' wrappers read per launch
(``torch.cuda.current_stream()``) on the thread that calls them; the
searches return numpy arrays, so a batch's results are complete on the
host before its futures resolve.  A failing batch or write sets its
exception on every waiter and the dispatcher carries on.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class _Pending:
    query: np.ndarray
    k: int
    future: Future = field(default_factory=Future)


@dataclass
class _Write:
    fn: Callable[[Any], Any]
    future: Future = field(default_factory=Future)


class BatchingExecutor:
    """Wraps any index with a ``search(qs, k, **kw)`` batch method and
    serializes mutations against read batches (single-writer contract)."""

    def __init__(self, index, max_batch: int = 256, max_wait_ms: float = 2.0,
                 **search_kwargs):
        self.index = index
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.search_kwargs = search_kwargs
        self._queue: Deque[Any] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client API
    def submit(self, query, k: int) -> Future:
        """Enqueue one query; resolves to (dists, ids) 1-D arrays."""
        q = np.asarray(query, dtype=np.float32)
        if q.ndim != 1:
            raise ValueError("submit() takes a single query vector")
        p = _Pending(q, k)
        self._enqueue(p)
        return p.future

    def submit_write(self, fn: Callable[[Any], Any]) -> Future:
        """Enqueue a mutation.  ``fn(index)`` runs on the dispatcher thread,
        strictly serialized against read batches and other writes — the
        analogue of the reference's HNSW_UPDATE_LOCK/entry-lock handshakes
        (hnswinsert.c:705-731; hnswvacuum.c:389-390).  The future resolves
        to fn's return value.  Queue order is preserved: reads submitted
        before a write see the pre-write state; reads after it see the
        post-write state."""
        w = _Write(fn)
        self._enqueue(w)
        return w.future

    def _enqueue(self, item) -> None:
        with self._lock:
            if self._stop:
                raise RuntimeError("executor is shut down")
            self._queue.append(item)
        self._wake.set()

    def search(self, query, k: int, timeout: Optional[float] = 30.0):
        """Synchronous convenience wrapper."""
        return self.submit(query, k).result(timeout=timeout)

    def write(self, fn: Callable[[Any], Any], timeout: Optional[float] = 120.0):
        """Synchronous mutation wrapper."""
        return self.submit_write(fn).result(timeout=timeout)

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)

    # ---------------------------------------------------------- dispatch loop
    def _drain(self) -> Tuple[List[_Pending], Optional[_Write]]:
        """Pop the next unit of work preserving submission order: either a
        contiguous run of reads (coalesced into one batch) or one write."""
        with self._lock:
            if not self._queue:
                self._wake.clear()
                return [], None
            if isinstance(self._queue[0], _Write):
                w = self._queue.popleft()
                if not self._queue:
                    self._wake.clear()
                return [], w
            batch: List[_Pending] = []
            while (self._queue and len(batch) < self.max_batch
                   and isinstance(self._queue[0], _Pending)):
                batch.append(self._queue.popleft())
            if not self._queue:
                self._wake.clear()
            return batch, None

    def _device(self):
        dev = getattr(self.index, "device", None)
        if dev is None:
            dev = getattr(getattr(self.index, "table", None), "device", None)
        return dev

    def _loop(self) -> None:
        dev = self._device()
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)  # this thread's launches go there
        while True:
            self._wake.wait(timeout=0.1)
            with self._lock:
                if self._stop and not self._queue:
                    return
                have = len(self._queue)
            if not have:
                continue
            # batching window: give co-arriving queries a chance to coalesce
            if have < self.max_batch:
                time.sleep(self.max_wait)
            batch, write = self._drain()
            if write is not None:
                try:
                    write.future.set_result(write.fn(self.index))
                except Exception as exc:
                    write.future.set_exception(exc)
                continue
            if not batch:
                continue
            try:
                self._run(batch)
            except Exception as exc:  # propagate to all waiters
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _run(self, batch: List[_Pending]) -> None:
        k_max = max(p.k for p in batch)
        qs = np.stack([p.query for p in batch])
        d, i = self.index.search(qs, k_max, **self.search_kwargs)
        for row, p in enumerate(batch):
            p.future.set_result((d[row, : p.k], i[row, : p.k]))
