"""The HNSW loops' host reads on the card: the main path's build and
searches with the beam loops' count of queries not done read every 1, 2,
4 and 8 hops (``hnsw_kernels.HOP_READ_EVERY``), in one process on one
card.

    python -m pgvector_tpu_torch.tools.hop_read_sweep [--n 1000000]
        [--every 1,2,4,8] [--builds 1,4]

On one upload of ``bench.make_data``'s surrogate (seed 0, the recipe of
:func:`.k1_breakdown.clustered`), K1's exact top-10 first; then for each
value of ``--builds`` the build (m 16, ef_construction 64, wave 1,024,
build beam 4: one K6 launch a hop) timed whole; the last build's index,
with the query beam 8 over the slab ``auto`` picks (one K2 launch a
hop), searched with each value of ``--every``: 8,000 queries at ef 40
and 100 (ms, QPS, recall@10, steps and launches) and 200 single
queries at ef 40 (p50 and p99 ms, host clock around each search); last,
with the package's constants, one ef 40 search of the 8,000 queries
through torch.profiler: its CUDA kernels over its layer-0 hops and the
device's busy share.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import DenseTable, FlatIndex, HNSWIndex, Metric
from ..index import hnsw_kernels as K
from .k1_breakdown import clustered, smi_line


def _recall(r, gt):
    return float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                          for a, b in zip(r, gt)]) / 10)


def _profile(fn, top=8):
    """(CUDA kernel launches, their summed device ms, wall ms, the ``top``
    busiest as [name, ms, launches]) of one call of ``fn``, the wall clock
    inside the profiler's session (its start and stop left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=lambda e: -e.self_device_time_total)
    return (sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3, wall,
            [[e.key[:72], e.self_device_time_total / 1e3, e.count]
             for e in ev[:top]])


def _searches(idx, qs, gt):
    """The sweep's searches at the constant in force."""
    row = {}
    for ef in (40, 100):
        idx.search(qs, 10, ef_search=ef)  # warm-up: builds the slab cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, r = idx.search(qs, 10, ef_search=ef)
        dt = time.perf_counter() - t0
        row[ef] = {"ms": dt * 1e3, "qps": len(qs) / dt,
                   "recall_at_10": _recall(r, gt),
                   "steps": idx._last_scan_steps,
                   "launches": idx._last_scan_launches}
    lat = []
    for i in range(200):
        t0 = time.perf_counter()
        idx.search(qs[i: i + 1], 10, ef_search=40)
        lat.append((time.perf_counter() - t0) * 1e3)
    row["single_ef40"] = {"p50_ms": float(np.percentile(lat, 50)),
                          "p99_ms": float(np.percentile(lat, 99))}
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=8000)
    ap.add_argument("--every", default="1,2,4,8")
    ap.add_argument("--builds", default="1,4")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hop_read_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    kept = K.HOP_READ_EVERY
    db, qs = clustered(args.n, args.queries)
    n, dim = db.shape
    table = DenseTable(dim, capacity=1 << (n - 1).bit_length(), device=dev)
    table.insert(db)
    _, gt = FlatIndex(table, Metric.L2, tile=16384).search(qs, 10)
    builds, idx = {}, None
    try:
        for every in (int(v) for v in args.builds.split(",")):
            K.HOP_READ_EVERY = every
            del idx
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64,
                            wave_size=1024, beam_expand=4, dedup=False)
            torch.cuda.synchronize()
            builds[every] = time.perf_counter() - t0
        idx.beam_expand = 8  # the query beam, as bench.py
        searches = {}
        for every in (int(v) for v in args.every.split(",")):
            K.HOP_READ_EVERY = every
            searches[f"beam {every}"] = _searches(idx, qs, gt)
    finally:
        K.HOP_READ_EVERY = kept
    _profile(lambda: idx.search(qs, 10, ef_search=40))  # the session's start
    kern, kern_ms, wall_ms, top = _profile(
        lambda: idx.search(qs, 10, ef_search=40))
    hops = idx._last_scan_launches
    print(json.dumps({
        "tool": "hop_read_sweep", "nvidia_smi": smi, "n": n,
        "queries": len(qs), "hop_read_every": kept, "build_s": builds,
        "searches": searches,
        "profile_ef40": {"cuda_kernels": kern, "layer0_hops": hops,
                         "kernels_per_hop": kern / max(hops, 1),
                         "kernel_ms": kern_ms, "wall_ms": wall_ms,
                         "busy_share": kern_ms / wall_ms,
                         "top_kernels_ms": top}}))


if __name__ == "__main__":
    main()
