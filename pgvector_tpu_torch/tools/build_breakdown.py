"""The main path's HNSW build on the build loops' hand kernels and on
their plain versions, in one process on one card.

    python -m pgvector_tpu_torch.tools.build_breakdown [--n 1000000]
        [--routes plain,kernels] [--deletes 10000] [--inserts 5000]

Route ``kernels`` is the package as it is: every SelectNeighbors runs K3
(``ops/select_neighbors.py``, the dense pools in their Gram form) and
every dense beam hop is one K6 launch (``ops/gather_hop.py``, the whole
hop).  Route ``plain`` points ``hnsw_kernels.select_neighbors`` and
``hnsw_kernels.gather_hop`` at their plain versions, eager torch ops.
For each route, on a fresh upload of ``bench.make_data``'s surrogate
(seed 0, the recipe of :func:`.k1_breakdown.clustered`): the build (m
16, ef_construction 64, wave 1,024, build beam 4) with each wave's search
and connect ended by a device sync (``PGVECTOR_TPU_PHASE_SYNC=1``, so
the host timers split the build as the device does: seconds and shares
of the build), its middle wave through torch.profiler (the CUDA kernels
it launches, which do not depend on the machine, their device
milliseconds, the wave's wall milliseconds, the device's idle share and
the busiest kernels) and every other wave timed alone; recall@10 at ef
40 and 100 (query beam 8, K2) against K1's exact top-10; then VACUUM
after ``deletes`` random deletes and INSERT of ``inserts`` new rows near
the deleted ones.  Prints one JSON line a route, each with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from .. import DenseTable, FlatIndex, HNSWIndex, Metric
from ..index import hnsw_kernels as K
from ..ops.gather_hop import gather_hop, gather_hop_plain
from ..ops.select_neighbors import select_neighbors, select_neighbors_plain
from ..utils.telemetry import timers
from .k1_breakdown import clustered, smi_line

#: route -> (the select, the row-gather hop) the build calls
ROUTES = {"kernels": (select_neighbors, gather_hop),
          "plain": (select_neighbors_plain, gather_hop_plain)}


def _profiled(fn, top=6):
    """(CUDA kernel launches, their summed device ms, wall ms, the
    ``top`` busiest kernels as [name, ms, launches]) of one call of
    ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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


def run_route(route, db, qs, gt, args, dev):
    K.select_neighbors, K.gather_hop = ROUTES[route]
    select_neighbors.launches = gather_hop.launches = 0
    n, dim = db.shape
    cap = 1 << (n - 1).bit_length()
    table = DenseTable(dim, capacity=cap, device=dev)
    table.insert(db)
    idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64,
                    wave_size=1024, beam_expand=4, capacity=cap, build=False)
    fn, waves = idx._insert_wave, {"ms": [], "calls": 0}
    middle = max(n // 1024 // 2, 1)

    def wave(elems, lv):
        waves["calls"] += 1
        if waves["calls"] == middle:
            waves["profiled"] = _profiled(lambda: fn(elems, lv))
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(elems, lv)
        torch.cuda.synchronize()
        waves["ms"].append((time.perf_counter() - t0) * 1e3)

    idx._insert_wave = wave
    timers.reset()
    timers.enabled = True
    os.environ["PGVECTOR_TPU_PHASE_SYNC"] = "1"
    try:
        t0 = time.perf_counter()
        idx.build()
        build_s = time.perf_counter() - t0
    finally:
        timers.enabled = False
        os.environ.pop("PGVECTOR_TPU_PHASE_SYNC")
        del idx._insert_wave
    split = timers.report()
    launches = {"select_neighbors": select_neighbors.launches,
                "gather_hop": gather_hop.launches}
    idx.beam_expand = 8  # the query beam, as bench.py
    recall = {}
    for ef in (40, 100):
        idx.search(qs, 10, ef_search=ef)  # warm-up: builds the slab cache
        _, r = idx.search(qs, 10, ef_search=ef)
        recall[ef] = float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                                    for a, b in zip(r, gt)]) / 10)
    idx._drop_packed()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    dele = rng.choice(n, args.deletes, replace=False)
    table.delete(dele)
    idx.beam_expand = 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.vacuum()
    torch.cuda.synchronize()
    vacuum_s = time.perf_counter() - t0
    vecs = db[dele[: args.inserts]] + rng.normal(
        0.0, 0.01, (args.inserts, dim)).astype(np.float32)
    rows = table.insert(vecs)
    t0 = time.perf_counter()
    idx.insert(rows)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    kern, kern_ms, wall_ms, top = waves["profiled"]
    search_s = split["hnsw.wave.search"]["total_s"]
    connect_s = split["hnsw.wave.connect"]["total_s"]
    out = {"route": route, "n": n, "build_s": build_s,
           "search_s": search_s, "connect_s": connect_s,
           "search_share": search_s / build_s,
           "connect_share": connect_s / build_s,
           "wave_ms_mean": float(np.mean(waves["ms"])),
           "wave_ms_max": float(np.max(waves["ms"])), "waves": waves["calls"],
           "profiled_wave": {"wave": middle, "cuda_kernels": kern,
                             "kernel_ms": kern_ms, "wall_ms": wall_ms,
                             "idle_share": 1.0 - kern_ms / wall_ms,
                             "top_kernels_ms": top},
           "recall_at_10": recall, "build_launches": launches,
           "vacuum_s": vacuum_s, "deleted": args.deletes,
           "repaired": idx.last_vacuum["repaired"],
           "insert_rows_per_s": args.inserts / insert_s,
           "launches": {"select_neighbors": select_neighbors.launches,
                        "gather_hop": gather_hop.launches}}
    del idx, table
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=8000)
    ap.add_argument("--routes", default="plain,kernels")
    ap.add_argument("--deletes", type=int, default=10_000)
    ap.add_argument("--inserts", type=int, default=5_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("build_breakdown needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = smi_line()
    db, qs = clustered(args.n, args.queries)
    gt_table = DenseTable(db.shape[1], capacity=args.n, device=dev)
    gt_table.insert(db)
    _, gt = FlatIndex(gt_table, Metric.L2, tile=16384).search(qs, 10)
    del gt_table
    torch.cuda.empty_cache()
    orig = K.select_neighbors, K.gather_hop
    try:
        for route in args.routes.split(","):
            out = run_route(route, db, qs, gt, args, dev)
            print(json.dumps(dict(out, nvidia_smi=smi)), flush=True)
    finally:
        K.select_neighbors, K.gather_hop = orig


if __name__ == "__main__":
    main()
