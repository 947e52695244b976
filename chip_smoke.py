#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--n ROWS]

The path is the one bench.py measures for the JAX package: a 1M × 128 f32
DenseTable of bench.make_data's clustered surrogate (seed 0), the exact
L2 top-10 ground truth through FlatIndex (kernel K1, fused_topk), an HNSW
wave build (m=16, ef_construction=64, wave 1024, build beam 4, heap-TID
dedup on as by default; every SelectNeighbors through kernel K3,
select_neighbors, and every beam hop through K6, gather_hop; its search
and connect split with a device sync ending each, and its middle wave
through torch.profiler), then the layer-0 beam search over the packed
slab cache with query beam 8 at ef 40 and 100 (kernel K2, packed_hop: one
launch a hop), recall@10 and QPS.  Before that it builds the CUDA kernels from
pgvector_tpu_torch/csrc and holds K1 and K2's tail (hop_tail) against
their plain PyTorch versions on the card; after it, K2 itself on hop
states captured from the 1M graph, K3 bit for bit on the selects of a
build wave and on pools of ef_construction 1,000 (C = 1,016, past the
register sort), on the Gram form the build hands it and on the block
that form makes, and K6 (one launch a hop: the E-selection, the list
reads and the merge) on a build wave's beam hops, done flags included.
Every later phase counts K3 and K6 against the selects and dense
row-gather hops it ran.  Last, the IVFFlat lane of bench.py
on the same table (lists = n / 1000, seed 1): the build split into its
phases, recall@10 and QPS at probes 1, 10 and 32, exhaustive probing
against K1's ground truth, the two probe routes against each other,
batch-1 latency, and the inverted probe scan's parts with their bounds.
Then, on the HNSW index of the main path, the live-index phase: filtered
reads (10 % and 1 % of rows) with hnsw.iterative_scan off, relaxed_order
and strict_order against K1's filtered ground truth; UPDATE churn of
5,000 rows (dedup attaches them to their elements), DELETE churn of
5,000 more, VACUUM split into its passes, INSERT of 5,000 new vectors
into the freed slots; plain searches after each change, and the device
programs of that path that have no hand kernel, each with its bound.
Last, the bit and sparse types on tables of their own: the bit kernels
K4 (bit_topk) and K5 (bit_point_scores) against their plain versions at
the 1M sign-bit table's shapes, then binary quantization over the first
200,000 rows (the Hamming graph against K4's exact top-10, BQ with a ×4
re-rank against K1's float top-10) and bit IVFFlat over all 1M, a
Jaccard graph at 200k, BQ on
sign-informative 512-d data (bench.py's lanes), sparse exact inner
product at 1M × 4,096 against the merge join, a sparse inner-product
graph at 24,576 rows, and that phase's device programs without a hand
kernel.  Last, halfvec at GIST-1M's width (phase 9, bench.py's GIST
lane): 200,000 × 960 rows of make_data (seed 7) in a bf16 table, the
exact top-10 through the grouped engine (200 queries against the tiled
scan), an HNSW build, searches at ef 40 and 100 over the bf16 slab that
``auto`` picks and over the int8 slab, K2's int8 slab against its plain
version on hop states of that graph (equal bit for bit for L2 and inner
product), and the ``auto`` pick for 1M × 960 on this card (int8).

Phase 10 runs after phase 7, on the same table through the Relation
that built phase 4's index (``Relation.create_index``): IVFFlat (lists
1,000) and btree indexes, EXPLAIN and the calibrated planner, ``knn``
through the exact scan (K1, equal to its ground truth), HNSW at ef 40
(K2 once a hop) and IVFFlat at probes 10 against phase 7's floors,
EXPLAIN ANALYZE, btree lookups against numpy, the batching executor with
8 clients and a 1,000-row insert amid their reads (each read equal to
the index's search on the state its queue position sees), COPY through
the native codec and a replica rebuilt from a base checkpoint and the
replication log (table, graph and results equal bit for bit), and the
device-memory counts beside ``torch.cuda.memory_allocated``.

Phase 11 runs last, after phase 9, on a fresh upload of phase 1's rows:
the mesh paths on four shards of the card (``make_mesh(4, devices=
[cuda:0] * 4)``): the row-sharded exact search through K1 on every shard
(L2 and inner product, against the single-device ground truth), the
dim-sharded exact search at 1,000 queries (L2, inner product, cosine),
IVFFlat trained over the mesh and the device-sharded IVFFlat (recall at
probes 10), the device-sharded and host fan-out HNSW wrappers over the
first 200,000 rows (recall at ef 40 and 100, per-shard graphs equal bit
for bit, a checkpoint loaded on a 4 × 2 fan-out mesh equal to the 1-D
search), the visited-set and hop-cap knobs on those shards, and the mesh
build of 50,000 rows equal to the single-device build bit for bit;
where there are two cards or more, the sharded exact search over them
too.

Output: one JSON line per phase; a JSON line of the kernels (route,
source, launches on the main path, error against the plain version,
kernel, plain and library times at the main path's shapes, and the
least time the card could take for the same work); the card's name and
power limit, raw as nvidia-smi prints them, on a line of their own
(the smoke's output contract reads that line as well as the device
phase's copy); and last {"ok": true, "device": {...}}.  Any failed check
raises and ends the run with a non-zero exit.  Needs one CUDA device.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import time


#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12


def bound_ms(nbytes, flops=0.0, rate=F32_FLOPS):
    """The least time for the work: (ms, what bounds it) — bytes moved once
    at the memory rate against operations at the type's peak."""
    t_b, t_o = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    """A failed check ends the run (raises, unlike assert, under -O too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def scan_launches(idx):
    """The layer-0 hops the last search of ``idx`` launched (one K2 or K6
    launch each), held against its steps: the beam loop reads its count
    of queries not done every HOP_READ_EVERY hops, so steps <= launches <
    steps + HOP_READ_EVERY."""
    from pgvector_tpu_torch.index.hnsw_kernels import HOP_READ_EVERY

    steps, launched = idx._last_scan_steps, idx._last_scan_launches
    check(steps <= launched < steps + HOP_READ_EVERY,
          f"{launched} layer-0 launches for {steps} steps (a read every "
          f"{HOP_READ_EVERY} hops)")
    return launched


def keep_state(a, kw):
    """A kernel call's arguments, copied (tensors under 2^24 elements:
    the slabs and tables stay shared), without its output buffers."""
    import torch

    def cl(t):
        return t.clone() if torch.is_tensor(t) and t.numel() < 1 << 24 \
            else t
    return [cl(t) for t in a], {n: cl(v) for n, v in kw.items()
                                if n != "out"}


def k2_work(a, kw):
    """What the K2 hop at a captured state (``a``, ``kw``) must move and
    compute: the slabs of the elements it expands (whole, as the kernel
    copies them; ``slabs`` a query each, ``unique_slabs`` the distinct
    elements among them), the candidates it scores, and the least time:
    the pool read and written, the done flags and hop counts, the expanded
    elements' lists, the queries (an int8 slab: the quantized ones, their
    steps and norms, and each candidate's norm) and each distinct slab
    read once."""
    import torch

    from pgvector_tpu_torch.ops.gather_hop import select_expand
    from pgvector_tpu_torch.ops.packed_hop import hop_candidates

    pool_d, pool_p, nbr0, vals, qs, ef, expand = a[:7]
    int8 = a[8] if len(a) > 8 else None
    q, m2, dim = pool_d.shape[0], nbr0.shape[1], vals.shape[2]
    pp, sel, _ = select_expand(pool_d, pool_p, ef, min(expand, ef))
    if kw.get("done") is not None:
        sel = torch.where(kw["done"][:, None], -1, sel)
    live = sel[sel >= 0].long()
    cands = int((hop_candidates(sel, nbr0, pp) >= 0).sum())
    query = (q * dim + 8 * q + 4 * cands if int8 is not None
             else 4 * q * dim)
    unique = int(torch.unique(live).numel())
    slab = m2 * dim * vals.element_size()
    b, by = bound_ms(16 * q * ef + 10 * q + 4 * m2 * unique + query
                     + unique * slab, 2.0 * cands * dim,
                     INT8_OPS if int8 is not None else F32_FLOPS)
    return {"queries": q, "expand": expand, "slabs": live.numel(),
            "unique_slabs": unique, "slab_bytes": live.numel() * slab,
            "scored": cands, "bound_ms": b, "bound_by": by, "live": live}


def same_hop(out1, out0, what, atol=None):
    """Two whole K2 hops agree: the pools apart from ties (distances within
    torch_parity's tolerance, or ``atol`` per entry), the done flags, the
    count of queries not done and the hop counts exactly.  Returns the
    largest distance error."""
    import numpy as np
    import torch

    from torch_parity import assert_same_pool

    d1, p1, done1, left1, hops1 = out1
    d0, p0, done0, left0, hops0 = out0
    torch.cuda.synchronize()
    check(torch.equal(done1, done0) and torch.equal(left1, left0)
          and torch.equal(hops1, hops0),
          f"{what}: done flags, the count not done and hop counts equal")
    d0, p0, d1, p1 = (t.cpu().numpy() for t in (d0, p0, d1, p1))
    if atol is None:
        assert_same_pool(d0, p0, d1, p1)
    else:
        assert_same_pool(d0, p0, d1, p1, atol=atol, rtol=0.0)
    fin = np.isfinite(d0)
    return float(np.abs(d1[fin] - d0[fin]).max()) if fin.any() else 0.0


def cuda_ms(fn, reps=3):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, timed with CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_search(idx, qs, k, ef, top=8):
    """Where one search's time goes: wall seconds, summed kernel seconds
    (torch.profiler's CUDA kernel events) and the busiest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.search(qs, k, ef_search=ef)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernel_s = sum(ms for _, ms, _ in kernels) / 1e3
    kernels.sort(key=lambda x: -x[1])
    launches = sum(c for _, _, c in kernels)
    hops = idx._last_scan_launches
    return {"phase": "profile", "ef": ef, "queries": len(qs),
            "wall_s": wall, "kernel_s": kernel_s,
            "busy_share": kernel_s / wall, "kernel_launches": launches,
            "layer0_launches": hops, "layer0_steps": idx._last_scan_steps,
            "kernels_per_hop": launches / max(hops, 1),
            "top_ms": [[name[:72], ms, c] for name, ms, c in kernels[:top]]}


def profile_call(fn, top=6, reps=1):
    """CUDA kernels one call of ``fn`` launches, their summed device
    milliseconds and the busiest ``top`` by name (torch.profiler's CUDA
    kernel events), averaged over ``reps`` calls in one session.  A
    session that reports no device event at all (seen on the card for
    calls that launch kernels) is run again, at most twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = sorted(((e.key, e.self_device_time_total / 1e3 / reps,
                      e.count / reps)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda x: -x[1])
        if ev:
            break
    return (sum(c for _, _, c in ev), sum(ms for _, ms, _ in ev),
            [[name[:72], ms, c] for name, ms, c in ev[:top]])


def kernel_only_ms(fn, reps=50):
    """Device milliseconds of one launch of the single CUDA kernel a call
    of ``fn`` runs, alone (torch.profiler's kernel events): their summed
    time over their count, so that events the profiler drops (seen on the
    card after many profiled calls) do not count as calls of no time.  A
    profile with no event at all is taken again, at most twice, as in
    profile_call.  Returns (ms or None, events recorded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        count = sum(e.count for e in ev)
        if count:
            return (sum(e.self_device_time_total for e in ev) / 1e3 / count,
                    count)
    return None, 0


def ivf_phase(table, qs, gt_d, gt, k, smi):
    """Phase 6: the IVFFlat lane of bench.py (bench.py:609-640) on the
    main path's table, through IVFFlatIndex's public entry points, then
    its device programs one by one at the lane's shapes."""
    import numpy as np
    import torch

    from torch_parity import ATOL, RTOL, assert_same_topk
    from pgvector_tpu_torch import IVFFlatIndex, Metric
    from pgvector_tpu_torch.index import ivf_kmeans, ivfflat
    from pgvector_tpu_torch.utils.telemetry import timers

    dev = table.device
    nq, d = len(qs), table.dim
    lists = max(min(table.count // 1000, 32768), 32)  # bench.py:619
    # calls of the IVF device programs that have no hand kernel yet
    calls = {"kmeans_assign": 0, "probe_order": 0, "probe_scan": 0}
    wrapped = [(ivf_kmeans, "_assign", "kmeans_assign"),
               (IVFFlatIndex, "_probe_order", "probe_order"),
               (ivfflat, "_workitem_probe_topk", "probe_scan")]
    saved = [getattr(o, n) for o, n, _ in wrapped]

    def counting(fn, key):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    for (o, n, key), fn in zip(wrapped, saved):
        setattr(o, n, counting(fn, key))
    try:
        timers.reset()
        timers.enabled = True
        t0 = time.perf_counter()
        ividx = IVFFlatIndex(table, Metric.L2, lists=lists, seed=1)
        build_s = time.perf_counter() - t0
        timers.enabled = False
        build_calls = dict(calls)
        sweep = []
        for probes in (1, 10, 32):
            ividx.search(qs, k, probes=probes)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist, r = ividx.search(qs, k, probes=probes)
            dt = time.perf_counter() - t0
            check(ividx.last_path == "inverted",
                  f"probes={probes} took the inverted route")
            check(r.shape == (nq, k) and np.isfinite(dist).all(),
                  f"finite IVF results of shape {(nq, k)}, got {r.shape}")
            hits = sum(len(set(a.tolist()) & set(b.tolist()))
                       for a, b in zip(r, gt))
            sweep.append({"probes": probes, "recall_at_10": hits / (nq * k),
                          "qps": nq / dt, "s": dt})
        search_calls = {key: calls[key] - build_calls[key] for key in calls}
    finally:
        for (o, n, _), fn in zip(wrapped, saved):
            setattr(o, n, fn)
    r10 = sweep[1]["recall_at_10"]
    # the floor is the 1M lane's (lists 1,000); smaller tables have fewer
    # lists than the surrogate's 1,024 clusters and lower recall
    check(table.count != 1_000_000 or r10 >= 0.99,
          f"IVF recall@10 {r10} >= 0.99 at probes=10")

    # exhaustive probing is exact: K1's ground truth up to ties
    t0 = time.perf_counter()
    dx, rx = ividx.search(qs[:1000], k, probes=lists)
    exhaustive_s = time.perf_counter() - t0
    assert_same_topk(gt_d[:1000], gt[:1000], dx, rx)
    fin = np.isfinite(dx)
    exhaustive = {"queries": 1000, "probes": lists, "s": exhaustive_s,
                  "path": ividx.last_path,
                  "max_abs_err": float(np.abs(dx[fin] - gt_d[:1000][fin]).max()),
                  "ids_equal_frac": float((rx == gt[:1000]).mean())}

    # the two probe routes agree (tests/test_ivfflat.py:163-188)
    routes = {}
    for cov, path in ((10**9, "inverted"), (0, "blocks")):
        ividx.INVERT_COVERAGE = cov
        routes[path] = ividx.search(qs[:256], k, probes=10)
        check(ividx.last_path == path, f"route {path} forced")
    del ividx.INVERT_COVERAGE
    (d_inv, i_inv), (d_blk, i_blk) = routes["inverted"], routes["blocks"]
    assert_same_topk(d_inv, i_inv, d_blk, i_blk)
    same_sets = float(np.mean([set(a[np.isfinite(x)]) == set(b[np.isfinite(x)])
                               for a, b, x in zip(i_inv, i_blk, d_inv)]))
    check(same_sets == 1.0, f"the routes return the same row sets "
          f"({same_sets} of rows do)")

    # batch-1 latency: one query a search, the block route
    ividx.search(qs[0], k, probes=10)
    lat = []
    for i in range(200):
        t0 = time.perf_counter()
        ividx.search(qs[i], k, probes=10)
        lat.append((time.perf_counter() - t0) * 1e3)
    route1 = "inverted" if 10 * ividx.INVERT_COVERAGE >= lists else "blocks"
    check(ividx.last_path == route1, f"batch-1 took the {route1} route")
    p50, p99 = np.percentile(lat, [50, 99])

    # the inverted probe scan's parts at probes=10, all queries
    qf = ividx._form_queries(qs)
    order_ms = cuda_ms(lambda: ividx._probe_order(qf, 10))
    order = ividx._probe_order(qf, 10)
    sel_np = order.cpu().numpy()
    cs = ividx._post_cs
    t0 = time.perf_counter()
    for _ in range(3):
        qc, wb = ivfflat._adaptive_item_shape(
            sel_np.reshape(-1), ividx._blk_occ, cs, ividx.WORK_QC,
            ividx.WORK_SLOTS)
        work = ivfflat._build_work_items(sel_np, ividx._blk_start,
                                         ividx._blk_occ, qc, wb)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    eq, blkbase, wlen, qmap = (torch.as_tensor(a, device=dev) for a in work)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    ok = (ividx.postings_flat >= 0).view(-1, cs)
    scan_args = (Metric.L2, ividx.post_values, ividx.post_vsq, ok, qf, eq,
                 blkbase, wlen, k, qc, wb, cs)
    scan_ms = cuda_ms(lambda: ivfflat._workitem_scan(*scan_args))
    flat_d, flat_v = ivfflat._workitem_scan(*scan_args)
    regroup_ms = cuda_ms(lambda: ivfflat._regroup_topk(flat_d, flat_v, qmap,
                                                       k))
    valid = table.valid

    def batch():
        ividx._probe_batch_inverted(qf, order, 0, 10, k, valid, None, False)
        torch.cuda.synchronize()

    batch()
    t0 = time.perf_counter()
    batch()
    batch_ms = (time.perf_counter() - t0) * 1e3
    scan_kernels, scan_kernel_ms, scan_top = profile_call(
        lambda: ivfflat._workitem_probe_topk(*scan_args[:8], qmap, k=k, Qc=qc,
                                             Wb=wb, cs=cs))
    # bound: each real (query → list) edge scores the list's live rows;
    # each probed list's slab (values and |v|²) is read once
    lens = ividx.list_lens
    edges = sel_np.reshape(-1)
    probed = np.unique(edges)
    scan_flops = 2.0 * float(lens[edges].sum()) * d
    scan_bytes = (float(lens[probed].sum()) * (d * 4 + 4) + nq * d * 4
                  + nq * k * 8)
    scan_bound, scan_by = bound_ms(scan_bytes, scan_flops)
    order_bound, order_by = bound_ms(4 * (nq * d + lists * d) + 8 * nq * 10,
                                     2.0 * nq * lists * d)
    order_kernels, _, _ = profile_call(lambda: ividx._probe_order(qf, 10))
    # k-means assign at the sample's shape (50 · lists rows, bench.py's
    # lane samples max(50 · lists, 10,000))
    ns = min(max(50 * lists, 10000), table.count)
    xs = table.data[:ns].float()
    assign_ms = cuda_ms(lambda: ivf_kmeans._assign(xs, ividx.centroids, False))
    assign_bound, assign_by = bound_ms(4 * (ns * d + lists * d) + 8 * ns,
                                       2.0 * ns * lists * d)
    assign_kernels, _, _ = profile_call(
        lambda: ivf_kmeans._assign(xs, ividx.centroids, False))
    emit({"phase": "ivf", "nvidia_smi": smi, "n": table.count,
          "lists": lists, "seed": 1, "queries": nq, "build_s": build_s,
          "build_phases": {key.split(".")[1]: v["total_s"]
                           for key, v in timers.report().items()
                           if key.startswith("ivfflat.")},
          "kmeans_iters": ividx.kmeans_iters, "samples": ns,
          "list_len_min_max": [int(lens.min()), int(lens.max())],
          "post_values_bytes": ividx.post_values.numel()
          * ividx.post_values.element_size(),
          "sweep": sweep, "exhaustive": exhaustive,
          "routes": {"queries": 256, "probes": 10, "atol": ATOL, "rtol": RTOL,
                     "same_sets_frac": same_sets},
          "batch1_ms": {"probes": 10, "searches": 200, "p50": p50,
                        "p99": p99},
          "probe_scan": {"probes": 10, "Qc": qc, "Wb": wb,
                         "work_items": int((work[1] >= 0).sum()),
                         "work_rows_padded": len(work[1]),
                         "probe_order_ms": order_ms,
                         "work_items_host_ms": host_ms,
                         "upload_ms": upload_ms, "scan_ms": scan_ms,
                         "regroup_ms": regroup_ms,
                         "whole_batch_ms": batch_ms,
                         "cuda_kernels": scan_kernels,
                         "kernel_ms": scan_kernel_ms,
                         "top_kernels_ms": scan_top,
                         "gflop": scan_flops / 1e9,
                         "gbytes": scan_bytes / 1e9,
                         "bound_ms": scan_bound, "bound_by": scan_by},
          "programs": [
              {"name": "probe scan (_workitem_probe_topk)",
               "ms": scan_ms + regroup_ms, "cuda_kernels": scan_kernels,
               "calls_build": build_calls["probe_scan"],
               "calls_searches": search_calls["probe_scan"],
               "bound_ms": scan_bound, "bound_by": scan_by},
              {"name": "probe order (_probe_order)", "ms": order_ms,
               "cuda_kernels": order_kernels,
               "calls_build": build_calls["probe_order"],
               "calls_searches": search_calls["probe_order"],
               "bound_ms": order_bound, "bound_by": order_by},
              {"name": "k-means assign (ivf_kmeans._assign)",
               "ms": assign_ms, "cuda_kernels": assign_kernels,
               "calls_build": build_calls["kmeans_assign"],
               "calls_searches": search_calls["kmeans_assign"],
               "bound_ms": assign_bound, "bound_by": assign_by}]})


def live_phase(idx, table, qs, k, recall4, smi, churn=5_000):
    """Phase 7: phase 4's index as a live index, as pgvector users drive
    one — filtered reads with and without iterative scans, UPDATE churn
    (delete + insert of the same vectors, which heap-TID dedup attaches to
    the existing elements), DELETE churn, VACUUM, INSERT into the freed
    slots, and plain searches after each change against K1's ground truth
    over the live rows.  Then the device programs with no hand kernel that
    this path runs, one by one at its shapes."""
    import numpy as np
    import torch

    from pgvector_tpu_torch import FlatIndex, Metric, config
    from pgvector_tpu_torch.index import hnsw as hnsw_mod
    from pgvector_tpu_torch.index import hnsw_kernels as K
    from pgvector_tpu_torch.ops.fused_topk import fused_topk
    from pgvector_tpu_torch.ops.hop_tail import hop_tail
    from pgvector_tpu_torch.ops.packed_hop import packed_hop
    from pgvector_tpu_torch.utils.telemetry import timers

    dev = table.device
    nq, d, m2 = len(qs), table.dim, 2 * idx.m
    rng = np.random.default_rng(7)
    flat = FlatIndex(table, Metric.L2, tile=16384)
    query_beam, build_beam = idx.beam_expand, 4
    fused_topk.launches = packed_hop.launches = hop_tail.launches = 0
    plain_hops = 0  # layer-0 hops every plain search launched: one K2 each

    def plain(q, ef, fmask=None, kk=k):
        nonlocal plain_hops
        out = idx.search(q, kk, ef_search=ef, filter_mask=fmask)
        plain_hops += scan_launches(idx)
        return out

    def recall_of(r, gt):
        hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
                   for a, b in zip(r, gt))
        return hits / max(int((gt >= 0).sum()), 1)

    def live_rows():
        return table.valid[: table.count].cpu().numpy()

    sweeps = {}

    def plain_sweep(step):
        """ef 40 and 100 against K1's ground truth over the live rows."""
        _, gt = flat.search(qs, k)
        valid = live_rows()
        out = []
        for ef in (40, 100):
            plain(qs, ef)  # warm-up: rebuilds the slab cache
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist, r = plain(qs, ef)
            dt = time.perf_counter() - t0
            check(r.shape == (nq, k) and np.isfinite(dist).all(),
                  f"{step}: finite results of shape {(nq, k)}")
            check(valid[r[r >= 0]].all(), f"{step}: no dead row returned")
            rec = recall_of(r, gt)
            out.append({"ef": ef, "recall_at_10": rec, "qps": nq / dt,
                        "layer0_hops": idx._last_scan_steps})
            check(rec >= recall4[ef] - 0.02,
                  f"{step}: recall@10 {rec} within 0.02 of phase 4's "
                  f"{recall4[ef]} at ef={ef}")
        sweeps[step] = out

    # ---- 7.1 filtered reads, iterative scans off / relaxed / strict ------
    it = {"steps": 0, "layers": 0}
    hop_args = {}
    orig_sl, orig_hop = K.search_layer, K._hop_body

    def counting_search_layer(*a, **kw):
        out = orig_sl(*a, **kw)
        if kw.get("disc") is not None:
            it["steps"] += out[4]
            it["layers"] += 1
        return out

    def capturing_hop(*a, **kw):
        it["hop_calls"] = it.get("hop_calls", 0) + 1
        if it["hop_calls"] == 4 and kw.get("disc") is not None:
            def cl(t):
                return t.clone() if torch.is_tensor(t) else t
            hop_args["a"] = [cl(t) for t in a]
            hop_args["kw"] = {n: (tuple(cl(t) for t in v)
                                  if isinstance(v, tuple) else cl(v))
                              for n, v in kw.items()}
        return orig_hop(*a, **kw)

    cap_rows = table.data.shape[0]
    masks = {"10%": rng.integers(0, 10, cap_rows) == 0,
             "1%": rng.integers(0, 100, cap_rows) == 0}
    filtered = []
    for share, fm in masks.items():
        gt_d, gt = flat.search(qs, k, filter_mask=fm)
        check((gt >= 0).all(), f"{share}: K1 found k matching rows")
        per_mode = {}
        for mode in ("off", "relaxed_order", "strict_order"):
            with config.local(**{"hnsw.iterative_scan": mode}):
                search = (lambda q: plain(q, 40, fm)) if mode == "off" \
                    else (lambda q: idx.search(q, k, ef_search=40,
                                               filter_mask=fm))
                search(qs[:256])  # warm-up
                it.update(steps=0, layers=0, hop_calls=0)
                K.search_layer = counting_search_layer
                if mode == "relaxed_order" and share == "1%":
                    K._hop_body = capturing_hop
                searches0 = idx.stats.searches
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dist, r = search(qs)
                    dt = time.perf_counter() - t0
                finally:
                    K.search_layer, K._hop_body = orig_sl, orig_hop
            found = (r >= 0).sum(axis=1)
            check(fm[r[r >= 0]].all(), f"{share} {mode}: every row passes "
                  "the filter")
            if mode == "strict_order":
                fin = np.where(np.isfinite(dist), dist, np.finfo(np.float32).max)
                check((np.diff(fin, axis=1) >= 0).all(),
                      f"{share} strict_order output is sorted")
            row = {"filter": share, "mode": mode, "ef": 40,
                   "recall_at_10": recall_of(r, gt), "qps": nq / dt, "s": dt,
                   "mean_results": float(found.mean()),
                   "share_with_k": float((found == k).mean())}
            if mode != "off":
                rounds = idx._last_scan_rounds
                row.update({
                    "rounds": rounds,
                    "searches_per_query":
                        (idx.stats.searches - searches0) / nq,
                    "mean_scored": float(idx._last_scan_scanned.mean()),
                    "hops": it["steps"],
                    "hops_per_round": it["steps"] / max(it["layers"], 1),
                    "ms_per_hop": dt * 1e3 / max(it["steps"], 1)})
            per_mode[mode] = (r, row)
            filtered.append(row)
        r_off, r_rel = per_mode["off"][0], per_mode["relaxed_order"][0]
        check(((r_rel >= 0).sum(1) >= (r_off >= 0).sum(1)).all(),
              f"{share}: relaxed_order never returns fewer rows than off")
        check(per_mode["relaxed_order"][1]["recall_at_10"]
              >= per_mode["off"][1]["recall_at_10"],
              f"{share}: relaxed_order recall is not below off's")

    # the iterative hop replayed on its captured state (hop 4 of the 1 %
    # relaxed scan's first round): the visited table fills as it repeats,
    # but every replay runs the same ops at the same shapes
    check("a" in hop_args, "captured an iterative hop")
    ha, hkw = hop_args["a"], hop_args["kw"]
    probe_in = {}
    orig_probe = K.visited_probe

    def capturing_probe(table_, elems, mode="hash2"):
        probe_in.setdefault("elems", elems.clone())
        return orig_probe(table_, elems, mode)

    K.visited_probe = capturing_probe
    try:
        first = orig_hop(*ha, **hkw)
    finally:
        K.visited_probe = orig_probe
    scored = int(first[-1].sum())
    hop_ms = cuda_ms(lambda: orig_hop(*ha, **hkw))
    hop_kernels, hop_kernel_ms, hop_top = profile_call(
        lambda: orig_hop(*ha, **hkw))
    pool_d = ha[3]
    ef_h, dk = pool_d.shape[1], hkw["disc"][0].shape[1]
    r_c = probe_in["elems"].shape[1]
    hop_bound, hop_by = bound_ms(
        nq * r_c * 4 + scored * (d * 4 + 8) + nq * r_c * 8
        + 2 * nq * (ef_h * 9 + dk * 8) + nq * d * 4, 2.0 * d * scored)
    visited = hkw["visited"]
    probe_ms = cuda_ms(lambda: orig_probe(visited, probe_in["elems"]))
    probe_kernels, _, _ = profile_call(
        lambda: orig_probe(visited, probe_in["elems"]))
    probe_bound, probe_by = bound_ms(nq * r_c * 12 + scored * 4)
    iter_hops = sum(f.get("hops", 0) for f in filtered)
    emit({"phase": "hnsw_live_filtered", "n": table.count, "queries": nq,
          "filtered": filtered})

    # ---- 7.2 UPDATE churn: delete rows, insert the same vectors again ----
    valid = live_rows()
    pick = rng.choice(np.flatnonzero(valid), 2 * churn, replace=False)
    upd, dele = pick[:churn], pick[churn:]
    upd_elems = np.array([idx.row_to_elem[int(r)] for r in upd])
    vecs_upd = table.data[torch.as_tensor(upd, device=dev)].cpu().numpy()
    live0 = idx.live_elements
    table.delete(upd)
    new_rows = table.insert(vecs_upd)
    idx.beam_expand = build_beam
    t0 = time.perf_counter()
    idx.insert(new_rows)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    idx.beam_expand = query_beam
    check(idx.live_elements == live0, "UPDATE churn leaves live_elements "
          f"unchanged ({idx.live_elements} against {live0})")
    check(all(idx.row_to_elem[int(r)] == e
              for r, e in zip(new_rows, upd_elems)),
          "each new row attached to its vector's element")
    # each updated vector's k=1 search: never its dead row; where it finds
    # the vector's element (an approximate search misses a few), the new
    # row is what that element returns
    _, r1 = plain(vecs_upd, 100, kk=1)
    check(not np.isin(r1[:, 0], upd).any(), "no k=1 search returns a "
          "dead row of an updated vector")
    new_hit = float((r1[:, 0] == new_rows).mean())
    check(new_hit >= 0.95, f"k=1 finds the new row ({new_hit})")
    plain_sweep("after_update")

    # ---- 7.3 DELETE churn, 7.4 VACUUM -----------------------------------
    dele_elems = np.array([idx.row_to_elem[int(r)] for r in dele])
    table.delete(dele)
    waves = {"repair": 0, "insert": 0}
    wave_ms = {"repair": [], "insert": []}  # the waves not profiled
    wave_prof = {}

    def profiled(name, fn):
        """The first wave through torch.profiler; the others timed alone
        (synchronized on both sides)."""
        def call(*a, **kw):
            waves[name] += 1
            if waves[name] > 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*a, **kw)
                torch.cuda.synchronize()
                wave_ms[name].append((time.perf_counter() - t0) * 1e3)
                return
            cands = [0]

            def sl(*sa, **skw):  # candidates the wave's beams could score
                out = orig_sl(*sa, **skw)
                cands[0] += out[2] * sa[2].shape[0] * skw.get("expand", 1) * m2
                return out
            K.search_layer = sl
            try:
                kern, kern_ms, top = profile_call(lambda: fn(*a, **kw))
            finally:
                K.search_layer = orig_sl
            wave_prof[name] = {"elements": len(a[0]), "kernels": kern,
                               "kernel_ms": kern_ms, "top_ms": top,
                               "candidates": cands[0]}
        return call

    idx._insert_wave_repair = profiled("repair", idx._insert_wave_repair)
    idx.beam_expand = build_beam
    timers.reset()
    timers.enabled = True
    try:
        t0 = time.perf_counter()
        idx.vacuum()
        torch.cuda.synchronize()
        vacuum_s = time.perf_counter() - t0
    finally:
        timers.enabled = False
        del idx._insert_wave_repair
        idx.beam_expand = query_beam
    vac_phases = {key: v["total_s"] for key, v in timers.report().items()}
    freed = np.asarray(idx.free_slots)
    check(len(freed) == churn and set(freed.tolist())
          == set(dele_elems.tolist()), f"vacuum freed exactly the {churn} "
          f"deleted elements ({len(freed)})")
    er = idx.elem_rows[upd_elems]
    check((idx.levels[upd_elems] >= 0).all()
          and ((er >= 0).sum(1) == 1).all()
          and (er[:, 0] == new_rows).all(),
          "the updated elements survive with their one live TID")
    dead_dev = torch.zeros(idx.cap_e, dtype=torch.bool, device=dev)
    dead_dev[torch.as_tensor(freed, device=dev)] = True
    for nb in (idx.nbr0, idx.nbr_up):
        check(not bool((dead_dev[nb.clamp(min=0).long()] & (nb >= 0)).any()),
              "no neighbor list holds a freed id")
    def strip():  # both strips of the vacuum, no-ops on the repaired graph
        hnsw_mod._strip_dead(idx.nbr0, idx.kept0, dead_dev)
        hnsw_mod._strip_dead(idx.nbr_up, idx.kept_up, dead_dev)

    strip_ms = cuda_ms(strip)
    strip_kernels, _, _ = profile_call(strip)
    strip_bound, strip_by = bound_ms(
        (idx.nbr0.numel() + idx.nbr_up.numel()) * 11)
    plain_sweep("after_vacuum")

    # ---- 7.5 INSERT new vectors into the freed slots ---------------------
    noise = rng.normal(0.0, 0.01, (churn, d)).astype(np.float32)
    vecs_new = table.data[torch.as_tensor(dele, device=dev)].cpu().numpy() \
        + noise
    ins_rows = table.insert(vecs_new)
    # one wave's worth through the profiler, then the rest timed
    first = min(idx.wave_size, churn // 2)
    idx._insert_wave = profiled("insert", idx._insert_wave)
    idx.beam_expand = build_beam
    try:
        idx.insert(ins_rows[:first])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.insert(ins_rows[first:])
        torch.cuda.synchronize()
        insert_s = time.perf_counter() - t0
    finally:
        del idx._insert_wave
        idx.beam_expand = query_beam
    check(sorted(idx.row_to_elem[int(r)] for r in ins_rows)
          == sorted(freed.tolist()), "the inserts filled the freed slots")
    check(idx.live_elements == live0, "live_elements back to "
          f"{live0} ({idx.live_elements})")
    plain_sweep("after_insert")

    launches = {"fused_topk": fused_topk.launches,
                "packed_hop": packed_hop.launches,
                "hop_tail": hop_tail.launches}
    check(launches["fused_topk"] > 0, "the ground truths went through K1")
    check(launches["packed_hop"] == plain_hops,
          f"every plain layer-0 hop went through K2: "
          f"{launches['packed_hop']} launches for {plain_hops} hops")

    def wave_row(name):
        """A wave of 1,024 elements: ms the mean of the waves timed alone;
        kernels and the bound from the profiled first wave, the bound
        counting every expanded node's 2m neighbours scored once and the
        select's pairwise block."""
        p = wave_prof[name]
        b = p["elements"]
        c = idx.ef_construction + min(idx.m, b)
        w_bound, w_by = bound_ms(p["candidates"] * d * 4 + b * c * d * 4,
                                 2.0 * d * (p["candidates"] + b * c * c))
        return {"name": f"{name} wave", "ms": float(np.mean(wave_ms[name])),
                "ms_max": float(np.max(wave_ms[name])),
                "cuda_kernels": p["kernels"],
                "kernel_ms_first": p["kernel_ms"], "calls": waves[name],
                "elements_first": b, "bound_ms": w_bound, "bound_by": w_by,
                "top_kernels_ms": p["top_ms"]}

    emit({"phase": "hnsw_live", "nvidia_smi": smi, "n": table.count,
          "queries": nq, "churn": churn, "filtered": filtered,
          "update": {"rows": churn, "s": update_s,
                     "live_elements": idx.live_elements,
                     "k1_new_row_share": new_hit},
          "vacuum": {"s": vacuum_s, "phases": vac_phases,
                     "deleted": idx.last_vacuum["deleted"],
                     "repaired": idx.last_vacuum["repaired"],
                     "repaired_share":
                         idx.last_vacuum["repaired"] / live0},
          "insert": {"rows": churn, "profiled_rows": first,
                     "timed_rows": churn - first, "s": insert_s,
                     "rows_per_s": (churn - first) / insert_s},
          "sweeps": sweeps, "launches": launches, "plain_hops": plain_hops,
          "iterative_hops": iter_hops,
          "programs": [
              {"name": "iterative hop (_hop_body, row gathers, hash2)",
               "ms": hop_ms, "cuda_kernels": hop_kernels,
               "kernel_ms": hop_kernel_ms, "calls": iter_hops,
               "scored": scored, "candidates": nq * r_c,
               "bound_ms": hop_bound, "bound_by": hop_by,
               "top_kernels_ms": hop_top},
              {"name": "visited probe (visited_probe, hash2)",
               "ms": probe_ms, "cuda_kernels": probe_kernels,
               "calls": iter_hops, "bound_ms": probe_bound,
               "bound_by": probe_by},
              {"name": "vacuum strip (_strip_dead, both levels)",
               "ms": strip_ms, "cuda_kernels": strip_kernels, "calls": 2,
               "bound_ms": strip_bound, "bound_by": strip_by},
              wave_row("repair"), wave_row("insert")]})
    return launches


def bit_sparse_phase(db, qs, k, smi, n, dev):
    """Phase 8: the bit and sparse types on their own tables.  K4 and K5
    against their plain versions (equal ids, bitwise-equal distances) at
    the 1M sign-bit table's shapes; then, with every count at 0, the main
    path of this slice: binary quantization over the first 200,000 rows
    (bench.py's BENCH_BIT_N: the Hamming graph, BQ + re-rank against K1's
    float ground truth; a 1M graph took the smoke past its time limit),
    bit IVFFlat over all n sign bits, a Jaccard graph over the same 200k
    sign bits, BQ on sign-informative data (200k × 512), sparse exact
    inner product at 1M × 4,096 (the densified-tile route through K1)
    against the merge join, and a sparse inner-product graph at 24,576
    rows; last, the device programs of this phase that have no hand
    kernel.  ``n`` rows stand for the 1M parts; the other sets keep their
    own sizes.  Returns the kernel rows of K4 and K5."""
    import numpy as np
    import torch

    from pgvector_tpu_torch import (BinaryQuantizedIndex, BitTable,
                                    DenseTable, FlatIndex, HNSWIndex,
                                    IVFFlatIndex, Metric, SparseTable,
                                    SparseVec, config)
    from pgvector_tpu_torch.index import hnsw_kernels as K
    from pgvector_tpu_torch.ops import distance as D
    from pgvector_tpu_torch.ops.bit_scan import (
        bit_point_scores, bit_point_scores_plain, bit_topk, bit_topk_plain)
    from pgvector_tpu_torch.ops.fused_topk import fused_topk, k1_error_bound
    from pgvector_tpu_torch.utils.telemetry import timers
    from torch_parity import assert_same_topk

    nq = len(qs)
    secs = {}
    t_phase = time.perf_counter()

    def recall_of(r, gt):
        return sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(r, gt)) / gt.size

    def searched(index, q, ef, **kw):
        """(distances, ids, qps) of one timed search after a warm-up."""
        index.search(q, k, ef_search=ef, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_, r_ = index.search(q, k, ef_search=ef, **kw)
        return d_, r_, len(r_) / (time.perf_counter() - t0)

    # ---- 8.1 K4 and K5 against their plain versions ----------------------
    t0 = time.perf_counter()
    qbits = qs > 0
    words = D.pack_bits(torch.as_tensor(db, device=dev) > 0)  # (n, 4)
    qw = D.pack_bits(torch.as_tensor(qbits, device=dev))
    pop = D.popcount_rows(words)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(8)
    filt = torch.as_tensor(rng.integers(0, 10, n) == 0, device=dev)
    k4 = []
    for metric in ("HAMMING", "JACCARD"):
        for kk in (10, 64):
            for fname, valid in (("none", ones), ("10%", filt)):
                m_ = Metric[metric]
                d1, i1 = bit_topk(m_, qw, words, kk, valid, pop)
                d0, i0 = bit_topk_plain(m_, qw, words, kk, valid, pop)
                torch.cuda.synchronize()
                check(torch.equal(i1, i0) and torch.equal(d1, d0),
                      f"K4 equals its plain version: {metric} k={kk} "
                      f"filter {fname}")
                k4.append({"metric": metric, "k": kk, "filter": fname,
                           "equal": True,
                           "max_abs_err": float((d1 - d0)[torch.isfinite(
                               d0)].abs().max())})
    k4_ms = cuda_ms(lambda: bit_topk(Metric.HAMMING, qw, words, k, ones))
    k4_jaccard_ms = cuda_ms(
        lambda: bit_topk(Metric.JACCARD, qw, words, k, ones))
    k4_plain_ms = cuda_ms(
        lambda: bit_topk_plain(Metric.HAMMING, qw, words, k, ones), reps=1)
    w = words.shape[1]
    k4_bound, k4_by = bound_ms(4 * (n * w + nq * w) + 8 * nq * k + n,
                               2.0 * nq * n * 32 * w, INT8_OPS)
    # the library yardstick: the int8 product of unpacked bits alone, at
    # 1,000 queries (as K1's beside torch.mm); the port never calls it
    lib_note = None
    try:
        a8 = torch.as_tensor(qbits[:1000], device=dev).to(torch.int8)
        b8 = torch.as_tensor(db > 0, device=dev).to(torch.int8)
        k4_lib_ms = cuda_ms(lambda: torch._int_mm(a8, b8.t()))
        k4_ms_1000 = cuda_ms(lambda: bit_topk(Metric.HAMMING, qw[:1000],
                                              words, k, ones))
        del a8, b8
    except (RuntimeError, TypeError) as e:
        k4_lib_ms, k4_ms_1000, lib_note = None, None, str(e)[:200]
    # K5 on hop-shaped blocks: 8,000 queries × 256 rows × 4 words
    rows = torch.as_tensor(rng.integers(0, n, (nq, 256)), dtype=torch.int32,
                           device=dev)
    rows[:, ::17] = -1
    k5 = []
    for metric in ("HAMMING", "JACCARD"):
        s1 = bit_point_scores(Metric[metric], qw, words, rows)
        s0 = bit_point_scores_plain(Metric[metric], qw, words, rows)
        torch.cuda.synchronize()
        check(torch.equal(s1, s0), f"K5 equals its plain version on hop "
              f"blocks: {metric}")
        k5.append({"shape": "hop", "metric": metric, "equal": True,
                   "max_abs_err": float((s1 - s0)[torch.isfinite(s0)]
                                        .abs().max())})
    # K5's time two ways: CUDA events around back-to-back wrapper calls
    # (the host's pace when it exceeds the kernel's), and the kernel alone
    # (torch.profiler's CUDA kernel events)
    k5_ms = cuda_ms(lambda: bit_point_scores(Metric.HAMMING, qw, words, rows))
    k5_kernel_ms, k5_events = kernel_only_ms(
        lambda: bit_point_scores(Metric.HAMMING, qw, words, rows))
    k5_plain_ms = cuda_ms(
        lambda: bit_point_scores_plain(Metric.HAMMING, qw, words, rows))
    live = int((rows >= 0).sum())
    k5_bound, k5_by = bound_ms(live * w * 4 + rows.numel() * 8 + nq * w * 4,
                               2.0 * live * 128, INT8_OPS)
    k5[0].update(ms=k5_ms, kernel_ms=k5_kernel_ms,
                 kernel_events=k5_events, bound_ms=k5_bound, bound_by=k5_by)
    secs["kernels_vs_plain"] = time.perf_counter() - t0
    del qw, pop, rows

    # ---- 8.2 binary quantization over the first 200,000 rows -------------
    # the counts go to 0 here: what follows is this phase's main path
    fused_topk.launches = bit_topk.launches = bit_point_scores.launches = 0
    t0 = time.perf_counter()
    nb = min(200_000, n)
    table = DenseTable(db.shape[1], capacity=nb, device=dev)
    table.insert(db[:nb])
    _, gt_f = FlatIndex(table, Metric.L2, tile=16384).search(qs, k)
    secs["bq_float_gt"] = time.perf_counter() - t0
    pair_in = {}
    orig_pair, orig_sl = K._pairwise_dists, K.search_layer

    def capture_pair(kind, metric, values, elems, sdim=0):
        if kind == "bit" and elems.shape[0] >= 512 and "elems" not in pair_in:
            pair_in.update(elems=elems.clone(), metric=metric)
        return orig_pair(kind, metric, values, elems, sdim)

    bq = BinaryQuantizedIndex(table, Metric.L2, m=16, ef_construction=64,
                              rerank_factor=4, wave_size=1024, beam_expand=4,
                              build=False)
    bit_wave = _profiled_waves(bq.index, orig_sl)
    K._pairwise_dists = capture_pair
    timers.reset()
    timers.enabled = True
    try:
        t0 = time.perf_counter()
        bq.index.build()
        bq_build_s = time.perf_counter() - t0
    finally:
        timers.enabled = False
        K._pairwise_dists = orig_pair
        del bq.index._insert_wave
    bq_phases = {key: v["total_s"] for key, v in timers.report().items()}
    braw = bq.index
    braw.beam_expand = 8  # query beam, as bench.py
    _, gt_h = FlatIndex(bq.shadow, Metric.HAMMING).search(qbits, k)
    dist, r, raw_qps = searched(braw, qbits, 40)
    check(r.shape == (nq, k) and np.isfinite(dist).all(),
          "finite raw Hamming results")
    raw_rec = recall_of(r, gt_h)
    d_bq, r_bq, bq_qps = searched(bq, qs, 100)
    check(np.isfinite(d_bq).all(), "finite BQ + re-rank results")
    bq_rec = recall_of(r_bq, gt_f)
    # floors 0.03-0.05 under the 200k graph's seeded results (PERF.md §2);
    # the 1M graph's (0.82 / 0.22) belong to the benchmark's 1M lane
    check(nb != 200_000 or raw_rec >= 0.88, f"raw Hamming recall@10 "
          f"{raw_rec} >= 0.88 at ef 40 on the 200k graph (seeded 0.916425)")
    check(nb != 200_000 or bq_rec >= 0.48, f"BQ ×4 recall@10 {bq_rec} >= "
          "0.48 at ef 100 on the 200k graph (reference ~0.51 at 200k, "
          "BASELINE.md:70)")
    # K5 on the pairwise block of one build wave (level-0 select)
    check("elems" in pair_in, "captured a build wave's pairwise block")
    el = pair_in["elems"]
    t_, c_ = el.shape
    pq = bq.shadow.data[el.clamp(min=0).reshape(-1).long()]
    prow = el[:, None, :].expand(t_, c_, c_).reshape(t_ * c_, c_).contiguous()
    k5_count = bit_point_scores.launches  # the check's launches don't count

    def pair_scores():
        return bit_point_scores(Metric.HAMMING, pq, bq.shadow.data, prow)

    s1 = pair_scores()
    s0 = bit_point_scores_plain(Metric.HAMMING, pq, bq.shadow.data, prow)
    torch.cuda.synchronize()
    check(torch.equal(s1, s0), "K5 equals its plain version on a build "
          "wave's pairwise block")
    p_live = int((prow >= 0).sum())
    p_bound, p_by = bound_ms(p_live * w * 4 + prow.numel() * 8
                             + pq.numel() * 4, 2.0 * p_live * 128, INT8_OPS)
    p_kernel_ms, p_events = kernel_only_ms(pair_scores)
    k5.append({"shape": f"pairwise {t_}x{c_}x{c_}", "metric": "HAMMING",
               "equal": True, "max_abs_err": 0.0, "ms": cuda_ms(pair_scores),
               "kernel_ms": p_kernel_ms, "kernel_events": p_events,
               "bound_ms": p_bound, "bound_by": p_by})
    bit_point_scores.launches = k5_count
    # bit IVFFlat over all n sign bits
    bits = BitTable(db.shape[1], capacity=n, device=dev)
    bits.insert_words(words)
    del words
    _, gt_hn = FlatIndex(bits, Metric.HAMMING).search(qbits, k)
    t0 = time.perf_counter()
    ivf = IVFFlatIndex(bits, Metric.HAMMING, lists=1000, seed=1)
    ivf_build_s = time.perf_counter() - t0
    ivf_rows = []
    for probes in (1, 10):
        ivf.search(qbits, k, probes=probes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_i, r_i = ivf.search(qbits, k, probes=probes)
        ivf_rows.append({"probes": probes,
                         "recall_at_10": recall_of(r_i, gt_hn),
                         "qps": nq / (time.perf_counter() - t0)})
    ex = 200
    d_ex, r_ex = ivf.search(qbits[:ex], k, probes=1000)
    gd_h, gi_h = FlatIndex(bits, Metric.HAMMING).search(qbits[:ex], k)
    assert_same_topk(gd_h, gi_h, d_ex, r_ex, atol=0.0, rtol=0.0)
    del ivf, bits
    emit({"phase": "bit_bq", "nvidia_smi": smi, "n": nb, "queries": nq,
          "build_s": bq_build_s, "build_phases": bq_phases,
          "raw_hamming": {"ef": 40, "recall_at_10": raw_rec, "qps": raw_qps,
                          "layer0_hops": braw._last_scan_steps,
                          "floor_200k": 0.88, "reference_1m": 0.8661},
          "bq_rerank": {"ef": 100, "rerank_factor": 4,
                        "recall_at_10_vs_float_gt": bq_rec, "qps": bq_qps,
                        "floor_200k": 0.48, "reference_200k": 0.51,
                        "reference_1m": 0.2468},
          "ivf": {"n": n, "lists": 1000, "build_s": ivf_build_s,
                  "sweep": ivf_rows, "exhaustive_equals_k4": True,
                  "exhaustive_queries": ex}})
    # ---- 8.3 Jaccard: its own graph over the same 200k sign bits ---------
    t0 = time.perf_counter()
    jt = bq.shadow
    _, gt_j = FlatIndex(jt, Metric.JACCARD).search(qbits, k)
    jidx = HNSWIndex(jt, Metric.JACCARD, m=16, ef_construction=64,
                     wave_size=1024, dedup=False, beam_expand=4)
    j_build = time.perf_counter() - t0
    jidx.beam_expand = 8
    _, r_j, j_qps = searched(jidx, qbits, 40)
    j_rec = recall_of(r_j, gt_j)
    check(j_rec >= 0.94, f"Jaccard recall@10 {j_rec} >= 0.94 at ef 40 "
          "(reference 0.9736)")
    del jidx, jt, bq, braw, table
    torch.cuda.empty_cache()

    # ---- 8.4 BQ on sign-informative data (bench.py:768-811) --------------
    t0 = time.perf_counter()
    sg_n, sdim_bq = 200_000, 512
    sncl = sg_n // 25
    rng_bq = np.random.default_rng(9)
    s_centers = rng_bq.normal(size=(sncl, sdim_bq)).astype(np.float32) * 1.5
    sdb = np.empty((sg_n, sdim_bq), np.float32)
    for s in range(0, sg_n, 100_000):
        e = min(s + 100_000, sg_n)
        sdb[s:e] = (s_centers[rng_bq.integers(0, sncl, e - s)]
                    + rng_bq.normal(size=(e - s, sdim_bq)).astype(np.float32))
    sqs = (s_centers[rng_bq.integers(0, sncl, nq)]
           + rng_bq.normal(size=(nq, sdim_bq)).astype(np.float32))
    stab = DenseTable(sdim_bq, capacity=sg_n, device=dev)
    stab.insert(sdb)
    _, sg_gt = FlatIndex(stab, Metric.L2, tile=16384).search(sqs, k)
    sbq = BinaryQuantizedIndex(stab, Metric.L2, m=16, ef_construction=64,
                               rerank_factor=4, wave_size=1024, beam_expand=4)
    sg_build = time.perf_counter() - t0
    sbq.index.beam_expand = 8
    _, r_s, sg_qps = searched(sbq, sqs, 100)
    sg_rec = recall_of(r_s, sg_gt)
    check(sg_rec >= 0.97, f"sign-informative BQ recall@10 {sg_rec} >= 0.97 "
          "(reference 0.9903)")
    del sbq, stab, sdb
    torch.cuda.empty_cache()
    emit({"phase": "bit_jaccard_signful", "nvidia_smi": smi,
          "jaccard": {"n": nb, "ef": 40, "recall_at_10": j_rec, "qps": j_qps,
                      "seconds": j_build, "reference": 0.9736},
          "bq_signful": {"n": sg_n, "dim": sdim_bq, "clusters": sncl,
                         "ef": 100, "rerank_factor": 4,
                         "recall_at_10_vs_float_gt": sg_rec, "qps": sg_qps,
                         "seconds": sg_build, "reference": 0.9903}})

    # ---- 8.5 sparse exact inner product at n × 4,096, nnz 32 ------------
    t0 = time.perf_counter()
    sdim, snnz, sq_n = 4096, 32, 4000
    g = torch.Generator(device=dev).manual_seed(11)

    def sparse_rows(count):
        idx = torch.empty((count, snnz), dtype=torch.int32, device=dev)
        for s in range(0, count, 65536):
            e = min(s + 65536, count)
            keys = torch.rand((e - s, sdim), generator=g, device=dev)
            idx[s:e] = torch.sort(torch.topk(keys, snnz, dim=1).indices,
                                  dim=1).values.to(torch.int32)
        val = torch.randn((count, snnz), generator=g, device=dev)
        return idx, torch.where(val == 0, 1.0, val)

    sp = SparseTable(sdim, nnz_cap=snnz, capacity=n, device=dev)
    sp.insert_arrays(*sparse_rows(n))
    qi, qv = (t.cpu().numpy() for t in sparse_rows(sq_n))
    squeries = [SparseVec(sdim, qi[i], qv[i], _checked=True)
                for i in range(sq_n)]
    gen_s = time.perf_counter() - t0
    flat = FlatIndex(sp, Metric.IP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd1, si1 = flat.search(squeries, k)
    sparse_exact_s = time.perf_counter() - t0
    # a table whose dense copy fits PGVECTOR_TPU_SPARSE_DENSIFY_GB (8 GB,
    # a shortened --n) takes that copy instead of tiles; both reach K1
    route = "densified-tile" if n * sdim * 4 > 8 << 30 else "densified-fused"
    check(flat.last_path == route, f"the sparse scan over {n} rows took the "
          f"{route} route ({flat.last_path})")
    chk = 200
    old = {v: os.environ.get(v) for v in ("PGVECTOR_TPU_SPARSE_DENSIFY_GB",
                                           "PGVECTOR_TPU_SPARSE_TILE_BYTES")}
    os.environ["PGVECTOR_TPU_SPARSE_DENSIFY_GB"] = "0"
    os.environ["PGVECTOR_TPU_SPARSE_TILE_BYTES"] = "1024"
    try:
        mj = FlatIndex(sp, Metric.IP)
        sd0, si0 = mj.search(squeries[:chk], k)
        check(mj.last_path == "merge-join", "the check took the merge join")
    finally:
        for v, x in old.items():
            if x is None:
                os.environ.pop(v)
            else:
                os.environ[v] = x
    # K1's bound on both results' rows (the IP score is half K1's)
    ids = np.concatenate([si0, si1[:chk]], axis=0)
    both = torch.as_tensor(np.maximum(ids, 0), device=dev).long().reshape(-1)
    rows_d = D.scatter_dense(sp.idx[both], sp.val[both], sdim)[:, :sdim]
    loc = torch.arange(both.numel(), device=dev).reshape(ids.shape)
    q_d = flat._dense_sparse_queries(squeries[:chk])
    zeros = torch.zeros(both.numel(), device=dev)
    loc0 = torch.where(torch.as_tensor(si0, device=dev) >= 0, loc[:chk], -1)
    loc1 = torch.where(torch.as_tensor(si1[:chk], device=dev) >= 0,
                       loc[chk:], -1)
    bound = 0.5 * k1_error_bound(q_d, rows_d, zeros, loc0, loc1)
    assert_same_topk(sd0, si0, sd1[:chk], si1[:chk],
                     atol=bound.cpu().numpy(), rtol=0.0)
    fin = np.isfinite(sd0)
    sp_err = float(np.abs(sd1[:chk][fin] - sd0[fin]).max())
    del rows_d, q_d

    # ---- 8.6 sparse inner-product HNSW at 24,576 rows --------------------
    t0 = time.perf_counter()
    ns = 24_576
    st = SparseTable(sdim, nnz_cap=snnz, capacity=ns, device=dev)
    st.insert_arrays(sp.idx[:ns], sp.val[:ns], _checked=True)
    _, gt_s = FlatIndex(st, Metric.IP).search(squeries, k)
    s_exact_s = time.perf_counter() - t0
    with config.local(**{"hnsw.sparse_pair_bytes": 512 << 20}):
        sidx = HNSWIndex(st, Metric.IP, m=16, ef_construction=64,
                         wave_size=1024, dedup=False, beam_expand=4,
                         build=False)
        sparse_wave = _profiled_waves(sidx, orig_sl)
        t0 = time.perf_counter()
        try:
            sidx.build()
        finally:
            del sidx._insert_wave
        s_build = time.perf_counter() - t0
        wave_eff = sidx._wave_eff
    sidx.beam_expand = 8
    s_sweep = []
    floors = {40: 0.65, 100: 0.83}  # the reference: 0.6967 and 0.8694
    for ef in (40, 100):
        _, r_sp, qps_sp = searched(sidx, squeries, ef)
        rec = recall_of(r_sp, gt_s)
        s_sweep.append({"ef": ef, "recall_at_10": rec, "qps": qps_sp})
        check(rec >= floors[ef], f"sparse IP recall@10 {rec} >= "
              f"{floors[ef]} at ef {ef}")
    launches = {"fused_topk": fused_topk.launches,
                "bit_topk": bit_topk.launches,
                "bit_point_scores": bit_point_scores.launches}
    check(launches["bit_topk"] > 0 and launches["bit_point_scores"] > 0
          and launches["fused_topk"] > 0,
          f"the bit and sparse paths went through K4, K5 and K1: {launches}")
    emit({"phase": "sparse", "nvidia_smi": smi,
          "exact": {"n": n, "dim": sdim, "nnz": snnz, "queries": sq_n,
                    "route": route, "s": sparse_exact_s,
                    "data_s": gen_s, "checked_queries": chk,
                    "max_abs_err_vs_merge_join": sp_err,
                    "tolerance": "k1_error_bound / 2"},
          "hnsw": {"n": ns, "build_s": s_build, "exact_gt_s": s_exact_s,
                   "wave": wave_eff, "sparse_pair_bytes": 512 << 20,
                   "sweep": s_sweep, "reference": [0.6967, 0.8694]},
          "launches": launches})

    # ---- 8.7 the device programs of this phase without a hand kernel ----
    progs = []
    svals = (sidx.values[0], sidx.values[1])
    qrep = sidx._query_rep(squeries)
    scorer = K.make_scorer("sparse", Metric.IP, svals, sidx._scorer_sdim())
    hop_rows = torch.as_tensor(rng.integers(0, ns, (sq_n, 256)),
                               dtype=torch.int32, device=dev)
    kern, _, top = profile_call(lambda: scorer(qrep, hop_rows), reps=5)
    b_, by_ = bound_ms(hop_rows.numel() * (snnz * 8 + 8) + sq_n * snnz * 8,
                       2.0 * hop_rows.numel() * snnz)
    progs.append({"name": "sparse hop scorer (make_scorer, densified "
                  "query, 4,000 x 256 rows)",
                  "ms": cuda_ms(lambda: scorer(qrep, hop_rows)),
                  "cuda_kernels": kern, "bound_ms": b_, "bound_by": by_,
                  "top_kernels_ms": top})
    c_s = sidx.ef_construction + sidx.m
    pel = torch.as_tensor(np.stack([rng.choice(ns, c_s, replace=False)
                                    for _ in range(wave_eff)]),
                          dtype=torch.int32, device=dev)
    pair_sdim = sidx._pair_sdim()

    def pair():
        return K._pairwise_dists("sparse", Metric.IP, svals, pel, pair_sdim)

    kern, _, top = profile_call(pair, reps=5)
    b_, by_ = bound_ms(pel.numel() * snnz * 8 + pel.numel() * c_s * 4,
                       2.0 * pel.numel() * c_s * snnz)
    progs.append({"name": f"sparse pairwise block (_pairwise_dists, "
                  f"densified, {wave_eff} x {c_s} x {c_s})",
                  "ms": cuda_ms(pair), "cuda_kernels": kern,
                  "bound_ms": b_, "bound_by": by_, "top_kernels_ms": top})
    tile = 8192

    def densify():
        return D.scatter_dense(sp.idx[:tile], sp.val[:tile], sdim)

    kern, _, top = profile_call(densify, reps=5)
    b_, by_ = bound_ms(tile * snnz * 8 + tile * (sdim + 1) * 4)
    progs.append({"name": f"densify of one tile (scatter_dense, {tile} rows)",
                  "ms": cuda_ms(densify), "cuda_kernels": kern,
                  "calls": -(-n // tile), "bound_ms": b_, "bound_by": by_,
                  "top_kernels_ms": top})
    progs.append(_wave_row("bit build wave", bit_wave, 4 * w, 128,
                           INT8_OPS, 80))
    progs.append(_wave_row("sparse build wave", sparse_wave, snnz * 8, snnz,
                           F32_FLOPS, c_s))
    secs["phase"] = time.perf_counter() - t_phase
    emit({"phase": "bit_sparse_programs", "nvidia_smi": smi,
          "programs": progs, "seconds": secs})
    del sidx, st, sp
    torch.cuda.empty_cache()
    return [
        {"name": "bit_topk", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/bit_scan.cu",
         "replaces": "pgvector_tpu/ops/distance.py:144 (bit_scores under "
                     "tiled_topk; an XLA program, no Pallas kernel)",
         "launches": launches["bit_topk"], "on_main_path": True,
         "max_abs_err": max(c["max_abs_err"] for c in k4),
         "ms": k4_ms, "ms_jaccard": k4_jaccard_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": k4_lib_ms, "library_queries": 1000,
         "ms_at_library_queries": k4_ms_1000, "library_note": lib_note,
         "cases": k4},
        {"name": "bit_point_scores", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/bit_scan.cu",
         "replaces": "pgvector_tpu/index/hnsw_kernels.py:104 (the bit "
                     "scorer and pairwise block; XLA programs, no Pallas "
                     "kernel)",
         "launches": launches["bit_point_scores"], "on_main_path": True,
         "max_abs_err": max(c["max_abs_err"] for c in k5),
         "ms": k5_ms, "kernel_only_ms": k5_kernel_ms,
         "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None,
         "cases": k5},
    ]


def _f32_l2_bound(qs, rows, width):
    """Twice the f32 error bound of |q|² + |x|² - 2 q·x over ``width``
    terms (ops/fused_topk's derivation): two routes each evaluate it in
    f32 with their own summation order.  qs (Q, D), rows (Q, k, D)."""
    import torch

    u = 2.0 ** -24
    qsq = (qs * qs).sum(1, keepdim=True)
    s_abs = torch.einsum("qd,qkd->qk", qs.abs(), rows.abs())
    return 2 * u * ((width + 2) * (qsq + (rows * rows).sum(-1))
                    + (2 * width + 4) * s_abs)


def halfvec_phase(smi, dev, n=200_000, nq=8000, k=10):
    """Phase 9: halfvec at GIST-1M's width (bench.py:643-700's lane).
    bench.make_data(n, nq, dim=960, seed=7) in a bf16 DenseTable; with
    every count at 0, the exact L2 top-10 through FlatIndex (the grouped
    engine; 200 queries against the tiled route), the HNSW build (m 16,
    ef_construction 64, wave 1024, build beam 4, dedup off) and, on that
    graph with query beam 8, searches at ef 40 and 100 over the bf16 slab
    ``auto`` picks at 200k and then over the int8 slab
    (PGVECTOR_TPU_PACKED_SCAN=int8, restored after); then K2's int8 slab
    against its plain version on hop states captured from the int8
    searches, timed beside its bound and the bf16 slab's kernel at the
    same hop; last, what ``auto`` picks for 1M × 960 on this card.
    Returns K7 against its plain version on this graph
    (``tools/k7_walk.walk_vs_plain``; one K7 launch a search) and the
    K2-int8 row of the kernel line."""
    import numpy as np
    import torch

    from bench import make_data
    from pgvector_tpu_torch import DenseTable, FlatIndex, HNSWIndex, Metric
    from pgvector_tpu_torch.index import hnsw_kernels
    from pgvector_tpu_torch.index.hnsw import auto_packed_dtype
    from pgvector_tpu_torch.ops import distance as D
    from pgvector_tpu_torch.ops.fused_topk import fused_topk, l2_root_bound
    from pgvector_tpu_torch.ops.gather_hop import hop_buffers
    from pgvector_tpu_torch.ops.greedy_walk import greedy_walk
    from pgvector_tpu_torch.ops.packed_hop import (
        int8_l1_bound, packed_hop, packed_hop_plain)
    from pgvector_tpu_torch.tools.k7_walk import walk_vs_plain
    from pgvector_tpu_torch.utils.telemetry import timers
    from torch_parity import assert_same_topk

    dim, env = 960, "PGVECTOR_TPU_PACKED_SCAN"
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    gdb, gqs = make_data(n, nq, dim=dim, seed=7)
    table = DenseTable(dim, dtype=torch.bfloat16, capacity=n, device=dev)
    table.insert(gdb)
    data_s = time.perf_counter() - t0

    # the counts go to 0 here: what follows is this phase's main path
    fused_topk.launches = packed_hop.launches = 0
    packed_hop.launches_by_slab = dict.fromkeys(packed_hop.launches_by_slab, 0)
    packed_hop.launches_by_path = dict.fromkeys(packed_hop.launches_by_path, 0)
    flat = FlatIndex(table, Metric.L2)
    t0 = time.perf_counter()
    gt_d, gt = flat.search(gqs, k)
    gt_s = time.perf_counter() - t0
    check(flat.last_path == "grouped",
          f"the bf16 ground truth took the grouped engine ({flat.last_path})")
    check(gt.shape == (nq, k) and np.isfinite(gt_d).all()
          and (gt >= 0).all(), "a finite, full ground truth")
    # 200 queries against the tiled route, within twice the f32 error of
    # an expanded L2 at this width, carried through the square root
    os.environ["PGVECTOR_TPU_EXACT"] = "xla"
    try:
        tiled = FlatIndex(table, Metric.L2)
        td, ti = tiled.search(gqs[:200], k)
    finally:
        del os.environ["PGVECTOR_TPU_EXACT"]
    check(tiled.last_path == "tiled", "the check took the tiled scan")
    qd = torch.as_tensor(gqs[:200], device=dev)
    e = torch.zeros((200, k), device=dev)
    for ids in (ti, gt[:200]):
        rows = table.data[torch.as_tensor(ids, device=dev).long()].float()
        e = torch.maximum(e, _f32_l2_bound(qd, rows, dim))
    atol = l2_root_bound(e, torch.as_tensor(td, device=dev)).cpu().numpy()
    assert_same_topk(td, ti, gt_d[:200], gt[:200], atol=atol, rtol=0.0)
    gt_check = {"queries": 200, "ids_equal_frac": float((ti == gt[:200]).mean()),
                "max_abs_err": float(np.abs(td - gt_d[:200]).max()),
                "max_err_over_bound": float(
                    (np.abs(td - gt_d[:200]) / atol).max())}

    timers.reset()
    timers.enabled = True
    t0 = time.perf_counter()
    idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64,
                    wave_size=1024, dedup=False, beam_expand=4)
    build_s = time.perf_counter() - t0
    timers.enabled = False
    build_phases = {key: v["total_s"] for key, v in timers.report().items()}
    idx.beam_expand = 8  # query-side beam, as bench.py:518
    check(os.environ.get(env) is None, f"{env} is unset for auto")
    auto = idx._packed_plan()
    check(auto == torch.bfloat16, f"auto picks bf16 at {n} x {dim}, not {auto}")

    floors = {40: 0.94, 100: 0.985}  # the reference: 0.9759 and 0.9981
    states, calls = {}, []

    def record(*a, **kw):
        if len(calls) in (0, 4, 12):
            states[len(calls)] = keep_state(a, kw)
        calls.append(1)
        return packed_hop(*a, **kw)

    tiers = {}
    walks = greedy_walk.launches
    try:
        for tier in ("bf16", "int8"):
            if tier == "int8":
                os.environ[env] = "int8"
            hops, sweep = 0, []
            for ef in (40, 100):
                idx.search(gqs, k, ef_search=ef)  # warm-up: builds the slab
                torch.cuda.synchronize()
                hops += scan_launches(idx)
                t0 = time.perf_counter()
                dist, r = idx.search(gqs, k, ef_search=ef)
                dt = time.perf_counter() - t0
                hops += scan_launches(idx)
                check(r.shape == (nq, k) and np.isfinite(dist).all(),
                      f"finite {tier} results of shape {(nq, k)}")
                rec = sum(len(set(a.tolist()) & set(b.tolist()))
                          for a, b in zip(r, gt)) / (nq * k)
                check(rec >= floors[ef], f"{tier} recall@10 {rec} >= "
                      f"{floors[ef]} at ef={ef}")
                sweep.append({"ef": ef, "recall_at_10": rec, "qps": nq / dt,
                              "layer0_hops": idx._last_scan_steps})
            slab = idx._nbr_vals
            check(slab.dtype == getattr(torch, {"bf16": "bfloat16",
                                               "int8": "int8"}[tier]),
                  f"the {tier} slab scanned, not {slab.dtype}")
            tiers[tier] = {"sweep": sweep, "layer0_hops": hops,
                           "slab_gb": slab.numel() * slab.element_size() / 1e9,
                           "launches": packed_hop.launches_by_slab[tier]}
            check(packed_hop.launches_by_slab[tier] == hops,
                  f"every {tier} layer-0 hop went through K2: "
                  f"{packed_hop.launches_by_slab[tier]} launches for {hops}")
        check(greedy_walk.launches - walks == 8,
              f"each of 8 searches walked its upper levels in one K7 launch: "
              f"{greedy_walk.launches - walks} launches")
        for ef in (40, 100):
            b16, i8 = (next(s["recall_at_10"] for s in tiers[t]["sweep"]
                            if s["ef"] == ef) for t in ("bf16", "int8"))
            check(i8 >= b16 - 0.01, f"int8 recall {i8} within 0.01 of bf16's "
                  f"{b16} at ef={ef}")
        launches = {"fused_topk": fused_topk.launches,
                    "packed_hop": packed_hop.launches,
                    "packed_hop_by_slab": dict(packed_hop.launches_by_slab)}
        check(launches["packed_hop_by_slab"]["f32"] == 0, "no f32 slab")
        # hop states of one int8 search at ef 100 (hops 0, 4 and 12), and
        # the bf16 slab's kernel at hop 4 of the same search
        hnsw_kernels.packed_hop = record
        try:
            idx.search(gqs, k, ef_search=100)
        finally:
            hnsw_kernels.packed_hop = packed_hop
        check(sorted(states) == [0, 4, 12], f"captured hops {sorted(states)}")
    finally:
        os.environ.pop(env, None)

    def with_rows(st, rows, metric, qs):
        """A captured state cut to its first ``rows`` queries, scored
        under ``metric`` against ``qs`` (quantized anew)."""
        (pool_d, pool_p, nbr0, vals, _, ef, e_sel, _,
         (_, _, _, pn, sc)), kw = st
        qs = qs[:rows].contiguous()
        qc, sq, q2 = D.int8_query(qs, sc)
        return ([pool_d[:rows], pool_p[:rows], nbr0, vals, qs, ef, e_sel,
                 metric, (qc, sq, q2, pn, sc)],
                {n: v[:rows] for n, v in kw.items()})

    count = dict(packed_hop.launches_by_slab)  # checks below do not count
    paths = dict(packed_hop.launches_by_path)
    cases = []
    for hop, (a, kw) in sorted(states.items()):
        out1, out0 = packed_hop(*a, **kw), packed_hop_plain(*a, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(out1, out0)),
              f"K2-int8 equals its plain version (L2, hop {hop})")
        cases.append({"hop": hop, "metric": "L2", "queries": len(a[4]),
                      "equal": True, "max_abs_err": 0.0})
    a, kw = states[4]
    qn = a[4] / torch.clamp(a[4].norm(dim=1, keepdim=True), min=1e-30)
    for metric, q_use in ((Metric.IP, qn), (Metric.L1, a[4])):
        a2, kw2 = with_rows(states[4], 2000, metric, q_use)
        out1, out0 = packed_hop(*a2, **kw2), packed_hop_plain(*a2, **kw2)
        torch.cuda.synchronize()
        fin = torch.isfinite(out0[0])
        err = float((out1[0] - out0[0])[fin].abs().max())
        if metric is Metric.IP:
            check(all(torch.equal(x, y) for x, y in zip(out1, out0)),
                  "K2-int8 equals its plain version (IP, normalized queries)")
            tol = 0.0
        else:
            bound = int8_l1_bound(out0[0], dim)
            same_hop(out1, out0, "K2-int8 L1", atol=bound.cpu().numpy())
            tol = float(bound[fin].max())
        cases.append({"hop": 4, "metric": metric.name, "queries": len(a2[4]),
                      "equal": metric is Metric.IP, "max_abs_err": err,
                      "tolerance_max": tol})
    # timed at the main path's shapes: ef 100, hop 4 (Q = 8,000, E = 8)
    wk = k2_work(a, kw)
    live = wk.pop("live")
    ef, q_rows = a[5], wk["queries"]
    bufs = hop_buffers(q_rows, ef, dev)
    k2_ms = cuda_ms(lambda: packed_hop(*a, **kw, out=bufs), reps=10)
    k2_kernel_ms, k2_events = kernel_only_ms(
        lambda: packed_hop(*a, **kw, out=bufs), reps=20)
    k2_plain = cuda_ms(lambda: packed_hop_plain(*a, **kw), reps=3)
    del states
    # the bf16 slab's kernel at the same hop: the same pools over a bf16
    # slab of this graph, held against its plain version and timed
    idx._drop_packed()
    b16 = idx._ensure_nbr_vals(torch.bfloat16)
    a_b = [*a[:3], b16, a[4], ef, a[6], Metric.L2]
    bf16_err = same_hop(packed_hop(*a_b, **kw), packed_hop_plain(*a_b, **kw),
                        "K2 on the 960-d bf16 slab")
    wk_b = k2_work(a_b, kw)
    wk_b.pop("live")
    bf16_ms = cuda_ms(lambda: packed_hop(*a_b, **kw, out=bufs), reps=10)
    bf16_kernel_ms, _ = kernel_only_ms(
        lambda: packed_hop(*a_b, **kw, out=bufs), reps=20)
    packed_hop.launches_by_slab = count
    packed_hop.launches_by_path = paths
    # K7 on this graph's upper levels at GIST-960's width
    walk = walk_vs_plain(idx, gqs)
    total = torch.cuda.get_device_properties(dev).total_memory
    pick_1m = auto_packed_dtype(1_000_000, 16, dim, Metric.L2, total)
    check(pick_1m == torch.int8, f"auto picks int8 at 1M x {dim}, not {pick_1m}")
    emit({"phase": "halfvec", "nvidia_smi": smi, "n": n, "queries": nq,
          "dim": dim, "dtype": "bfloat16", "data_s": data_s,
          "exact_gt_s": gt_s, "exact_path": flat.last_path,
          "gt_vs_tiled": gt_check, "build_s": build_s,
          "build_phases": build_phases, "auto_plan_200k": "bfloat16",
          "tiers": tiers, "launches": launches,
          "k2_int8_vs_plain": cases,
          "k2_int8_timed": dict(wk, ef=ef, hop=4, ms=k2_ms,
                                kernel_only_ms=k2_kernel_ms,
                                kernel_events=k2_events, plain_ms=k2_plain),
          "k2_bf16_slab": dict(wk_b, ef=ef, hop=4, max_abs_err=bf16_err,
                               ms=bf16_ms, kernel_only_ms=bf16_kernel_ms),
          "launches_by_path": paths, "greedy_walk_vs_plain": walk,
          "auto_plan_1m": {"rows": 1_000_000, "dim": dim, "m": 16,
                           "total_memory": total,
                           "pick": str(pick_1m).replace("torch.", "")},
          "seconds": time.perf_counter() - t_phase})
    idx._drop_packed()
    del idx, table, flat, a, kw, a_b, b16, bufs
    gc.collect()
    torch.cuda.empty_cache()
    return walk, {"name": "packed_hop_int8", "route": "cuda",
            "source": "pgvector_tpu_torch/csrc/packed_hop.cu",
            "replaces": "pgvector_tpu/index/hnsw_kernels.py:202 "
                        "(_int8_point_scores, an XLA program) in front of "
                        "pgvector_tpu/ops/pallas_hop.py:154",
            "launches": tiers["int8"]["launches"], "on_main_path": True,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": k2_ms, "kernel_only_ms": k2_kernel_ms,
            "plain_ms": k2_plain, "bound_ms": wk["bound_ms"],
            "bound_by": wk["bound_by"],
            "library_ms": None, "cases": cases}


def mesh_phase(db, qs, smi, dev, k=10, n_hnsw=200_000, n_build=50_000,
               dim_queries=1000):
    """Phase 11: the mesh paths (pgvector_tpu_torch.parallel) on four
    shards of one card, make_mesh(4, devices=[cuda:0] * 4), over a fresh
    upload of phase 1's make_data(n, queries, seed=0).  With every count at
    0: (1) sharded_exact_search and ShardedFlatIndex, L2 and IP, all
    queries, against the single-device K1 ground truth (ids apart from
    ties, distances within twice k1_error_bound plus torch_parity's
    ATOL / RTOL; 4 K1 launches a search); (2) dim_sharded_exact_search,
    4 × 32 dims, 1,000 queries, L2 / IP / cosine against the single-device
    plain scan (dense_scores, the same formula unsharded) within ATOL /
    RTOL; (3) IVFFlatIndex(mesh=...) with lists 1,000 (k-means through
    train_centers_sharded) and DeviceShardedIVFFlatIndex with lists 250 a
    shard, recall@10 at probes 10 >= 0.99; (4) DeviceShardedHNSWIndex
    (row gathers, the hash2 visited set) and ShardedHNSWIndex (K2 over
    each shard's slab) over the first 200,000 rows (m 16,
    ef_construction 64, wave 1024, build beam 4, query beam 8), recall@10
    at ef 40 / 100 >= 0.94 / 0.985 against K1 over those rows, the two
    wrappers' per-shard nbr0 equal bit for bit, and a save loaded on a
    (4 shards × 2 replicas) mesh with qaxis "qp" whose fan-out equals the
    1-D search bit for bit; (5) the mesh build, HNSWIndex(build_mesh=...)
    against HNSWIndex() over the first 50,000 rows, graphs equal bit for
    bit; (6) the knobs on (4)'s ShardedHNSWIndex: PGVECTOR_TPU_VISITED
    hash1 and hash2 (floors of (4)) and PGVECTOR_TPU_QUERY_MAX_STEPS=8
    (recall and hops printed).  Where the machine has two or more cards,
    a 1-D mesh over them runs (1) too and must equal the one-card mesh.
    Returns the phase's K1 and K2 launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from torch_parity import ATOL, RTOL, assert_same_topk
    from pgvector_tpu_torch import DenseTable, FlatIndex, HNSWIndex, \
        IVFFlatIndex, Metric
    from pgvector_tpu_torch import parallel as TP
    from pgvector_tpu_torch.index.flat import dense_exact
    from pgvector_tpu_torch.ops import distance as D
    from pgvector_tpu_torch.ops.fused_topk import fused_topk, k1_error_bound
    from pgvector_tpu_torch.ops.packed_hop import packed_hop
    from pgvector_tpu_torch.ops.topk import topk_smallest

    t_phase = time.perf_counter()
    n, nq = len(db), len(qs)
    table = DenseTable(128, capacity=n, device=dev)
    table.insert(db)
    data = table.data[:n]
    qs_dev = torch.as_tensor(qs, device=dev)
    mesh = TP.make_mesh(4, devices=[dev] * 4)
    out = {"phase": "mesh", "nvidia_smi": smi, "n": n, "queries": nq,
           "k": k, "mesh": repr(mesh)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def recall(r, gt):
        return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                              for a, b in zip(r, gt)]))

    # the counts go to 0 here: what follows is this phase's main path
    fused_topk.launches = packed_hop.launches = 0

    # ---- 11.1 row-sharded exact search (K1 on every shard) --------------
    exact = {}
    gts = {}
    for metric in (Metric.L2, Metric.IP):
        (d0, i0, path), _ = timed(lambda: dense_exact(
            metric, qs_dev, data, n, k, table.valid[:n], 16384))
        check(path == "fused", f"the {metric.name} ground truth took K1")
        before = fused_topk.launches
        (d1, i1), dt = timed(lambda: TP.sharded_exact_search(
            mesh, metric, data, qs_dev, k, valid=table.valid[:n]))
        per_search = fused_topk.launches - before
        check(per_search == 4, f"4 K1 launches a sharded search, not "
              f"{per_search}")
        dbsq = (torch.sum(data * data, dim=1) if metric is Metric.L2
                else torch.zeros(n, device=dev))
        bound = k1_error_bound(qs_dev, data, dbsq, i0, i1)
        bnp = bound.cpu().numpy()
        d0n, i0n, d1n, i1n = (t.cpu().numpy() for t in (d0, i0, d1, i1))
        assert_same_topk(d0n, i0n, d1n, i1n, atol=2.0 * bnp + ATOL, rtol=RTOL)
        flat_idx = TP.ShardedFlatIndex(mesh, table, metric)
        (fd, fi), fdt = timed(lambda: flat_idx.search(qs, k))
        ud = np.sqrt(d0n) if metric is Metric.L2 else d0n
        ub = (np.sqrt(d0n + 2 * bnp) - np.sqrt(np.maximum(d0n - 2 * bnp, 0))
              if metric is Metric.L2 else 2 * bnp)
        assert_same_topk(ud, i0n, fd, fi, atol=ub + ATOL, rtol=RTOL)
        gts[metric.name] = i0n
        err = np.abs(d1n - d0n)[np.isfinite(d0n)]
        exact[metric.name] = {
            "qps": nq / dt, "sharded_flat_qps": nq / fdt,
            "k1_launches_a_search": per_search,
            "ids_equal_frac": float((i0n == i1n).mean()),
            "max_abs_err": float(err.max()),
            "max_err_over_bound": float((np.abs(d1n - d0n)
                                         / np.maximum(bnp, 1e-30))
                                        [np.isfinite(d0n)].max())}
        if torch.cuda.device_count() > 1:
            cards = TP.make_mesh(torch.cuda.device_count())
            virt = TP.make_mesh(cards.size, devices=[dev] * cards.size)
            a = TP.sharded_exact_search(virt, metric, data, qs_dev, k)
            b = TP.sharded_exact_search(cards, metric, data, qs_dev, k)
            check(all(torch.equal(x, y.to(dev)) for x, y in zip(a, b)),
                  f"the {cards.size}-card mesh equals {cards.size} shards "
                  "of one card")
            exact[metric.name]["cards_mesh_equal"] = cards.size
    out["sharded_exact"] = exact
    out["sharded_exact_tolerance"] = ("ids apart from ties; distances "
                                      "within 2 k1_error_bound + ATOL, "
                                      "rtol RTOL (tests/torch_parity.py)")
    gt = gts["L2"]

    # ---- 11.2 dim-sharded exact search (4 x 32 dims) --------------------
    dims = {}
    dim_queries = min(dim_queries, nq)
    qd = qs_dev[:dim_queries].contiguous()
    for metric in (Metric.L2, Metric.IP, Metric.COSINE):
        (d1, i1), dt = timed(lambda: TP.dim_sharded_exact_search(
            mesh, metric, data, qd, k))
        d1, i1 = d1.cpu().numpy(), i1.cpu().numpy()
        d0, i0 = topk_smallest(D.dense_scores(metric, qd, data), k)
        d0, i0 = d0.cpu().numpy(), i0.cpu().numpy()
        torch.cuda.empty_cache()
        assert_same_topk(d0, i0, d1, i1, atol=ATOL, rtol=RTOL)
        dims[metric.name] = {"seconds": dt, "qps": dim_queries / dt,
                             "ids_equal_frac": float((i0 == i1).mean()),
                             "max_abs_err": float(np.abs(d1 - d0).max())}
    out["dim_sharded"] = {"queries": dim_queries, "cols_a_shard": 32,
                          "tolerance": f"atol {ATOL}, rtol {RTOL} against "
                          "the single-device dense_scores scan",
                          "metrics": dims,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated()}
    del qd
    torch.cuda.empty_cache()

    # ---- 11.3 IVFFlat: k-means over the mesh; device-sharded ------------
    ivf = {}
    for name, make in (
            ("mesh_kmeans", lambda: IVFFlatIndex(table, Metric.L2,
                                                 lists=1000, seed=1,
                                                 mesh=mesh)),
            ("device_sharded", lambda: TP.DeviceShardedIVFFlatIndex(
                mesh, table, Metric.L2, lists=250, seed=1))):
        index, build_s = timed(make)
        index.search(qs[:100], k, probes=10)  # warm-up
        (_, r), dt = timed(lambda: index.search(qs, k, probes=10))
        rec = recall(r, gt)
        check(rec >= 0.99, f"IVF {name} recall@10 {rec} >= 0.99 at probes "
              "10")
        ivf[name] = {"build_s": build_s, "recall_at_10": rec,
                     "qps": nq / dt}
        if name == "mesh_kmeans":
            ivf[name]["kmeans_rounds"] = index.kmeans_iters
        del index
    out["ivf"] = ivf
    torch.cuda.empty_cache()

    # ---- 11.4 sharded HNSW over the first n_hnsw rows --------------------
    floors = {40: 0.94, 100: 0.985}
    sub = DenseTable(128, capacity=n_hnsw, device=dev)
    sub.insert(db[:n_hnsw])
    (gd, gt_h, _), _ = timed(lambda: dense_exact(
        Metric.L2, qs_dev, sub.data[:n_hnsw], n_hnsw, k,
        sub.valid[:n_hnsw], 16384))
    gt_h = gt_h.cpu().numpy()
    kw = dict(m=16, ef_construction=64, wave_size=1024, beam_expand=4,
              seed=0)
    hnsw = {"n": n_hnsw, "shards": 4}
    dsh, hnsw["device_sharded_build_s"] = timed(
        lambda: TP.DeviceShardedHNSWIndex(mesh, sub, Metric.L2, **kw))
    shh, hnsw["sharded_build_s"] = timed(
        lambda: TP.ShardedHNSWIndex(sub, Metric.L2, n_shards=4, **kw))
    check(all(torch.equal(a.nbr0, b.nbr0)
              for a, b in zip(dsh.shards, shh.shards)),
          "the two wrappers' per-shard nbr0 are equal bit for bit")
    for s in shh.shards:
        s.beam_expand = 8  # the query-side beam, as phase 4
    sweeps = {"device_sharded": [], "sharded": []}
    base = {}
    for ef in (40, 100):
        k2 = packed_hop.launches
        (dd, rd), dt = timed(lambda: dsh.search(qs, k, ef_search=ef,
                                                 expand=8))
        check(packed_hop.launches == k2,
              "DeviceShardedHNSWIndex gathers rows (no K2)")
        base[ef] = (dd, rd)
        rec = recall(rd, gt_h)
        check(rec >= floors[ef], f"DeviceSharded recall@10 {rec} >= "
              f"{floors[ef]} at ef {ef}")
        sweeps["device_sharded"].append({"ef": ef, "recall_at_10": rec,
                                         "qps": nq / dt})
        shh.search(qs[:100], k, ef_search=ef)  # warm-up: the slabs
        k2 = packed_hop.launches
        (_, rs), dt = timed(lambda: shh.search(qs, k, ef_search=ef))
        hops = sum(scan_launches(s) for s in shh.shards)
        check(packed_hop.launches - k2 == hops,
              f"K2 once a layer-0 hop of every shard: "
              f"{packed_hop.launches - k2} launches for {hops} hops")
        rec = recall(rs, gt_h)
        check(rec >= floors[ef], f"Sharded recall@10 {rec} >= "
              f"{floors[ef]} at ef {ef}")
        sweeps["sharded"].append({"ef": ef, "recall_at_10": rec,
                                  "qps": nq / dt, "k2_launches": hops})
    hnsw["sweeps"] = sweeps
    tmp = tempfile.mkdtemp(prefix="pgvt_mesh_")
    try:
        dsh.save(tmp + "/h")
        mesh2 = TP.make_mesh2(4, 2, devices=[dev] * 8)
        fan = TP.DeviceShardedHNSWIndex.load(mesh2, sub, tmp + "/h",
                                             qaxis="qp")
        (fd, fr), dt = timed(lambda: fan.search(qs, k, ef_search=40,
                                                expand=8))
        check(np.array_equal(fr, base[40][1])
              and np.array_equal(fd, base[40][0]),
              "the loaded (4 x 2) fan-out equals the 1-D search bit for bit")
        hnsw["fanout"] = {"mesh": repr(mesh2), "ef": 40, "qps": nq / dt,
                          "equal_to_1d": True}
        del fan
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- 11.6 the knobs on the ShardedHNSWIndex's shards -----------------
    knobs = {}
    for env, val in (("PGVECTOR_TPU_VISITED", "hash1"),
                     ("PGVECTOR_TPU_VISITED", "hash2"),
                     ("PGVECTOR_TPU_QUERY_MAX_STEPS", "8")):
        os.environ[env] = val
        try:
            (_, rk), dt = timed(lambda: shh.search(qs, k, ef_search=40))
        finally:
            del os.environ[env]
        rec = recall(rk, gt_h)
        hops = [s._last_scan_steps for s in shh.shards]
        knobs[f"{env}={val}"] = {"ef": 40, "recall_at_10": rec,
                                 "qps": nq / dt, "layer0_hops": hops}
        if env == "PGVECTOR_TPU_VISITED":
            check(rec >= floors[40], f"{env}={val} recall@10 {rec} >= "
                  f"{floors[40]}")
        else:
            check(max(hops) <= 8, f"the hop cap holds: {hops}")
    hnsw["knobs"] = knobs
    out["hnsw"] = hnsw
    for s in shh.shards:
        s._drop_packed()
    del dsh, shh, base
    torch.cuda.empty_cache()

    # ---- 11.5 the mesh build over the first n_build rows -----------------
    small = DenseTable(128, capacity=n_build, device=dev)
    small.insert(db[:n_build])
    one, one_s = timed(lambda: HNSWIndex(small, Metric.L2, **kw))
    par, par_s = timed(lambda: HNSWIndex(small, Metric.L2, build_mesh=mesh,
                                         **kw))
    same = {name: bool(torch.equal(getattr(one, name), getattr(par, name)))
            for name in ("nbr0", "nbr_up", "kept0", "kept_up")}
    same["levels"] = bool(np.array_equal(one.levels, par.levels))
    same["entry"] = (one.entry, one.entry_level) == (par.entry,
                                                      par.entry_level)
    check(all(same.values()), f"the mesh build equals the single-device "
          f"build bit for bit: {same}")
    out["mesh_build"] = {"n": n_build, "single_s": one_s, "mesh_s": par_s,
                         "equal": same}
    del one, par, small, sub, table, data, qs_dev
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"fused_topk": fused_topk.launches,
                "packed_hop": packed_hop.launches}
    check(launches["fused_topk"] > 0 and launches["packed_hop"] > 0,
          f"K1 and K2 launched in phase 11: {launches}")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return launches


class BuildKernels:
    """The build's two loops and their kernels, counted for the whole run:
    every SelectNeighbors call (``hnsw_kernels.select_neighbors``, the
    name every select calls) beside K3's launches, and every row-gather
    hop with the visited set ``off`` and no discarded pool beside K6's:
    a dense index's hops are the calls of ``hnsw_kernels.gather_hop``
    (one a hop, from ``search_layer``), the others ``_hop_body`` calls
    without the packed cache.  ``capture(kind, args)``, where set, sees
    each select's inputs ("select"), each beam's start ("beam") and each
    K6 call's inputs and keywords ("hop", an (args, kwargs) pair)."""

    def __init__(self):
        from pgvector_tpu_torch.index import hnsw_kernels as K
        from pgvector_tpu_torch.ops.gather_hop import gather_hop
        from pgvector_tpu_torch.ops.select_neighbors import select_neighbors

        self.k3, self.k6 = select_neighbors, gather_hop
        self.capture = None
        self.reset()
        sel, hop, beam, k6 = (K.select_neighbors, K._hop_body,
                              K.search_layer, K.gather_hop)

        def counted_sel(*a, **kw):
            self.calls["select"] += 1
            if self.capture:
                self.capture("select", a)
            return sel(*a, **kw)

        def counted_hop(*a, **kw):
            if (kw.get("packed") is None and kw.get("disc") is None
                    and kw.get("vmode", "off") == "off"):
                self.calls["row_gather_hops"] += 1
            return hop(*a, **kw)

        def counted_beam(*a, **kw):
            if self.capture:
                self.capture("beam", a)
            return beam(*a, **kw)

        def counted_k6(*a, **kw):
            self.calls["row_gather_hops"] += 1
            self.calls["dense_hops"] += 1
            if self.capture:
                self.capture("hop", (a, kw))
            return k6(*a, **kw)

        K.select_neighbors, K._hop_body = counted_sel, counted_hop
        K.search_layer, K.gather_hop = counted_beam, counted_k6

    def reset(self):
        """Every count to 0."""
        self.k3.launches = self.k6.launches = 0
        self.calls = {"select": 0, "row_gather_hops": 0, "dense_hops": 0}

    def read(self, phase, all_dense=False):
        """The counts since the last reset; fails unless every select
        launched K3 and every dense row-gather hop K6 once (with
        ``all_dense`` every row-gather hop was a dense one)."""
        c = dict(self.calls, select_neighbors=self.k3.launches,
                 gather_hop=self.k6.launches)
        check(c["select_neighbors"] == c["select"],
              f"phase {phase}: every select through K3 "
              f"({c['select_neighbors']} launches for {c['select']} calls)")
        check(c["gather_hop"] == c["dense_hops"],
              f"phase {phase}: every dense row-gather hop one K6 launch "
              f"({c['gather_hop']} launches for {c['dense_hops']} hops)")
        check(not all_dense or c["dense_hops"] == c["row_gather_hops"],
              f"phase {phase}: every row-gather hop is a dense one")
        return c


def loop_rows(base_d, valid, pos, kept, lm):
    """(T,) the rows of the pairwise block each pool's keep loop reaches,
    from a select's result: up to the lm-th kept candidate in the stable
    order of the base distances where lm were kept, else every finite
    one."""
    import torch

    big_d = torch.where(valid, base_d, torch.inf)
    fin = torch.isfinite(big_d)
    big_d = torch.where(fin, big_d, torch.inf)
    order = torch.sort(big_d, dim=1, stable=True)[1]
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order).contiguous())
    at = torch.where(kept & (pos >= 0),
                     torch.gather(rank, 1, torch.clamp(pos, min=0).long()),
                     -1)
    n_kept = torch.sum(kept & (pos >= 0), dim=1)
    return torch.where(n_kept >= lm, at.max(dim=1).values + 1,
                       torch.sum(fin, dim=1))


def select_vs_plain(idx, captured, dev, efc=1000, rows=256):
    """K3 against its plain version, bit for bit, on the selects captured
    from a build wave (``captured``: inputs by shape; dense L2 pools come
    in the Gram form, the products and the norms) and on pools of ``efc``
    searched on the built graph for ``rows`` of its elements (the
    connect's C = efc + m); on the Gram form and on the block it forms.
    Each case timed (CUDA events, and the kernel alone by torch.profiler)
    beside its plain version, the formed block's kernel and two bounds:
    the bytes of the rows the keep loop reaches with the flags, norms and
    outputs (``bound_ms``), and the whole block read once
    (``bound_block_ms``)."""
    import numpy as np
    import torch

    from pgvector_tpu_torch import Metric
    from pgvector_tpu_torch.index import hnsw_kernels as K
    from pgvector_tpu_torch.ops.select_neighbors import (
        Gram, form_pairs, select_neighbors, select_neighbors_plain)

    check(captured, "captured the build's selects")
    cases = [("build", a) for a in captured.values()]
    live = np.flatnonzero(idx.levels >= 0)
    elems = torch.as_tensor(live[:: max(len(live) // rows, 1)][:rows],
                            dtype=torch.int32, device=dev)
    pd, pi = K.wave_search(
        "dense", Metric.L2, idx.values, idx.nbr0, idx.nbr_up,
        idx._up_slot_dev, idx.values[elems.long()],
        np.zeros(len(elems), np.int32), idx.entry, idx.entry_level, ef=efc,
        l_unroll=idx._l_unroll, expand=4, self_ids=elems)
    pd, pi = K._connect_pools("dense", Metric.L2, idx.values, elems,
                              torch.ones_like(elems, dtype=torch.bool),
                              pd[0], pi[0], idx.m, 0)
    pair = K._pair_block("dense", Metric.L2, idx.values, pi)
    cases.append((f"ef_construction {efc}",
                  [pd.contiguous(), pair, pi >= 0, 2 * idx.m, None]))
    out = []
    for source, (base, pair_d, valid, lm, forced) in cases:
        gram = isinstance(pair_d, Gram)
        check(gram, f"the {source} select took the Gram form")
        block = form_pairs(pair_d, valid)
        p1, k1 = select_neighbors(base, pair_d, valid, lm, forced)
        p0, k0 = select_neighbors_plain(base, pair_d, valid, lm, forced)
        p2, k2 = select_neighbors(base, block, valid, lm, forced)
        torch.cuda.synchronize()
        check(torch.equal(p1, p0) and torch.equal(k1, k0),
              f"K3 on the Gram form equals its plain version bit for bit "
              f"at {tuple(block.shape)}, lm {lm}")
        check(torch.equal(p2, p0) and torch.equal(k2, k0),
              f"K3 on the formed block equals its plain version bit for "
              f"bit at {tuple(block.shape)}, lm {lm}")
        t, c = base.shape
        reached = int(loop_rows(base, valid, p0, k0, lm).sum())
        flags = 4 * t * c * (2 if pair_d.l2 else 1) + t * c * (
            1 if forced is None else 2) + 5 * t * lm
        b, by = bound_ms(4 * c * reached + flags)
        b_all, _ = bound_ms(4 * t * c * c + flags)
        out.append({
            "source": source, "rows": t, "c": c, "lm": lm,
            "forced": forced is not None, "form": "gram l2",
            "equal": True, "kept": int(k1.sum()),
            "block_rows_reached": reached,
            "ms": cuda_ms(lambda: select_neighbors(base, pair_d, valid, lm,
                                                   forced)),
            "kernel_only_ms": kernel_only_ms(lambda: select_neighbors(
                base, pair_d, valid, lm, forced))[0],
            "block_kernel_only_ms": kernel_only_ms(lambda: select_neighbors(
                base, block, valid, lm, forced))[0],
            "plain_ms": cuda_ms(lambda: select_neighbors_plain(
                base, pair_d, valid, lm, forced)),
            "bound_ms": b, "bound_by": by, "bound_block_ms": b_all})
        del block
    check(any(r["c"] > 512 for r in out), "a case past the register sort")
    return out


def gather_hop_vs_plain(captured):
    """K6 against its plain version on the beam hops captured from a build
    wave (``captured``: (beam, hop) -> (args, kwargs); the last beam is
    level 0), each the whole hop from the beam's state: ids apart from
    ties, distances within torch_parity's ATOL / RTOL (K2's f32 card
    test), the done flags, the count of queries not done and the hop
    counts equal.  Level 0's hop 4 timed (CUDA events, and the kernel
    alone by torch.profiler) beside its plain version and its bound: the
    pool read and written, the expanded elements' lists (and slots above
    level 0), the queries, each row the hop must score (distinct, not in
    the pool) read once, the done flags and hop counts read and written;
    beside it torch.index_select of those rows alone (the library's rate
    for the same random rows, read and written)."""
    import numpy as np
    import torch

    from pgvector_tpu_torch.ops.gather_hop import (
        dedupe_hop, gather_hop, gather_hop_plain, hop_buffers, hop_lists,
        select_expand)

    check(captured, "captured the build's hops")
    level0 = max(b for b, _ in captured)
    out = []
    for (beam, hop), (st, kw) in sorted(captured.items()):
        out1 = gather_hop(*st, **kw)
        err = same_hop(out1, gather_hop_plain(*st, **kw),
                       f"K6 at beam {beam}, hop {hop}")
        row = {"beam": beam, "level0": beam == level0, "hop": hop,
               "not_done": int(out1[3]), "max_abs_err": err}
        if beam == level0 and hop == 4:
            pool_d, pool_p, nbr0, nbr_up, up_slot, level, rows, qs, ef, \
                expand = st[:10]
            q = pool_d.shape[0]
            pp, sel, _ = select_expand(pool_d, pool_p, ef, expand)
            nbrs = hop_lists(sel, nbr0, nbr_up, up_slot, level, rows.shape[0])
            if expand > 1:
                nbrs = dedupe_hop(nbrs)
            in_pool = torch.any(
                nbrs[:, :, None] == (pp >> 1)[:, None, :], dim=2)
            live = (nbrs >= 0) & ~in_pool
            scored = int(live.sum())
            ids = nbrs[live].long()
            gathered = torch.empty((scored, rows.shape[1]),
                                   dtype=rows.dtype, device=rows.device)
            lists = int((sel >= 0).sum()) * (
                nbr0.shape[1] if level == 0 else nbr_up.shape[2] + 1)
            dim = rows.shape[1]
            b, by = bound_ms(16 * q * ef + 4 * lists + 10 * q
                             + qs.element_size() * qs.numel()
                             + rows.element_size() * dim * scored,
                             2.0 * dim * scored)
            # output buffers made once, as a beam makes them: each timed
            # call launches K6 alone
            bufs = hop_buffers(q, ef, pool_d.device)
            row.update(timed=True, queries=q, expand=expand,
                       width=nbr0.shape[1], scored=scored,
                       ms=cuda_ms(lambda: gather_hop(*st, **kw, out=bufs)),
                       kernel_only_ms=kernel_only_ms(
                           lambda: gather_hop(*st, **kw, out=bufs))[0],
                       plain_ms=cuda_ms(
                           lambda: gather_hop_plain(*st, **kw)),
                       bound_ms=b, bound_by=by,
                       index_select_ms=kernel_only_ms(
                           lambda: torch.index_select(rows, 0, ids,
                                                      out=gathered))[0])
        out.append(row)
    check(any(r.get("timed") for r in out), "timed level 0's hop 4")
    return out


def _profiled_waves(index, orig_sl):
    """Wrap ``index._insert_wave`` for a build: the middle wave through
    torch.profiler (with the candidates its beams could score), every
    other wave timed alone, synchronized on both sides.  Returns the dict
    the wrapper fills."""
    import torch

    from pgvector_tpu_torch.index import hnsw_kernels as K

    fn = index._insert_wave
    rows = index.table.count
    middle = max(rows // max(index._effective_wave_size(), 1) // 2, 1)
    out = {"ms": [], "calls": 0, "middle": middle}
    m2 = 2 * index.m

    def call(elems, lv):
        out["calls"] += 1
        if out["calls"] != middle:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(elems, lv)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            return
        cands = [0]

        def sl(*sa, **skw):
            res = orig_sl(*sa, **skw)
            cands[0] += res[2] * sa[3].shape[0] * skw.get("expand", 1) * m2
            return res

        K.search_layer = sl
        try:
            kern, kern_ms, top = profile_call(lambda: fn(elems, lv))
        finally:
            K.search_layer = orig_sl
        out.update(elements=len(elems), kernels=kern, kernel_ms=kern_ms,
                   top_ms=top, candidates=cands[0])

    index._insert_wave = call
    return out


def _wave_row(name, p, row_bytes, op_width, rate, c):
    """A build wave: ms the mean of the waves timed alone; kernels and the
    bound from the profiled middle wave, counting every expanded node's 2m
    neighbours scored once and the select's pairwise block."""
    import numpy as np

    b = p["elements"]
    w_bound, w_by = bound_ms(p["candidates"] * row_bytes + b * c * row_bytes,
                             2.0 * op_width * (p["candidates"] + b * c * c),
                             rate)
    return {"name": name, "ms": float(np.mean(p["ms"])),
            "ms_max": float(np.max(p["ms"])), "cuda_kernels": p["kernels"],
            "kernel_ms_profiled": p["kernel_ms"], "calls": p["calls"],
            "elements_profiled": b, "bound_ms": w_bound, "bound_by": w_by,
            "top_kernels_ms": p["top_ms"]}


def relation_phase(rel, qs, k, floors, ivf_floor, smi):
    """Phase 10: the SQL-facing surface on the main path's Relation (the
    churned table and its live HNSW index), as a pgvector user drives it:
    CREATE INDEX of IVFFlat and btree, EXPLAIN, the calibrated planner,
    ORDER BY ... LIMIT 10 through the exact scan (K1), HNSW (K2) and
    IVFFlat, EXPLAIN ANALYZE, btree lookups, the batching executor with a
    write amid its reads, COPY in and out through the native codec, and a
    replica rebuilt from a base checkpoint and the replication log.
    Returns the phase's launches."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from torch_parity import assert_same_topk
    from pgvector_tpu_torch import (DenseTable, FlatIndex, Metric, Relation,
                                    config, native)
    from pgvector_tpu_torch.io import checkpoint as ck
    from pgvector_tpu_torch.io import copy as pcopy
    from pgvector_tpu_torch.io.replication import ReplicationLog, apply_deltas
    from pgvector_tpu_torch.ops.fused_topk import fused_topk
    from pgvector_tpu_torch.ops.hop_tail import hop_tail
    from pgvector_tpu_torch.ops.packed_hop import packed_hop
    from pgvector_tpu_torch.planner import calibrate, choose_path
    from pgvector_tpu_torch.runtime import BatchingExecutor
    from pgvector_tpu_torch.utils.telemetry import (
        hnsw_hbm_bytes, ivfflat_hbm_bytes, table_hbm_bytes)

    t_phase = time.perf_counter()
    table, hnsw = rel.table, rel.indexes[0]
    dev, nq, d = table.device, len(qs), table.dim
    rng = np.random.default_rng(10)
    check(native.available(), "the native codec built")
    out = {"phase": "relation", "nvidia_smi": smi, "n": table.count,
           "queries": nq, "k": k}
    fused_topk.launches = packed_hop.launches = hop_tail.launches = 0
    hops = [0]  # layer-0 hops of every HNSW search of the phase

    def count_hops(index):
        """Add each search's layer-0 hops to ``hops`` (the executor's
        batches run on its own thread, the calibration's inside it)."""
        search = index.search

        def counted(*a, **kw):
            r = search(*a, **kw)
            hops[0] += scan_launches(index)
            return r
        index.search = counted

    def hnsw_call(fn):
        """Run ``fn`` (searches of phase 4's graph) and check that each of
        their layer-0 hops was one K2 launch."""
        l0, h0 = packed_hop.launches, hops[0]
        res = fn()
        check(packed_hop.launches - l0 == hops[0] - h0,
              f"K2 launched {packed_hop.launches - l0} times for "
              f"{hops[0] - h0} hops")
        return res

    count_hops(hnsw)

    def recall_of(r, gt):
        return sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
                   for a, b in zip(r, gt)) / max(int((gt >= 0).sum()), 1)

    def timed(fn, reps=3):
        """The first run's result and every run's seconds (the searches
        return numpy arrays, so each ends in a device sync)."""
        res, secs = None, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            secs.append(time.perf_counter() - t0)
            res = r if res is None else res
        return res, secs

    # ---- 10.1 indexes and the planner -----------------------------------
    t0 = time.perf_counter()
    ivf = rel.create_index("ivfflat", Metric.L2, lists=1000, seed=1)
    torch.cuda.synchronize()
    ivf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bt = rel.create_index("btree")
    btree_s = time.perf_counter() - t0
    plan = rel.explain(Metric.L2)
    tuple_pick = choose_path(table, rel.indexes, Metric.L2)
    first = plan.splitlines()[0]
    check(tuple_pick.index is not None and "<-- chosen" in plan
          and first.startswith("Seq Scan") and "chosen" not in first,
          f"the tuple model picks an index at {table.count} rows:\n{plan}")
    t0 = time.perf_counter()
    with config.local(**{"hnsw.ef_search": 40, "ivfflat.probes": 10}):
        cal = hnsw_call(lambda: calibrate(table, rel.indexes, Metric.L2, qs,
                                          k=k, sizes=(32, 256)))
        cal_pick = choose_path(table, rel.indexes, Metric.L2,
                               calibration=cal, q_count=nq)
        # the reference's fit, through the probe sizes alone (the port's
        # also times all the queries it is given): printed, not used
        probe = calibrate(table, rel.indexes, Metric.L2, qs[:256], k=k,
                          sizes=(32, 256))
        probe_pick = choose_path(table, rel.indexes, Metric.L2,
                                 calibration=probe, q_count=nq)
    calibrate_s = time.perf_counter() - t0
    names = {id(hnsw): "hnsw", id(ivf): "ivfflat", "exact": "exact"}
    constants = {names[key]: {"fixed_s": c[0], "per_query_s": c[1],
                              "predicted_s": cal.predict(key, nq),
                              "probe_fit_predicted_s":
                                  probe.predict(key, nq)}
                 for key, c in cal.constants.items()}

    # ---- 10.2 knn through each path --------------------------------------
    flat = FlatIndex(table, Metric.L2)
    k1_before = fused_topk.launches
    gt_d, gt = flat.search(qs, k)
    check(flat.last_path == "fused" and fused_topk.launches > k1_before,
          "the ground truth went through K1")
    paths = {}
    k1_before = fused_topk.launches
    (ed, ei), secs = timed(lambda: rel.knn(qs, k, use_index=False))
    check(fused_topk.launches > k1_before, "knn(use_index=False) launched K1")
    check(np.array_equal(ei, gt) and np.array_equal(ed, gt_d),
          "knn(use_index=False) equals K1's ground truth")
    paths["exact"] = {"s": secs, "qps": nq / min(secs),
                      "k1_launches": fused_topk.launches - k1_before}
    check(choose_path(table, rel.indexes, Metric.L2, ef_search=40).index
          is hnsw, "the planner picks HNSW at ef 40")
    (hd, hi), secs = timed(lambda: hnsw_call(
        lambda: rel.knn(qs, k, ef_search=40)))
    rec = recall_of(hi, gt)
    check(hi.shape == (nq, k) and np.isfinite(hd).all(), "finite HNSW results")
    check(rec >= floors[40], f"HNSW recall@10 {rec} >= {floors[40]} at ef 40")
    paths["hnsw"] = {"ef": 40, "s": secs, "qps": nq / min(secs),
                     "recall_at_10": rec, "floor": floors[40],
                     "layer0_hops": hnsw._last_scan_steps}
    only_ivf = Relation(table)  # the same table with the IVF path alone
    only_ivf.indexes = [ivf]
    check(choose_path(table, only_ivf.indexes, Metric.L2, probes=10).index
          is ivf, "the planner picks IVFFlat when it is the index")
    (vd, vi), secs = timed(lambda: only_ivf.knn(qs, k, probes=10))
    rec = recall_of(vi, gt)
    check(vi.shape == (nq, k) and np.isfinite(vd).all(), "finite IVF results")
    check(rec >= ivf_floor, f"IVF recall@10 {rec} >= {ivf_floor} at probes 10")
    paths["ivfflat"] = {"probes": 10, "s": secs, "qps": nq / min(secs),
                        "recall_at_10": rec, "floor": ivf_floor,
                        "route": ivf.last_path}
    analyze = hnsw_call(lambda: rel.explain(Metric.L2, analyze=True,
                                            q=qs[0], k=k, ef_search=40))
    check("Index Searches: 1" in analyze and f"Rows Returned: {k}" in analyze,
          f"EXPLAIN ANALYZE:\n{analyze}")
    best = {p: min(v["s"]) for p, v in paths.items()}
    spread = max(max(v["s"]) / min(v["s"]) for v in paths.values())
    fastest = min(best, key=best.get)
    out.update(ivf_build_s=ivf_s, btree_build_s=btree_s, explain=plan,
               tuple_pick=tuple_pick.kind, calibrate_s=calibrate_s,
               calibration=constants, calibrated_pick=cal_pick.kind,
               probe_fit_pick=probe_pick.kind,
               fastest=fastest, spread=spread, paths=paths,
               explain_analyze=analyze)

    # ---- 10.3 btree ------------------------------------------------------
    live = np.flatnonzero(table.valid[: table.count].cpu().numpy())
    host = table.data[: table.count].cpu().numpy()
    pick = rng.choice(live, 1000, replace=False)
    t0 = time.perf_counter()
    found = [bt.search_eq(host[r]) for r in pick]
    eq_s = time.perf_counter() - t0
    for r, got in zip(pick, found):
        check(r in got and (host[got] == host[r]).all(),
              f"search_eq finds row {r} and only rows equal to it")
    order = np.argsort(host[live, 0], kind="stable")
    lo_row = live[order[len(order) * 2 // 5]]
    hi_row = live[order[len(order) * 3 // 5]]

    def cmp(x, v):
        """Each row of x against v in the element-by-element order."""
        ne = x != v
        j = np.argmax(ne, axis=1)
        return np.where(ne.any(axis=1),
                        np.sign(x[np.arange(len(x)), j] - v[j]), 0)

    t0 = time.perf_counter()
    rows = bt.search_range(host[lo_row], host[hi_row])
    range_s = time.perf_counter() - t0
    xs = host[live]
    want = live[(cmp(xs, host[lo_row]) >= 0) & (cmp(xs, host[hi_row]) <= 0)]
    check(len(rows) == len(want) and np.array_equal(np.sort(rows), want),
          f"search_range returned {len(rows)} rows, numpy {len(want)}")
    out["btree"] = {"build_s": btree_s, "eq_lookups": len(pick),
                    "eq_s": eq_s, "range_rows": int(len(rows)),
                    "range_s": range_s}
    del xs, want

    # ---- 10.4 the batching executor ---------------------------------------
    new_vecs = (host[rng.choice(live, 1000, replace=False)]
                + rng.normal(0, 0.01, (1000, d)).astype(np.float32))
    pre_d, pre_i = hnsw_call(lambda: hnsw.search(qs, k, ef_search=40))
    ex = BatchingExecutor(hnsw, max_batch=256, max_wait_ms=2, ef_search=40)
    lock = threading.Lock()
    seq, lat, res, counter, done, errors = {}, {}, {}, [0], [0], []

    def client(c):
        """One client: its queries one at a time, each awaited."""
        try:
            for j in range(c, nq, 8):
                t0 = time.perf_counter()
                with lock:  # the queue order, recorded as it is made
                    fut = ex.submit(qs[j], k)
                    seq[j] = counter[0]
                    counter[0] += 1
                res[j] = fut.result(timeout=120)
                lat[j] = time.perf_counter() - t0
                with lock:
                    done[0] += 1
        except Exception as exc:  # raised by the check below
            errors.append(exc)

    clients = [threading.Thread(target=client, args=(c,)) for c in range(8)]
    l0, h0 = packed_hop.launches, hops[0]
    t0 = time.perf_counter()
    try:
        for th in clients:
            th.start()
        while True:  # the write, once half the reads are answered
            with lock:
                if done[0] >= nq // 2 or errors:
                    w_seq = counter[0]
                    wfut = ex.submit_write(lambda ix: rel.insert(new_vecs))
                    counter[0] += 1
                    break
            time.sleep(0.001)
        new_rows = wfut.result(timeout=600)
        for th in clients:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        ex.shutdown()
    check(not errors, f"executor clients failed: {errors[:1]}")
    check(packed_hop.launches - l0 == hops[0] - h0,
          f"the executor's batches: {packed_hop.launches - l0} K2 launches "
          f"for {hops[0] - h0} hops")
    check(not ex._thread.is_alive()
          and not any(th.is_alive() for th in clients),
          "the executor and its clients stopped")
    post_d, post_i = hnsw_call(lambda: hnsw.search(qs, k, ef_search=40))
    pre = np.array(sorted(j for j in res if seq[j] < w_seq))
    post = np.array(sorted(j for j in res if seq[j] > w_seq))
    check(len(pre) + len(post) == nq and len(pre) and len(post),
          f"{len(pre)} reads before the write, {len(post)} after")
    for js, (rd, ri) in ((pre, (pre_d, pre_i)), (post, (post_d, post_i))):
        assert_same_topk(rd[js], ri[js], np.stack([res[j][0] for j in js]),
                         np.stack([res[j][1] for j in js]))
    lat_ms = np.array([lat[j] for j in range(nq)]) * 1e3
    out["executor"] = {
        "clients": 8, "max_batch": 256, "max_wait_ms": 2, "ef": 40,
        "reads_before_write": int(len(pre)),
        "reads_after_write": int(len(post)), "inserted": int(len(new_rows)),
        "wall_s": wall, "qps": nq / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99))}

    # ---- 10.5 COPY and replication ----------------------------------------
    tmp = tempfile.mkdtemp(prefix="pgvt_smoke_")
    try:
        t0 = time.perf_counter()
        ck.save_table(table, tmp + "/t")
        ck.save_hnsw(hnsw, tmp + "/h")
        ck.save_ivfflat(ivf, tmp + "/i")
        base_s = time.perf_counter() - t0
        rel.replication_log = ReplicationLog(tmp + "/log")
        src = DenseTable(d, device=dev)
        src.insert(host[rng.choice(live, 1000, replace=False)]
                   + rng.normal(0, 0.01, (1000, d)).astype(np.float32))
        t0 = time.perf_counter()
        ins = pcopy.copy_in_binary(rel, pcopy.copy_out_binary(src))
        torch.cuda.synchronize()
        dml = {"copy_insert_s": time.perf_counter() - t0}
        live = np.flatnonzero(table.valid[: table.count].cpu().numpy())
        t0 = time.perf_counter()
        rel.delete(rng.choice(live, 1000, replace=False))
        dml["delete_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rel.vacuum()
        torch.cuda.synchronize()
        dml["vacuum_s"] = time.perf_counter() - t0
        rel.replication_log = None
        t0 = time.perf_counter()
        rt = ck.load_table(tmp + "/t", device=dev)
        replica = Relation(rt)
        replica.indexes = [ck.load_hnsw(rt, tmp + "/h"),
                           ck.load_ivfflat(rt, tmp + "/i")]
        rbt = replica.create_index("btree")
        rh, ri = replica.indexes[:2]
        count_hops(rh)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        applied = apply_deltas(rt, replica.indexes, tmp + "/log")
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        check(applied == 3, f"the log holds 3 records ({applied})")
        n_rows, n_el = table.count, hnsw.n_elems
        check(rt.count == n_rows
              and torch.equal(rt.data[:n_rows], table.data[:n_rows])
              and torch.equal(rt.valid[:n_rows], table.valid[:n_rows]),
              "the replica's table equals the primary's")
        check(rh.n_elems == n_el
              and torch.equal(rh.nbr0[:n_el], hnsw.nbr0[:n_el]),
              "the replica's nbr0 equals the primary's")
        check(rbt._rows == bt._rows, "the replica's btree equals the "
              "primary's")
        pd_, pi_ = hnsw_call(lambda: rel.knn(qs, k, ef_search=40))
        rd_, ri_ = hnsw_call(lambda: replica.knn(qs, k, ef_search=40))
        check(np.array_equal(pi_, ri_) and np.array_equal(pd_, rd_),
              "the replica's HNSW knn equals the primary's bit for bit")
        only_r = Relation(rt)
        only_r.indexes = [ri]
        pd_, pi_ = only_ivf.knn(qs, k, probes=10)
        rd_, ri_ = only_r.knn(qs, k, probes=10)
        check(np.array_equal(pi_, ri_) and np.array_equal(pd_, rd_),
              "the replica's IVFFlat knn equals the primary's bit for bit")
        out["replication"] = {
            "base_save_s": base_s, "records": applied,
            "copy_inserted": int(len(ins)), "deleted": 1000, **dml,
            "replica_load_s": load_s, "replay_s": replay_s,
            "table_equal": True, "nbr0_equal": True,
            "knn_equal_ef40": True, "knn_equal_probes10": True}
        del replica, only_r, rt, rh, ri, rbt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # COPY of the whole table in binary, and of 100,000 rows in text
    live = np.flatnonzero(table.valid[: table.count].cpu().numpy())
    t0 = time.perf_counter()
    blob = pcopy.copy_out_binary(table)
    out_s = time.perf_counter() - t0
    rows_host = table.data[: table.count].cpu().numpy()[live]
    check(blob[17:] == native.encode_binary(rows_host),
          "copy_out_binary's rows are native.encode_binary's bytes")
    back = DenseTable(d, capacity=len(live), device=dev)
    t0 = time.perf_counter()
    pcopy.copy_in_binary(back, blob)
    torch.cuda.synchronize()
    in_s = time.perf_counter() - t0
    check(back.count == len(live) and torch.equal(
        back.data[: back.count],
        table.data[torch.as_tensor(live, device=dev)]),
        "the binary round trip gives the live rows back")
    del back
    n_text = min(100_000, len(live))
    part = DenseTable(d, capacity=n_text, device=dev)
    part.insert(rows_host[:n_text])
    t0 = time.perf_counter()
    lines = pcopy.copy_out_text(part)
    tout_s = time.perf_counter() - t0
    text_bytes = sum(len(l) + 1 for l in lines)
    again = DenseTable(d, capacity=n_text, device=dev)
    t0 = time.perf_counter()
    pcopy.copy_in_text(again, lines)
    torch.cuda.synchronize()
    tin_s = time.perf_counter() - t0
    check(torch.equal(again.data[:n_text], part.data[:n_text]),
          "the text round trip gives the rows back bit for bit")
    out["copy"] = {
        "native": native.available(), "binary_rows": int(len(live)),
        "binary_bytes": len(blob), "binary_out_s": out_s,
        "binary_in_s": in_s, "binary_out_mb_s": len(blob) / out_s / 1e6,
        "binary_in_mb_s": len(blob) / in_s / 1e6, "text_rows": n_text,
        "text_bytes": text_bytes, "text_out_s": tout_s, "text_in_s": tin_s,
        "text_out_mb_s": text_bytes / tout_s / 1e6,
        "text_in_mb_s": text_bytes / tin_s / 1e6}
    del blob, lines, part, again, rows_host, host

    # ---- 10.6 device-memory accounting -------------------------------------
    tb = table_hbm_bytes(table)
    check(tb == table.capacity * (d * 4 + 1) and tb >= table.count * d * 4,
          f"table bytes {tb} for {table.count} rows of {d} f32")
    out["hbm"] = {"table": tb, "hnsw": hnsw_hbm_bytes(hnsw),
                  "hnsw_with_slab": hnsw_hbm_bytes(hnsw, slab=True),
                  "ivfflat": ivfflat_hbm_bytes(ivf),
                  "memory_allocated": torch.cuda.memory_allocated(),
                  "table_rows": table.count,
                  "table_capacity": table.capacity}
    launches = {"fused_topk": fused_topk.launches,
                "packed_hop": packed_hop.launches,
                "hop_tail": hop_tail.launches}
    del hnsw.search  # the counting wrapper
    check(launches["fused_topk"] > 0 and launches["packed_hop"] == hops[0],
          f"K1 launched, and K2 once a layer-0 hop ({hops[0]}), in phase "
          f"10: {launches}")
    out.update(launches=launches, layer0_hops=hops[0],
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    # last, once the numbers that explain it are out: the calibrated pick
    check(best[cal_pick.kind] <= best[fastest] * spread,
          f"the calibrated pick {cal_pick.kind} ({best[cal_pick.kind]} s) "
          f"is within the timed runs' spread {spread} of the fastest, "
          f"{fastest} ({best[fastest]} s)")
    return launches


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="table rows (default: the bench's 1M)")
    ap.add_argument("--queries", type=int, default=8000)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one search at ef 40 and 100 with "
                    "torch.profiler (kernel time by name, busy share)")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))
    import numpy as np

    from bench import make_data
    from torch_parity import ATOL, RTOL, assert_same_pool, assert_same_topk
    from pgvector_tpu_torch import DenseTable, FlatIndex, Metric, Relation
    from pgvector_tpu_torch.ops import _cuda
    from pgvector_tpu_torch.ops.fused_topk import (
        fused_topk, fused_topk_plain, k1_error_bound, k1_l2_error_bound,
        l2_root_bound)
    from pgvector_tpu_torch.index import hnsw_kernels
    from pgvector_tpu_torch.ops.hop_tail import hop_tail, hop_tail_plain
    from pgvector_tpu_torch.ops.gather_hop import hop_buffers
    from pgvector_tpu_torch.ops.greedy_walk import greedy_walk
    from pgvector_tpu_torch.ops.packed_hop import packed_hop, packed_hop_plain
    from pgvector_tpu_torch.ops.select_neighbors import Gram
    from pgvector_tpu_torch.tools.k7_walk import walk_vs_plain
    from pgvector_tpu_torch.utils.telemetry import timers

    dev = torch.device("cuda", 0)
    smi = smi_line()

    # ---- 1. device and kernel build -------------------------------------
    t0 = time.perf_counter()
    _cuda.lib()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": round(time.perf_counter() - t0, 3),
          "nvcc_s": _cuda.build_seconds, "library": str(_cuda.LIB_PATH)})

    t0 = time.perf_counter()
    db, qs = make_data(args.n, args.queries, seed=0)
    table = DenseTable(128, capacity=args.n, device=dev)
    table.insert(db)
    qs_dev = torch.as_tensor(qs, device=dev)
    data_s = time.perf_counter() - t0

    # ---- 2. K1 against its plain version ---------------------------------
    # First at the main path's own launch: all queries × the table, k = 10,
    # L2 (the ground truth of phase 4); then k = 64, inner product and
    # 1,000 queries, whose grids and merges differ.
    k1 = []
    data = table.data[: table.count]
    sq = torch.sum(data * data, dim=1)
    for nq in (args.queries, 1000):
        qk = qs_dev[:nq].contiguous()
        for metric in ("L2", "IP"):
            dbsq = sq if metric == "L2" else torch.zeros_like(sq)
            for k in (10, 64):
                d1, i1 = fused_topk(qk, data, dbsq, k)
                d0, i0 = fused_topk_plain(qk, data, dbsq, k)
                bound = k1_error_bound(qk, data, dbsq, i0, i1).cpu().numpy()
                torch.cuda.synchronize()
                d0, i0, d1, i1 = (t.cpu().numpy() for t in (d0, i0, d1, i1))
                # K1's derived error bound per entry (ops/fused_topk.py),
                # which also decides which ids tie
                assert_same_topk(d0, i0, d1, i1, atol=bound, rtol=0.0)
                fin = np.isfinite(d0)
                err = np.abs(d1[fin] - d0[fin])
                k1.append({
                    "queries": nq, "metric": metric, "k": k,
                    "max_abs_err": float(err.max()),
                    "max_err_over_bound": float((err / bound[fin]).max()),
                    "bound_at_max_err": float(bound[fin][np.argmax(err)]),
                    "ids_equal_frac": float((i0 == i1).mean()),
                    "ms": cuda_ms(lambda: fused_topk(qk, data, dbsq, k)),
                    "plain_ms": cuda_ms(
                        lambda: fused_topk_plain(qk, data, dbsq, k))})
    # queries equal to stored rows (the near-duplicate lookup): FlatIndex's
    # L2 distances on the K1 route against the plain version's on the same
    # queries, within the root bound carried from K1's (an L2 distance near
    # zero moves by up to sqrt(E) for a squared bound E)
    self_rows = torch.arange(0, table.count, max(table.count // 1000, 1),
                             device=dev)[:1000]
    q_self = data[self_rows].contiguous()
    flat_self = FlatIndex(table, Metric.L2, tile=16384)
    ds, is_ = flat_self.search(q_self, 10)
    check(flat_self.last_path == "fused", "the self-match search took K1")
    pd_s, pi_s = fused_topk_plain(q_self, data, sq, 10)
    pd_s = torch.sqrt(torch.clamp(
        pd_s + torch.sum(q_self * q_self, dim=1, keepdim=True), min=0.0))
    e_s = k1_l2_error_bound(q_self, data, pi_s,
                            torch.as_tensor(is_, device=dev))
    atol_s = l2_root_bound(e_s, pd_s).cpu().numpy()
    pd_s, pi_s = pd_s.cpu().numpy(), pi_s.cpu().numpy()
    assert_same_topk(pd_s, pi_s, ds, is_, atol=atol_s, rtol=0.0)
    check((pi_s[:, 0] == self_rows.cpu().numpy()).all(),
          "each stored row is its own nearest")
    err_s = np.abs(ds - pd_s)
    j_s = int(np.argmax(err_s[:, 0]))
    self_match = {
        "queries": len(q_self), "k": 10,
        "max_abs_err_self": float(err_s[:, 0].max()),
        "bound_at_max_self": float(atol_s[j_s, 0]),
        "max_err_over_bound_self": float((err_s[:, 0] / atol_s[:, 0]).max()),
        "max_err_over_bound_all": float((err_s / atol_s).max()),
        "tolerance": "l2_root_bound(k1_l2_error_bound) "
                     "(ops/fused_topk.py)"}
    del flat_self, q_self, e_s
    # the library yardstick: the cuBLAS f32 product alone (TF32 off), which
    # the port never calls; beside K1's 1,000-query time
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    q_lib = qs_dev[:1000].contiguous()
    k1_lib_ms = cuda_ms(lambda: torch.mm(q_lib, data.T))
    n0 = table.count

    def k1_bound_of(nq):  # the queries and rows read once, the k-lists out
        return bound_ms(4 * (nq * 128 + n0 * 129) + 8 * nq * 10,
                        3 * 2.0 * nq * n0 * 128, TF32_FLOPS)

    k1_bound, k1_by = k1_bound_of(args.queries)
    k1_bound_1000, _ = k1_bound_of(1000)
    # K1's share of its bound at the L2 k = 10 cases of both query counts
    k1_share = {str(c["queries"]): (k1_bound if c["queries"] == args.queries
                                    else k1_bound_1000) / c["ms"]
                for c in k1 if c["metric"] == "L2" and c["k"] == 10}
    emit({"phase": "k1_vs_plain", "rows": table.count,
          "tolerance": "k1_error_bound (ops/fused_topk.py)", "cases": k1,
          "self_match": self_match,
          "library_ms_1000q": k1_lib_ms,
          "bound_ms": k1_bound, "bound_by": k1_by,
          "bound_ms_1000q": k1_bound_1000, "bound_share": k1_share,
          "bound_f32_cores_ms": 2.0 * args.queries * n0 * 128 / F32_FLOPS
          * 1e3})

    # ---- 3. K2 against its plain version: Q = 8,000, W = 256 ------------
    k2_tail = []
    g = torch.Generator(device="cpu").manual_seed(0)
    q2, w = 8000, 256
    for ef in (24, 40, 64, 100):
        pool_d = torch.sort(torch.rand((q2, ef), generator=g), dim=1).values
        pool_i = torch.randint(0, 1 << 30, (q2, ef), generator=g,
                               dtype=torch.int32)
        pool_x = torch.rand((q2, ef), generator=g) > 0.5
        pool_i[::9, ef // 2:] = -1
        pool_d[::9, ef // 2:] = torch.inf
        pool_x[::9, ef // 2:] = False
        cand_i = torch.randint(0, 1 << 30, (q2, w), generator=g,
                               dtype=torch.int32)
        cand_d = torch.rand((q2, w), generator=g)
        cand_i[:, 3], cand_d[:, 3] = pool_i[:, 0], pool_d[:, 0]
        cand_i[:, 5], cand_d[:, 5] = cand_i[:, 4], cand_d[:, 4]
        cand_i[:, 7::16], cand_d[:, 7::16] = -1, torch.inf
        hop = [t.to(dev).contiguous() for t in (
            pool_d, pool_i * 2 + pool_x.to(torch.int32), cand_d, cand_i)]
        d1, p1 = hop_tail(*hop, ef, w)
        d0, p0 = hop_tail_plain(*hop, ef, w)
        torch.cuda.synchronize()
        check(torch.equal(p1, p0) and torch.equal(d1, d0),
              f"hop_tail kernel equals its plain version at ef={ef}")
        fin = torch.isfinite(d0)
        k2_tail.append({"ef": ef, "w": w, "equal": True,
                   "max_abs_err": float((d1 - d0)[fin].abs().max()),
                   "ms": cuda_ms(lambda: hop_tail(*hop, ef, w)),
                   "plain_ms": cuda_ms(lambda: hop_tail_plain(*hop, ef, w))})
    emit({"phase": "hop_tail_vs_plain", "queries": q2, "cases": k2_tail})

    # ---- 4. the main path -------------------------------------------------
    bk = BuildKernels()  # K3 and K6 counted (and captured) from here on
    fused_topk.launches = 0
    packed_hop.launches = 0
    packed_hop.launches_by_slab = dict.fromkeys(packed_hop.launches_by_slab, 0)
    packed_hop.launches_by_path = dict.fromkeys(packed_hop.launches_by_path, 0)
    hop_tail.launches = 0
    torch.cuda.reset_peak_memory_stats()
    k = 10
    flat = FlatIndex(table, Metric.L2, tile=16384)
    t0 = time.perf_counter()
    gt_d, gt = flat.search(qs, k)
    gt_s = time.perf_counter() - t0
    check(flat.last_path == "fused" and fused_topk.launches > 0,
          "the ground truth went through K1")
    # the ground truth itself against K1's plain version, with FlatIndex's
    # L2 transform, on the same queries
    pd, pi = fused_topk_plain(qs_dev, data, sq, k)
    b = k1_error_bound(qs_dev, data, sq, pi,
                       torch.as_tensor(gt, device=dev))
    pd = torch.clamp(pd + torch.sum(qs_dev * qs_dev, dim=1, keepdim=True),
                     min=0.0)
    # the bound on squared distances, carried through the square root
    b_user = torch.sqrt(pd + b) - torch.sqrt(torch.clamp(pd - b, min=0.0))
    assert_same_topk(torch.sqrt(pd).cpu().numpy(), pi.cpu().numpy(), gt_d, gt,
                     atol=b_user.cpu().numpy() + ATOL, rtol=RTOL)

    cap = 1
    while cap < args.n:
        cap *= 2
    # the build: its middle wave through torch.profiler (every other wave
    # timed alone), the wave after it captured for K3's and K6's checks,
    # and each wave's search and connect ended by a device sync, so the
    # host timers split the build as the device does
    timers.reset()
    timers.enabled = True
    os.environ["PGVECTOR_TPU_PHASE_SYNC"] = "1"
    t0 = time.perf_counter()
    rel = Relation(table)  # CREATE INDEX ... USING hnsw (phase 10 adds more)
    idx = rel.create_index("hnsw", Metric.L2, m=16, ef_construction=64,
                           wave_size=1024, beam_expand=4, capacity=cap,
                           build=False)
    wave4 = _profiled_waves(idx, hnsw_kernels.search_layer)
    cap4 = {"select": {}, "hops": {}, "beam": -1, "hop": 0}

    def capture(kind, a):
        if wave4["calls"] != wave4["middle"] + 1:
            return
        if kind == "select":  # the first select of each shape
            key = (tuple(a[1].ip.shape), a[3], a[4] is not None)
            cap4["select"].setdefault(key, [
                t.clone() if torch.is_tensor(t) else
                Gram(t.ip.clone(), t.sq.clone(), t.l2)
                if isinstance(t, Gram) else t for t in a])
        elif kind == "beam":
            cap4["beam"] += 1
            cap4["hop"] = 0
        else:  # hops 0, 4 and 12 of every beam; level 0's is the last
            if cap4["hop"] in (0, 4, 12):
                cap4["hops"][(cap4["beam"], cap4["hop"])] = keep_state(*a)
            cap4["hop"] += 1

    bk.capture = capture
    try:
        idx.build()
    finally:
        bk.capture = None
        del idx._insert_wave
        os.environ.pop("PGVECTOR_TPU_PHASE_SYNC")
    build_s = time.perf_counter() - t0
    timers.enabled = False
    build4 = bk.read("4", all_dense=True)
    check(build4["select_neighbors"] > 0 and build4["gather_hop"] > 0,
          "the build launched K3 and K6")
    idx.beam_expand = 8  # query-side beam, as bench.py:518
    plan = idx._packed_plan()
    f32_copy = idx.cap_e * 2 * idx.m * 128 * 4
    total = torch.cuda.get_device_properties(dev).total_memory
    check(plan == (torch.float32 if f32_copy <= total // 8
                   else torch.bfloat16), f"packed plan {plan}")
    check(args.n != 1_000_000 or plan == torch.bfloat16,
          f"the 1M packed plan is bf16, not {plan}")
    sweep = []
    floors = {40: 0.94, 100: 0.985}  # the reference: 0.9583 and 0.9947
    hops = 0  # layer-0 hops of every search below, warm-ups included
    walks = greedy_walk.launches
    for ef in (40, 100):
        idx.search(qs, k, ef_search=ef)  # warm-up: builds the slab cache
        torch.cuda.synchronize()
        hops += scan_launches(idx)
        t0 = time.perf_counter()
        dist, r = idx.search(qs, k, ef_search=ef)
        dt = time.perf_counter() - t0
        hops += scan_launches(idx)
        check(r.shape == (len(qs), k) and np.isfinite(dist).all(),
              f"finite results of shape {(len(qs), k)}, got {r.shape}")
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(r, gt))
        recall = hits / (len(qs) * k)
        sweep.append({"ef": ef, "recall_at_10": recall,
                      "qps": len(qs) / dt,
                      "layer0_hops": idx._last_scan_steps})
        check(recall >= floors[ef], f"recall@10 {recall} >= {floors[ef]} "
              f"at ef={ef}")
    check(greedy_walk.launches - walks == 4,
          f"each of 4 searches walked its upper levels in one K7 launch: "
          f"{greedy_walk.launches - walks} launches")
    launches = {"fused_topk": fused_topk.launches,
                "packed_hop": packed_hop.launches,
                "packed_hop_by_path": dict(packed_hop.launches_by_path),
                "hop_tail": hop_tail.launches,
                "greedy_walk": greedy_walk.launches - walks}
    check(launches["packed_hop"] == hops,
          f"every layer-0 hop went through K2: {launches['packed_hop']} "
          f"launches for {hops} hops")
    check(launches["packed_hop_by_path"]["bulk"] == hops,
          f"every K2 launch copied its slabs in bulk: "
          f"{launches['packed_hop_by_path']}")
    bk.read("4")  # the searches ran no select and no row-gather hop
    check(bk.k3.launches == build4["select_neighbors"]
          and bk.k6.launches == build4["gather_hop"],
          "the searches launched neither K3 nor K6")
    split = timers.report()
    search_s = split["hnsw.wave.search"]["total_s"]
    connect_s = split["hnsw.wave.connect"]["total_s"]
    emit({"phase": "main_path", "n": args.n, "queries": len(qs),
          "reduced": args.n != 1_000_000, "data_s": data_s,
          "exact_gt_s": gt_s, "build_s": build_s,
          "build_phases": {k: v["total_s"] for k, v in split.items()},
          "build_split": {"search_s": search_s, "connect_s": connect_s,
                          "search_share": search_s / build_s,
                          "connect_share": connect_s / build_s,
                          "synchronized": "PGVECTOR_TPU_PHASE_SYNC=1"},
          "build_wave": _wave_row("dense build wave", wave4, 128 * 4, 128,
                                  F32_FLOPS, 64 + 16),
          "build_kernels": build4,
          "packed": str(plan).replace("torch.", ""), "sweep": sweep,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "layer0_hops": hops})

    # ---- 5. K2 against its plain version on hop states of the 1M graph ---
    # the inputs of hops 0, 4 and 12 of one search at ef 40 and at ef 100,
    # each the whole hop from the pool and the search's done flags and hop
    # counts so far
    states = {}
    calls = []

    def record(*a, **kw):
        if len(calls) in (0, 4, 12):
            states[(ef, len(calls))] = keep_state(a, kw)
        calls.append(1)
        return packed_hop(*a, **kw)

    hnsw_kernels.packed_hop = record
    try:
        for ef in (40, 100):
            calls.clear()
            idx.search(qs, k, ef_search=ef)
    finally:
        hnsw_kernels.packed_hop = packed_hop
    check(len(states) == 6, f"captured hops {sorted(states)}")
    k2 = []
    for (ef, hop), (a, kw) in sorted(states.items()):
        err = same_hop(packed_hop(*a, **kw), packed_hop_plain(*a, **kw),
                       f"K2 at ef {ef}, hop {hop}")
        k2.append({"ef": ef, "hop": hop, "max_abs_err": err})
    # timed at the main path's shapes, hop 4 of ef 40 and of ef 100 (Q =
    # 8,000, E = 8): the kernel through output buffers made once, as a
    # search makes them, alone by torch.profiler, beside its plain version
    # and torch.index_select of the same slabs (the library's rate for
    # them, read and written)
    k2_timed = {}
    for ef in (40, 100):
        a, kw = states[(ef, 4)]
        wk = k2_work(a, kw)
        live = wk.pop("live")
        bufs = hop_buffers(wk["queries"], ef, dev)
        slabs = a[3].view(a[3].shape[0], -1)
        gathered = torch.empty((len(live), slabs.shape[1]),
                               dtype=slabs.dtype, device=dev)
        k2_timed[ef] = dict(
            wk, ef=ef, hop=4, slab=str(a[3].dtype),
            ms=cuda_ms(lambda: packed_hop(*a, **kw, out=bufs)),
            kernel_only_ms=kernel_only_ms(
                lambda: packed_hop(*a, **kw, out=bufs))[0],
            plain_ms=cuda_ms(lambda: packed_hop_plain(*a, **kw)),
            index_select_ms=kernel_only_ms(
                lambda: torch.index_select(slabs, 0, live, out=gathered))[0])
    main_k2 = k2_timed[100]
    emit({"phase": "packed_hop_vs_plain", "atol": ATOL, "rtol": RTOL,
          "cases": k2, "timed": list(k2_timed.values()),
          "launches_by_path": dict(packed_hop.launches_by_path)})
    w_tail = 256
    tail_bound, tail_by = bound_ms(8 * q2 * (2 * 100 + w_tail))

    # ---- 5b. K3 and K6 against their plain versions on the build's inputs
    # (the selects and beam hops of the wave after the profiled one), and
    # K3 on pools of ef_construction 1,000 searched on the built graph
    # (C = 1,000 + 16, past the shared-memory route)
    k3_rows, k6_rows = select_vs_plain(idx, cap4["select"], dev), \
        gather_hop_vs_plain(cap4["hops"])
    # K7 on the 1M graph's upper levels, from the search's starts
    walk4 = walk_vs_plain(idx, qs)
    emit({"phase": "greedy_walk_vs_plain", "atol": ATOL, "rtol": RTOL,
          **walk4})
    emit({"phase": "select_vs_plain", "tolerance": "bit for bit",
          "cases": k3_rows})
    emit({"phase": "gather_hop_vs_plain", "atol": ATOL, "rtol": RTOL,
          "cases": k6_rows})
    cap4.clear()
    if args.profile:
        for ef in (40, 100):
            emit(profile_search(idx, qs, k, ef))

    # ---- 6. IVFFlat on the same table -------------------------------------
    # release the HNSW slab cache first, as bench.py:615 does
    idx._nbr_vals = None
    torch.cuda.empty_cache()
    ivf_phase(table, qs, gt_d, gt, k, smi)

    # ---- 7. the HNSW index as a live index (it changes the table) --------
    recall4 = {s["ef"]: s["recall_at_10"] for s in sweep}
    bk.reset()
    live_phase(idx, table, qs, k, recall4, smi)
    build_by_phase = {"4": build4, "7": bk.read("7")}

    # ---- 10. the SQL-facing surface on phase 4's Relation ----------------
    # after the churn, on the live index: phase 7's floors (0.02 under
    # phase 4's recall) and phase 6's at probes 10 (the 1M lane's)
    bk.reset()
    launches10 = relation_phase(
        rel, qs, k, {ef: r - 0.02 for ef, r in recall4.items()},
        0.99 if args.n == 1_000_000 else 0.0, smi)
    build_by_phase["10"] = bk.read("10")

    # ---- 8. the bit and sparse types, on tables of their own -------------
    # free phase 4's index with its slab cache (the captured hop states
    # hold it too), phase 10's indexes and the churned table first
    idx._nbr_vals = None
    del rel, idx, table, flat, data, sq, qs_dev, states, a, kw, bufs, slabs
    del gathered, pd, pi, b, b_user
    gc.collect()
    torch.cuda.empty_cache()
    bk.reset()
    bit_rows = bit_sparse_phase(db, qs, k, smi, args.n, dev)
    build_by_phase["8"] = bk.read("8")

    # ---- 9. halfvec at GIST-1M's width, on a table of its own -----------
    bk.reset()
    walk9, int8_row = halfvec_phase(smi, dev, n=min(200_000, args.n))
    build_by_phase["9"] = bk.read("9", all_dense=True)

    # ---- 11. the mesh paths: four shards of the card ---------------------
    bk.reset()
    launches11 = mesh_phase(db, qs, smi, dev, k,
                            n_hnsw=min(200_000, args.n),
                            n_build=min(50_000, args.n))
    build_by_phase["11"] = bk.read("11")
    emit({"phase": "build_kernels", "by_phase": build_by_phase})

    def by_phase(name):
        return {ph: c[name] for ph, c in build_by_phase.items()}

    k3_main = max(k3_rows, key=lambda r: r["rows"] * r["c"] ** 2
                  if r["source"] == "build" else -1)
    k6_main = next(r for r in k6_rows if r.get("timed"))

    emit({"kernels": [
        {"name": "fused_topk", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/fused_topk.cu",
         "replaces": "pgvector_tpu/ops/pallas_topk.py:95",
         "design": "redesigned for Hopper (wgmma)",
         "launches": launches["fused_topk"] + launches10["fused_topk"]
         + launches11["fused_topk"],
         "launches_by_phase": {"4": launches["fused_topk"],
                               "10": launches10["fused_topk"],
                               "11": launches11["fused_topk"]},
         "on_main_path": True,
         "max_abs_err": max(c["max_abs_err"] for c in k1),
         "ms": k1[0]["ms"], "plain_ms": k1[0]["plain_ms"],
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": k1_lib_ms, "library_queries": 1000,
         "ms_at_library_queries": k1[4]["ms"],
         "bound_ms_at_library_queries": k1_bound_1000,
         "bound_share": k1_share},
        {"name": "packed_hop", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/packed_hop.cu",
         "replaces": "pgvector_tpu/ops/pallas_hop.py:154 (hop_tail, body "
                     "_tail_kernel :98) and the packed _hop_body around it, "
                     "pgvector_tpu/index/hnsw_kernels.py:401-501",
         "launches": launches["packed_hop"] + launches10["packed_hop"]
         + launches11["packed_hop"],
         "launches_by_phase": {"4": launches["packed_hop"],
                               "10": launches10["packed_hop"],
                               "11": launches11["packed_hop"]},
         "on_main_path": True,
         "launches_by_path": launches["packed_hop_by_path"],
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         "ms": main_k2["ms"], "kernel_only_ms": main_k2["kernel_only_ms"],
         "plain_ms": main_k2["plain_ms"], "bound_ms": main_k2["bound_ms"],
         "bound_by": main_k2["bound_by"],
         "library_ms": main_k2["index_select_ms"],
         "library_call": "torch.index_select of the hop's slabs",
         "timed_shape": {"ef": 100, "hop": 4,
                         "queries": main_k2["queries"], "expand": 8}},
        {"name": "hop_tail", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/hop_tail.cu",
         "replaces": "pgvector_tpu/ops/pallas_hop.py:154",
         "launches": launches["hop_tail"] + launches10["hop_tail"],
         "on_main_path": False,
         "max_abs_err": max(c["max_abs_err"] for c in k2_tail),
         "ms": k2_tail[-1]["ms"], "plain_ms": k2_tail[-1]["plain_ms"],
         "bound_ms": tail_bound, "bound_by": tail_by, "library_ms": None},
        *bit_rows,
        int8_row,
        {"name": "select_neighbors", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/select_neighbors.cu",
         "replaces": "pgvector_tpu/index/hnsw_kernels.py:804 "
                     "(select_neighbors under select_neighbors_batch :855, "
                     "its fori_loop :844, and the dense block of "
                     "_pairwise_dists :897; an XLA program, no Pallas "
                     "kernel)",
         "launches": sum(by_phase("select_neighbors").values()),
         "launches_by_phase": by_phase("select_neighbors"),
         "on_main_path": True, "max_abs_err": 0.0,
         "equal": "bit for bit (positions and kept flags)",
         "ms": k3_main["ms"], "kernel_only_ms": k3_main["kernel_only_ms"],
         "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "bound_counts": "the block rows the keep loops reach",
         "bound_block_ms": k3_main["bound_block_ms"],
         "block_kernel_only_ms": k3_main["block_kernel_only_ms"],
         "library_ms": None,
         "timed_shape": [k3_main["rows"], k3_main["c"], k3_main["lm"]]},
        {"name": "greedy_walk", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/greedy_walk.cu",
         "replaces": "pgvector_tpu/index/hnsw_kernels.py:713 "
                     "(greedy_descent, _greedy_body :703; an XLA "
                     "while_loop, no Pallas kernel)",
         "launches_by_phase": {"4": launches["greedy_walk"], "9": 8},
         "on_main_path": True,
         "max_abs_err": max(walk4["max_abs_err"], walk9["max_abs_err"]),
         "ends_equal_share": min(walk4["ends_equal_share"],
                                 walk9["ends_equal_share"]),
         **{key: walk4[key] for key in ("ms", "kernel_only_ms", "plain_ms",
                                         "bound_ms", "bound_by")},
         "library_ms": None,
         "at_960": {key: walk9[key] for key in (
             "ms", "kernel_only_ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "gather_hop", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/gather_hop.cu",
         "replaces": "pgvector_tpu/index/hnsw_kernels.py:588 (_hop_step: "
                     "the row-gather branch of _hop_body :401 with its "
                     "E-selection and list gather, _hop_merge :554; an XLA "
                     "program, no Pallas kernel)",
         "launches": sum(by_phase("gather_hop").values()),
         "launches_by_phase": by_phase("gather_hop"),
         "on_main_path": True,
         "max_abs_err": max(r["max_abs_err"] for r in k6_rows),
         "ms": k6_main["ms"], "kernel_only_ms": k6_main["kernel_only_ms"],
         "plain_ms": k6_main["plain_ms"],
         "bound_ms": k6_main["bound_ms"], "bound_by": k6_main["bound_by"],
         "library_ms": None},
    ]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
