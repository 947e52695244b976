#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--n ROWS]

The path is the one bench.py measures for the JAX package: a 1M × 128 f32
DenseTable of bench.make_data's clustered surrogate (seed 0), the exact
L2 top-10 ground truth through FlatIndex (kernel K1, fused_topk), an HNSW
wave build (m=16, ef_construction=64, wave 1024, build beam 4, dedup
off), then the layer-0 beam search over the packed slab cache with query
beam 8 at ef 40 and 100 (kernel K2, packed_hop: one launch a hop),
recall@10 and QPS.  Before that it builds the CUDA kernels from
pgvector_tpu_torch/csrc and holds K1 and K2's tail (hop_tail) against
their plain PyTorch versions on the card; after it, K2 itself on hop
states captured from the 1M graph.  Last, the IVFFlat lane of bench.py
on the same table (lists = n / 1000, seed 1): the build split into its
phases, recall@10 and QPS at probes 1, 10 and 32, exhaustive probing
against K1's ground truth, the two probe routes against each other,
batch-1 latency, and the inverted probe scan's parts with their bounds.

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
import json
import os
import subprocess
import sys
import time


#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12


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
    return {"phase": "profile", "ef": ef, "wall_s": wall,
            "kernel_s": kernel_s, "busy_share": kernel_s / wall,
            "kernel_launches": sum(c for _, _, c in kernels),
            "top_ms": [[name[:72], ms, c] for name, ms, c in kernels[:top]]}


def profile_call(fn, top=6):
    """CUDA kernels one call of ``fn`` launches, their summed device
    milliseconds and the busiest ``top`` by name (torch.profiler's CUDA
    kernel events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA), key=lambda x: -x[1])
    return (sum(c for _, _, c in ev), sum(ms for _, ms, _ in ev),
            [[name[:72], ms, c] for name, ms, c in ev[:top]])


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
    from pgvector_tpu_torch import DenseTable, FlatIndex, HNSWIndex, Metric
    from pgvector_tpu_torch.ops import _cuda
    from pgvector_tpu_torch.ops.fused_topk import fused_topk, fused_topk_plain
    from pgvector_tpu_torch.index import hnsw_kernels
    from pgvector_tpu_torch.ops.hop_tail import hop_tail, hop_tail_plain
    from pgvector_tpu_torch.ops.packed_hop import packed_hop, packed_hop_plain
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
                torch.cuda.synchronize()
                d0, i0, d1, i1 = (t.cpu().numpy() for t in (d0, i0, d1, i1))
                assert_same_topk(d0, i0, d1, i1)
                fin = np.isfinite(d0)
                k1.append({
                    "queries": nq, "metric": metric, "k": k,
                    "max_abs_err": float(np.abs(d1[fin] - d0[fin]).max()),
                    "ids_equal_frac": float((i0 == i1).mean()),
                    "ms": cuda_ms(lambda: fused_topk(qk, data, dbsq, k)),
                    "plain_ms": cuda_ms(
                        lambda: fused_topk_plain(qk, data, dbsq, k))})
    # the library yardstick: the cuBLAS f32 product alone (TF32 off), which
    # the port never calls; beside K1's 1,000-query time
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    q_lib = qs_dev[:1000].contiguous()
    k1_lib_ms = cuda_ms(lambda: torch.mm(q_lib, data.T))
    nq0, n0 = args.queries, table.count
    k1_bound, k1_by = bound_ms(4 * (nq0 * 128 + n0 * 129) + 8 * nq0 * 10,
                               3 * 2.0 * nq0 * n0 * 128, TF32_FLOPS)
    emit({"phase": "k1_vs_plain", "rows": table.count,
          "atol": ATOL, "rtol": RTOL, "cases": k1,
          "library_ms_1000q": k1_lib_ms,
          "bound_ms": k1_bound, "bound_by": k1_by,
          "bound_f32_cores_ms": 2.0 * nq0 * n0 * 128 / F32_FLOPS * 1e3})

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
    fused_topk.launches = 0
    packed_hop.launches = 0
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
    pd = torch.sqrt(torch.clamp(
        pd + torch.sum(qs_dev * qs_dev, dim=1, keepdim=True), min=0.0))
    assert_same_topk(pd.cpu().numpy(), pi.cpu().numpy(), gt_d, gt)

    cap = 1
    while cap < args.n:
        cap *= 2
    timers.enabled = True  # host-clock split of the build's phases
    t0 = time.perf_counter()
    idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64,
                    wave_size=1024, dedup=False, beam_expand=4, capacity=cap)
    build_s = time.perf_counter() - t0
    timers.enabled = False
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
    for ef in (40, 100):
        idx.search(qs, k, ef_search=ef)  # warm-up: builds the slab cache
        torch.cuda.synchronize()
        hops += idx._last_scan_steps
        t0 = time.perf_counter()
        dist, r = idx.search(qs, k, ef_search=ef)
        dt = time.perf_counter() - t0
        hops += idx._last_scan_steps
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
    launches = {"fused_topk": fused_topk.launches,
                "packed_hop": packed_hop.launches,
                "hop_tail": hop_tail.launches}
    check(launches["packed_hop"] == hops,
          f"every layer-0 hop went through K2: {launches['packed_hop']} "
          f"launches for {hops} hops")
    emit({"phase": "main_path", "n": args.n, "queries": len(qs),
          "reduced": args.n != 1_000_000, "data_s": data_s,
          "exact_gt_s": gt_s, "build_s": build_s,
          "build_phases": {k: v["total_s"] for k, v in timers.report().items()},
          "packed": str(plan).replace("torch.", ""), "sweep": sweep,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches, "layer0_hops": hops})

    # ---- 5. K2 against its plain version on hop states of the 1M graph ---
    # the inputs of hops 0, 4 and 12 of one search at ef 40 and at ef 100
    states = {}
    calls = []

    def record(*a):
        if len(calls) in (0, 4, 12):
            states[(ef, len(calls))] = [
                t.clone() if torch.is_tensor(t) and t.numel() < 1 << 24
                else t for t in a]
        calls.append(1)
        return packed_hop(*a)

    hnsw_kernels.packed_hop = record
    try:
        for ef in (40, 100):
            calls.clear()
            idx.search(qs, k, ef_search=ef)
    finally:
        hnsw_kernels.packed_hop = packed_hop
    check(len(states) == 6, f"captured hops {sorted(states)}")
    k2 = []
    for (ef, hop), st in sorted(states.items()):
        d1, p1 = packed_hop(*st)
        d0, p0 = packed_hop_plain(*st)
        torch.cuda.synchronize()
        d0, p0, d1, p1 = (t.cpu().numpy() for t in (d0, p0, d1, p1))
        assert_same_pool(d0, p0, d1, p1)
        fin = np.isfinite(d0)
        k2.append({"ef": ef, "hop": hop,
                   "max_abs_err": float(np.abs(d1[fin] - d0[fin]).max()),
                   "ids_equal_frac": float(((p0 >> 1) == (p1 >> 1)).mean())})
    # timed at the main path's shapes: ef 100, hop 4 (Q = 8,000, E = 8)
    st = states[(100, 4)]
    pool_d, _, sel, nbr0, vals, qs_p, ef, _ = st
    q_rows, m2, dim = len(qs_p), nbr0.shape[1], vals.shape[2]
    live = sel[sel >= 0].long()
    cands = int((nbr0[live] >= 0).sum())
    k2_bound, k2_by = bound_ms(
        16 * q_rows * ef + 4 * sel.numel() + 4 * m2 * live.numel()
        + vals.element_size() * dim * cands + 4 * q_rows * dim,
        2.0 * cands * dim)
    k2_ms = cuda_ms(lambda: packed_hop(*st))
    k2_plain = cuda_ms(lambda: packed_hop_plain(*st))
    emit({"phase": "packed_hop_vs_plain", "queries": q_rows,
          "expand": sel.numel() // q_rows, "slab": str(vals.dtype),
          "atol": ATOL, "rtol": RTOL, "cases": k2,
          "timed": {"ef": ef, "hop": 4, "live_candidates": cands,
                    "ms": k2_ms, "plain_ms": k2_plain,
                    "bound_ms": k2_bound, "bound_by": k2_by}})
    w_tail = 256
    tail_bound, tail_by = bound_ms(8 * q2 * (2 * 100 + w_tail))
    if args.profile:
        for ef in (40, 100):
            emit(profile_search(idx, qs, k, ef))

    # ---- 6. IVFFlat on the same table -------------------------------------
    # release the HNSW slab cache first, as bench.py:615 does
    idx._nbr_vals = None
    torch.cuda.empty_cache()
    ivf_phase(table, qs, gt_d, gt, k, smi)

    emit({"kernels": [
        {"name": "fused_topk", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/fused_topk.cu",
         "replaces": "pgvector_tpu/ops/pallas_topk.py:95",
         "launches": launches["fused_topk"], "on_main_path": True,
         "max_abs_err": max(c["max_abs_err"] for c in k1),
         "ms": k1[0]["ms"], "plain_ms": k1[0]["plain_ms"],
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": k1_lib_ms, "library_queries": 1000,
         "ms_at_library_queries": k1[4]["ms"]},
        {"name": "packed_hop", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/packed_hop.cu",
         "replaces": "pgvector_tpu/ops/pallas_hop.py:154",
         "launches": launches["packed_hop"], "on_main_path": True,
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
        {"name": "hop_tail", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/hop_tail.cu",
         "replaces": "pgvector_tpu/ops/pallas_hop.py:154",
         "launches": launches["hop_tail"], "on_main_path": False,
         "max_abs_err": max(c["max_abs_err"] for c in k2_tail),
         "ms": k2_tail[-1]["ms"], "plain_ms": k2_tail[-1]["plain_ms"],
         "bound_ms": tail_bound, "bound_by": tail_by, "library_ms": None},
    ]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
