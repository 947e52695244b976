#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--n ROWS]

The path is the one bench.py measures for the JAX package: a 1M × 128 f32
DenseTable of bench.make_data's clustered surrogate (seed 0), the exact
L2 top-10 ground truth through FlatIndex (kernel K1), an HNSW wave build
(m=16, ef_construction=64, wave 1024, build beam 4, dedup off), then the
layer-0 beam search over the packed slab cache with query beam 8 at ef 40
and 100 (kernel K2), recall@10 and QPS.  Before that it builds both CUDA
kernels from pgvector_tpu_torch/csrc and holds each against its plain
PyTorch version on the card.

Output: one JSON line per phase; a JSON line of the kernels (route,
source, launches on the main path, error against the plain version,
kernel and plain times at the main path's shapes); the card's name and
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
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tests"))
    import numpy as np

    from bench import make_data
    from torch_parity import ATOL, RTOL, assert_same_topk
    from pgvector_tpu_torch import DenseTable, FlatIndex, HNSWIndex, Metric
    from pgvector_tpu_torch.ops import _cuda
    from pgvector_tpu_torch.ops.fused_topk import fused_topk, fused_topk_plain
    from pgvector_tpu_torch.ops.hop_tail import hop_tail, hop_tail_plain
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
                    "max_abs_err": float(np.abs(d1 - d0)[fin].max()),
                    "ids_equal_frac": float((i0 == i1).mean()),
                    "ms": cuda_ms(lambda: fused_topk(qk, data, dbsq, k)),
                    "plain_ms": cuda_ms(
                        lambda: fused_topk_plain(qk, data, dbsq, k))})
    emit({"phase": "k1_vs_plain", "rows": table.count,
          "atol": ATOL, "rtol": RTOL, "cases": k1})

    # ---- 3. K2 against its plain version: Q = 8,000, W = 256 ------------
    k2 = []
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
        k2.append({"ef": ef, "w": w, "equal": True,
                   "max_abs_err": float((d1 - d0)[fin].abs().max()),
                   "ms": cuda_ms(lambda: hop_tail(*hop, ef, w)),
                   "plain_ms": cuda_ms(lambda: hop_tail_plain(*hop, ef, w))})
    emit({"phase": "k2_vs_plain", "queries": q2, "cases": k2})

    # ---- 4. the main path -------------------------------------------------
    fused_topk.launches = 0
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
    for ef in (40, 100):
        idx.search(qs, k, ef_search=ef)  # warm-up: builds the slab cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist, r = idx.search(qs, k, ef_search=ef)
        dt = time.perf_counter() - t0
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
                "hop_tail": hop_tail.launches}
    check(launches["hop_tail"] > 0, "the search went through K2")
    emit({"phase": "main_path", "n": args.n, "queries": len(qs),
          "reduced": args.n != 1_000_000, "data_s": data_s,
          "exact_gt_s": gt_s, "build_s": build_s,
          "build_phases": {k: v["total_s"] for k, v in timers.report().items()},
          "packed": str(plan).replace("torch.", ""), "sweep": sweep,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches})

    emit({"kernels": [
        {"name": "fused_topk", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/fused_topk.cu",
         "replaces": "pgvector_tpu/ops/pallas_topk.py:95",
         "launches": launches["fused_topk"],
         "max_abs_err": max(c["max_abs_err"] for c in k1),
         "ms": k1[0]["ms"], "plain_ms": k1[0]["plain_ms"]},
        {"name": "hop_tail", "route": "cuda",
         "source": "pgvector_tpu_torch/csrc/hop_tail.cu",
         "replaces": "pgvector_tpu/ops/pallas_hop.py:154",
         "launches": launches["hop_tail"],
         "max_abs_err": max(c["max_abs_err"] for c in k2),
         "ms": k2[-1]["ms"], "plain_ms": k2[-1]["plain_ms"]},
    ]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
