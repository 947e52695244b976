"""K7 (``csrc/greedy_walk.cu``) on an index's own upper levels: the
kernel against its plain version, its time beside its bound and the plain
version's time, and the work the walk needs.

    python -m pgvector_tpu_torch.tools.k7_walk [--n 1000000] [--dim 128] \\
        [--dtype f32] [--queries 8000]

It builds an HNSW index (m 16, ef_construction 64, wave 1,024, build beam
4) over ``bench.make_data``'s surrogate rows (:func:`.k1_breakdown.
clustered`, seed 0; SIFT-1M's shape by default, ``--n 200000 --dim 960
--dtype f16`` for GIST-960's halfvec rows), takes the queries' starts as
a search does (the entry point and its distance) and walks every upper
level (:func:`walk_vs_plain`).  Prints one JSON line with the card's name
and power limit.  ``chip_smoke.py`` calls :func:`walk_vs_plain` on its
own indexes.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..index.hnsw_kernels import make_scorer
from ..ops.greedy_walk import greedy_walk, greedy_walk_plain, walk_step

HBM_BYTES_S = 3.35e12  # NVIDIA H100 SXM's published rate, 700 W

#: the f32 tolerance of two sums of the same products in different orders
#: (tests/torch_parity.py's)
ATOL, RTOL = 1e-4, 1e-5

#: the least share of queries whose walks must end alike: a step whose
#: two best distances tie within f32 rounding may go either way
SAME_MIN = 0.99


def walk_work(values, nbr_up, up_slot, qs, cur, cur_d, level_hi: int,
              level_lo: int, metric, max_steps: int = 512) -> dict:
    """The walk's work, replayed in torch ops with each query's own stop:
    the steps (lists read), the rows scored, and the distinct lists, rows
    and slots among them; ``bytes`` counts every read, ``distinct_bytes``
    each input byte once (the lists, the rows, the slots, the queries
    and the starts read, the ends written), as a roofline counts."""
    n_rows, m = values.shape[0], nbr_up.shape[2]
    q = cur.shape[0]
    row_seen = torch.zeros(n_rows, dtype=torch.bool, device=values.device)
    list_seen = torch.zeros(nbr_up.shape[0] * nbr_up.shape[1],
                            dtype=torch.bool, device=values.device)
    slot_seen = torch.zeros(up_slot.shape[0], dtype=torch.bool,
                            device=values.device)
    steps = rows = 0
    for level in range(level_hi, level_lo - 1, -1):
        active = torch.ones(q, dtype=torch.bool, device=values.device)
        for _ in range(max_steps):
            if not bool(active.any()):
                break
            ok = active & (cur >= 0) & (cur < up_slot.shape[0])
            slot_seen[cur[ok].long()] = True
            slot = up_slot[cur[ok].long()]
            slot = slot[slot >= 0].long()
            list_seen[slot * nbr_up.shape[1] + level - 1] = True
            cur, cur_d, move, nbrs = walk_step(values, nbr_up, up_slot, qs,
                                               cur, cur_d, level, metric)
            live = (nbrs >= 0) & active[:, None]
            steps += int(active.sum())
            rows += int(live.sum())
            row_seen[nbrs[live].long()] = True
            active = move
    row_b = values.shape[1] * values.element_size()
    ends = q * (4 + 4)
    lists, drows, slots = (int(t.sum()) for t in (list_seen, row_seen,
                                                   slot_seen))
    return {"queries": q, "steps": steps, "steps_per_query": steps / q,
            "rows": rows, "distinct_rows": drows, "distinct_lists": lists,
            "bytes": steps * (m * 4 + 4) + rows * (row_b + 4)
            + q * qs.shape[1] * qs.element_size() + 2 * ends,
            "distinct_bytes": lists * m * 4 + drows * row_b + slots * 4
            + q * qs.shape[1] * qs.element_size() + 2 * ends}


def _event_ms(fn, reps: int = 3) -> float:
    """Mean device ms of ``fn()`` over ``reps`` runs after one warm-up,
    between CUDA events."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_only_ms(fn, reps: int = 20):
    """Device ms of the kernel alone (torch.profiler's kernel events over
    their count).  A profile with no event (seen on the card after many
    profiled calls) is taken again, at most twice; then None."""
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
            return sum(e.self_device_time_total for e in ev) / 1e3 / count
    return None


def walk_vs_plain(idx, qs) -> dict:
    """K7 on ``idx``'s upper levels for the queries ``qs`` (host or device
    values, coerced as a search coerces them), from the entry point as a
    search starts: one launch, the ends against the plain walk's (the
    share of equal ends, at least :data:`SAME_MIN`; their distances'
    largest difference; K7's ends a fixpoint of one more plain step at
    the lowest level, within f32 tolerance), K7's time (CUDA events; the
    kernel alone by torch.profiler), the plain walk's, and the bound."""
    qs = idx._query_rep(qs).contiguous()
    values, nbr_up, up_slot = idx.values, idx.nbr_up, idx._up_slot_dev
    hi, metric = idx.entry_level, idx.metric
    if hi < 1:
        raise ValueError("the index has no upper level to walk")
    start = torch.full((qs.shape[0],), idx.entry, dtype=torch.int32,
                       device=qs.device)
    score = make_scorer("dense", metric, values)
    start_d = score(qs, start[:, None])[:, 0]
    args = (values, nbr_up, up_slot, qs, start, start_d, hi, 1, metric)
    launches = greedy_walk.launches
    cur1, d1 = greedy_walk(*args)
    torch.cuda.synchronize()
    if greedy_walk.launches != launches + 1:
        raise RuntimeError("greedy_walk did not launch K7 once")
    cur0, d0 = greedy_walk_plain(*args)
    same = cur1 == cur0
    err = float((d1[same] - d0[same]).abs().max()) if bool(same.any()) else 0.0
    tol = float((ATOL + RTOL * d0[same].abs()).max()) if bool(
        same.any()) else ATOL
    _, again = greedy_walk_plain(values, nbr_up, up_slot, qs, cur1, d1, 1, 1,
                                 metric, max_steps=1)
    moved = (d1 - again) > ATOL + RTOL * d1.abs()
    share = float(same.float().mean())
    if share < SAME_MIN or err > tol or bool(moved.any()):
        raise RuntimeError(
            f"K7 against its plain walk: {share:.4f} of the ends equal, "
            f"largest distance difference {err} (tolerance {tol}), "
            f"{int(moved.sum())} ends not a fixpoint")
    work = walk_work(*args)
    bound = work["distinct_bytes"] / HBM_BYTES_S * 1e3
    ms = _event_ms(lambda: greedy_walk(*args))
    kernel_ms = _kernel_only_ms(lambda: greedy_walk(*args))
    plain_ms = _event_ms(lambda: greedy_walk_plain(*args), reps=1)
    return {"rows": values.shape[0], "dim": values.shape[1],
            "values": str(values.dtype).replace("torch.", ""),
            "levels": hi, "ends_equal_share": share, "max_abs_err": err,
            "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes",
            "bound_share": bound / kernel_ms if kernel_ms else None,
            "work": work}


def main(argv=None):
    import numpy as np

    from .. import DenseTable, HNSWIndex, Metric
    from .k1_breakdown import clustered, smi_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16", "f16"))
    ap.add_argument("--queries", type=int, default=8000)
    args = ap.parse_args(argv)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}[args.dtype]
    dev = torch.device("cuda", 0)
    db, qs = clustered(args.n, args.queries, dim=args.dim, seed=0)
    table = DenseTable(args.dim, dtype=dtype, capacity=args.n, device=dev)
    table.insert(db)
    t0 = time.perf_counter()
    idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64,
                    wave_size=1024, beam_expand=4, dedup=False)
    build_s = time.perf_counter() - t0
    out = walk_vs_plain(idx, np.ascontiguousarray(qs))
    print(json.dumps({"tool": "k7_walk", "nvidia_smi": smi_line(),
                      "build_s": build_s, **out}), flush=True)


if __name__ == "__main__":
    main()
