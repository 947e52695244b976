"""Run one cell of the benchmark once and print its result line.

    python3 -m vecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with a code other than 0, printing no result, where there is no
CUDA device or fewer than the cell asks for, and where the process has
loaded ``jax``, ``jaxlib``, ``flax`` or ``pgvector_tpu`` by the time the
window has closed.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: top-level module names the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "pgvector_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def nvidia_smi() -> str:
    """The card's name, SM clock and its maximum, and power limit."""
    cmd = ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
           "power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        f"nvidia-smi exit {out.returncode}: {out.stderr.strip()[:200]}"


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t0: float = None):
    """Set the cell up, run its window, judge it and read its metrics.
    Returns (result line as a dict, verdict, context)."""
    import torch

    from . import spec
    from .session import Context

    ctx = Context(cell, seed, device, T0 if t0 is None else t0, trace)
    drv = spec.kind(cell.workload["kind"])
    state = drv.setup(ctx)
    ctx.run.setup_s = time.perf_counter() - ctx.t0
    # the rest of set-up: imports and the CUDA context
    ctx.run.setup["start"] = ctx.run.setup_s - sum(ctx.run.setup.values())
    drv.window(ctx, state, seconds)
    lat = ctx.run.latencies_s  # the window's trend, a tenth at a time
    ctx.run.info["latency_ms_by_tenth"] = [
        1e3 * sum(part) / len(part) for part in
        (lat[len(lat) * j // 10: len(lat) * (j + 1) // 10] for j in range(10))
        if part]
    peak = max(ctx.run.peak_bytes, torch.cuda.max_memory_allocated(
        ctx.device) if ctx.cuda else 0)
    t_check = time.perf_counter()
    verdict = drv.check(ctx, state)
    ctx.run.info["check_s"] = time.perf_counter() - t_check
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"]).read(ctx.run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if ctx.cuda else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.correct, "attempted": ctx.run.attempted,
              "failed": verdict.failed_answers, "metrics": metrics,
              "device": dev}
    tr = ctx.run.trace
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        ctx.run.info["device_s_outside_window"] = tr.outside_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = verdict.checks()
    return result, verdict, ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="the length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: profile a stretch of the window and report "
                    "the cell's per-layer metrics")
    args = ap.parse_args(argv)

    import torch

    from . import spec

    if not torch.cuda.is_available():
        print("vecbench: torch.cuda.is_available() is false; the benchmark "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"vecbench: {cell.name} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, verdict, ctx = execute(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda:0")
    smi = nvidia_smi()  # after the window: its start-up is not set-up
    print(json.dumps({"setup_s": ctx.run.setup_s, "setup": ctx.run.setup,
                      "nvidia_smi": smi, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "info": ctx.run.info,
                      "timers": ctx.run.timers}), flush=True)
    leaked = forbidden_modules()
    if leaked:
        print(f"vecbench: the process holds {', '.join(leaked)}, which the "
              "benchmark may not load", file=sys.stderr)
        return 3
    for line in verdict.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
