"""The control of the correctness check: the plain reference put in the
program's place, computed one precision step below the column's
(``tf32`` for an f32 column, ``bf16`` for fp16, ``int8`` for bf16),
answering every batch of the cell's pool at the cell's own size (an index
build's check queries over the whole table, as a full index holds it);
its answers are then judged exactly as a run's are.  It has to come out as not correct.

    python3 -m vecbench.control --workload <cell> --seeds <n> [<n> ...]

One JSON line a seed: the numbers compared, beside their limits.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

#: the precision one step below each column type's
BELOW = {"float32": "tf32", "float16": "bf16", "bfloat16": "int8"}


def control(cell, seed: int, device) -> dict:
    """Judge the control's answers for one seed."""
    from . import reference
    from .judge import Answer, judge
    from .session import Context

    cfg, wl = cell.config, cell.workload
    precision = BELOW[cfg["dtype"]]
    ctx = Context(cell, seed, device, 0.0)
    if wl["kind"] == "hnsw_build":
        rows, qs = ctx.inputs(wl["check_queries"])
        batches = [qs]
    else:
        rows, qs = ctx.inputs(wl["request_queries"] * wl["pool_batches"])
        batches = list(qs.split(wl["request_queries"]))
    ops = reference.Operands(rows, precision)
    answers = []
    for b, q in enumerate(batches):
        d, i = reference.topk(rows, q, wl["k"], ops=ops)
        answers.append(Answer(b, d.cpu().numpy(), i.cpu().numpy()))
    floor = None
    if wl.get("ef_search") is not None:
        floor = float(cfg["guarantees"]["recall_at_10_floor"][
            str(wl["ef_search"])])
    v = judge(answers, batches, rows, cfg["rows"], wl["k"], wl["limits"],
              exact=wl["kind"] == "exact_search", recall_floor=floor)
    return {"workload": cell.name, "seed": seed, "precision": precision,
            "rows_held": cfg["rows"], "correct": v.correct, "checks": v.checks()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    if not torch.cuda.is_available():
        print("vecbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control(cell, seed, "cuda:0")), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
