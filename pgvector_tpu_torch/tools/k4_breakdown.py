"""Where K4's pass-1 time goes on the card: ``csrc/bit_scan.cu`` timed
whole and with parts of its work cut out, as :mod:`.k1_breakdown` does
for K1.

    python -m pgvector_tpu_torch.tools.k4_breakdown [--n 1000000]
        [--queries 8000] [--k 10] [--metric HAMMING|JACCARD]

The data is the sign bits of ``bench.make_data``'s clustered surrogate
(same recipe, seed 0), 128 bits (4 words) a row, every row valid,
Hamming unless ``--metric JACCARD``.  Variants:

- ``whole``: the kernel as committed;
- ``no_fold``: flagged rows are neither written to shared memory nor
  folded (the flag test still runs, and the code is built as whole);
- ``unpack_no_mma``: ``no_fold`` with each tensor-core product replaced by
  an XOR of its operands into the accumulator, so the query's unpacking
  stays;
- ``loads_only``: ``no_fold`` without the products (the unpacking goes
  with them): the ring and the flag test.

So the product is about ``no_fold - loads_only`` (its tensor-core share
``no_fold - unpack_no_mma``) and the fold ``whole - no_fold``.  Only the
whole kernel is checked, bitwise against ``bit_topk_plain``.  Times are
CUDA-event means of two rounds, the variants run in one order and then in
the reverse.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import _cuda
from ..ops.bit_scan import bit_topk_plain
from ..ops.distance import pack_bits
from ..ops.fused_topk import _splits
from ..ops.metric import Metric
from .k1_breakdown import build_variants, clustered, smi_line, timed

SOURCE = _cuda.SRC_DIR / "bit_scan.cu"
_FLAGGED = "    if (rows == 0) continue;  // uniform across the warp\n"
_MMA = "          mma_s8(acc[j], a, y & BYTE_LSB, y & (2 * BYTE_LSB));\n"

#: cut -> its (anchor, replacement) pairs
CUTS = {
    # no flagged row written or folded: the test that skips them holds for
    # every row at run time (k > 0), but the compiler cannot know it, so
    # the code is built as in the whole kernel (a cut the compiler can see
    # through let it drop the products as well)
    "fold": ((_FLAGGED, "    if (rows == 0 || k > 0) continue;\n"),),
    # the tensor-core products
    "mma": ((_MMA, ""),),
    # each product as an XOR of its operands (the unpacking stays live)
    "mma_as_xor": ((_MMA, "          acc[j][0] ^= (int)(a[0] ^ a[1] ^ a[2] "
                    "^ a[3] ^ x);\n"),),
}

#: variant -> cuts; "whole" is the kernel as committed
VARIANTS = {
    "whole": (),
    "no_fold": ("fold",),
    "unpack_no_mma": ("fold", "mma_as_xor"),
    "loads_only": ("fold", "mma"),
}


def _launcher(lib, qw, words, valid, k, jac):
    nq, w = qw.shape
    n = words.shape[0]
    splits, per = _splits(nq, n, torch.cuda.get_device_properties(
        qw.device).multi_processor_count)
    part_d = torch.empty((splits, nq, k), device=qw.device)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=qw.device)
    out_d = torch.empty((nq, k), device=qw.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=qw.device)

    def run():
        _cuda.check(lib.pgvt_bit_topk(
            qw.data_ptr(), words.data_ptr(), None, valid.data_ptr(), nq, n,
            w, k, int(jac), splits, per, part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "pgvt_bit_topk")
        return out_d, out_i
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=8000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--metric", choices=("HAMMING", "JACCARD"),
                    default="HAMMING")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4_breakdown needs a CUDA device")
    smi = smi_line()
    libs = build_variants(VARIANTS, SOURCE, VARIANTS, CUTS, "pgvt_bit_topk",
                          "k4")
    db, qs = clustered(args.n, args.queries)
    words = pack_bits(torch.as_tensor(db, device="cuda") > 0)
    qw = pack_bits(torch.as_tensor(qs, device="cuda") > 0)
    del db, qs
    valid = torch.ones(args.n, dtype=torch.bool, device="cuda")
    jac = args.metric == "JACCARD"
    runs = {name: _launcher(lib, qw, words, valid, args.k, jac)
            for name, lib in libs.items()}
    d1, i1 = runs["whole"]()
    d0, i0 = bit_topk_plain(Metric[args.metric], qw, words, args.k, valid)
    if not (torch.equal(d1, d0) and torch.equal(i1, i0)):
        raise SystemExit("k4_breakdown: the whole kernel differs from "
                         "bit_topk_plain")
    order = list(runs) + list(runs)[::-1]
    ms = {name: 0.0 for name in runs}
    for name in order:
        ms[name] += timed(runs[name]) / 2
    print(json.dumps({
        "tool": "k4_breakdown", "nvidia_smi": smi, "n": args.n,
        "queries": args.queries, "k": args.k, "metric": args.metric,
        "bits": 32 * qw.shape[1],
        "equal_to_plain": True, "ms": ms,
        "product_ms": ms["no_fold"] - ms["loads_only"],
        "tensor_core_ms": ms["no_fold"] - ms["unpack_no_mma"],
        "fold_ms": ms["whole"] - ms["no_fold"],
        "cuts": {v: list(c) for v, c in VARIANTS.items()}}))


if __name__ == "__main__":
    main()
