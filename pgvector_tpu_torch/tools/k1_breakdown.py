"""Where K1's pass-1 time goes on the card: ``csrc/fused_topk.cu`` timed
whole and with parts of its work cut out.

    python -m pgvector_tpu_torch.tools.k1_breakdown [--n 1000000]
        [--queries 8000] [--k 10] [--variants whole,no_fold,...]

Each variant is the source with the cuts of its name applied by text
substitution (a cut whose anchor is not in the source fails the tool, so
the cuts cannot silently stop applying), built by ``nvcc`` into
``_build/``, and launched through the same C entry and split layout as
:func:`..ops.fused_topk.fused_topk`.  The parts: the producer's TMA
loads of the rows (and bulk copies of streamed query chunks), the math
warps' row fragments (shared-memory loads and the hi / lo split), their
wgmma products, their stores of each finished tile's scores, and the
epilogue warps' checks and folds.  The variants: the whole kernel;
without the fold; without the split; without the score stores and the
fold; the copies alone; the products alone (fragments and wgmma); the
fold alone (scores are then dbsq, so the fold sees a scan of the same
size); and the skeleton left with all cut (the ring's and the score
buffer's mbarrier handshakes).  Cuts that remove the score stores keep
the sums live: a cut that let the compiler see them unused would drop
the products too.  A cut kernel's answers are wrong; only the whole
kernel is checked, against the plain version (within
``k1_error_bound``).  The data is the clustered surrogate of
``bench.make_data`` (same recipe, seed 0).  Times are CUDA-event means
of two rounds, the variants run in one order and then in the reverse.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _cuda
from ..ops.fused_topk import (_K1_QCH, _K1_RT, _QT, _splits,
                              fused_topk_plain, k1_error_bound)

SOURCE = _cuda.SRC_DIR / "fused_topk.cu"
_BYTES = "      mbar_arrive_tx(bar, ROWS_BYTES + (resident ? 0 : 4 * QCH));\n"
_COPIES = ("      tma_rows(slot, &rows_map, ch * DK, r0, bar);\n"
           "      if (!resident)\n"
           "        bulk_copy(slot + ROWS_BYTES, qtile + (size_t)ch * QCH, "
           "4 * QCH, bar);\n")
_FRAGMENTS = ("        split_tf32(x[c0], ah[sl][0], al[sl][0]);\n"
              "        split_tf32(x[8 * DK + c0], ah[sl][1], al[sl][1]);\n"
              "        split_tf32(x[c1], ah[sl][2], al[sl][2]);\n"
              "        split_tf32(x[8 * DK + c1], ah[sl][3], al[sl][3]);\n")
_RAW = "".join(
    f"        ah[sl][{i}] = al[sl][{i}] = __float_as_uint({v});\n"
    for i, v in enumerate(("x[c0]", "x[8 * DK + c0]", "x[c1]",
                           "x[8 * DK + c1]")))
_PRODUCTS = ("        wgmma_n128(p, al[sl], bh, sl);\n"
             "        wgmma_n128(p, ah[sl], bl, 1);\n"
             "        wgmma_n128(p, ah[sl], bh, 1);\n")
_SCORES = ("        *reinterpret_cast<float2*>(at) = make_float2(\n"
           "            na - 2.f * acc[4 * j], na - 2.f * acc[4 * j + 1]);\n"
           "        *reinterpret_cast<float2*>(at + 8 * SR) = make_float2(\n"
           "            nb - 2.f * acc[4 * j + 2], nb - 2.f * acc[4 * j + 3]);"
           "\n")
# keeps the sums live (a cut that let the compiler see them unused would
# drop the products too) and stores nothing
_KEEP_SUMS = ("        if (acc[4 * j] + acc[4 * j + 1] + acc[4 * j + 2] +\n"
              "            acc[4 * j + 3] == 1.2345e-30f) *at = na;\n")
_FOLD_START = "      const float* col = s_sc + 32 * ew + lane;\n"
_FOLD_END = "          atomicMin(kth + q0 + q, order_key(kv));\n      }\n"

#: cut -> its (anchor, replacement) pairs
CUTS = {
    # the producer's TMA loads and bulk copies (it still arrives on each
    # stage, with no bytes, so the ring's turns stay)
    "copies": ((_BYTES, "      mbar_arrive_tx(bar, 0);\n"),
               (_COPIES, "")),
    # the math warps' fragment loads and their hi / lo split
    "fragments": ((_FRAGMENTS, ""),),
    # the split alone (each loaded value taken as both hi and lo)
    "split": ((_FRAGMENTS, _RAW),),
    # the twelve wgmma ops a chunk (p stays 0)
    "products": ((_PRODUCTS, ""),),
    # the math warps' stores of a finished tile's scores (the handoff to
    # the epilogue warps stays)
    "scores": ((_SCORES, _KEEP_SUMS),),
    # the epilogue warps' checks and folds of each tile
    "fold": ((_FOLD_START, "#if 0\n" + _FOLD_START),
             (_FOLD_END, _FOLD_END + "#endif\n")),
}

#: variant -> cuts; "whole" is the kernel as committed
VARIANTS = {
    "whole": (),
    "no_fold": ("fold",),
    "no_split": ("split",),
    "no_scores": ("scores", "fold"),
    "copies_only": ("fragments", "products", "scores", "fold"),
    "products_only": ("copies", "scores", "fold"),
    "fold_only": ("copies", "fragments", "products"),
    "skeleton": ("copies", "fragments", "products", "scores", "fold"),
}


def variant_source(cuts, source: str, table=None) -> str:
    """``source`` with ``cuts`` (names in ``table``, K1's by default)
    applied; each anchor must occur once."""
    table = CUTS if table is None else table
    for cut in cuts:
        for anchor, repl in table[cut]:
            if source.count(anchor) != 1:
                raise ValueError(f"cut {cut!r}: anchor not found once in "
                                 "the source")
            source = source.replace(anchor, repl)
    return source


def clustered(n: int, nq: int, dim: int = 128, seed: int = 0):
    """bench.make_data's default surrogate: a 1,024-center gaussian
    mixture (center scale 1.5), rows drawn in 250,000-row chunks."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(1024, dim)).astype(np.float32) * 1.5
    db = np.empty((n, dim), np.float32)
    for s in range(0, n, 250_000):
        e = min(s + 250_000, n)
        assign = rng.integers(0, 1024, size=e - s)
        db[s:e] = centers[assign] + rng.normal(
            size=(e - s, dim)).astype(np.float32)
    qa = rng.integers(0, 1024, size=nq)
    qs = centers[qa] + rng.normal(size=(nq, dim)).astype(np.float32)
    return db, qs.astype(np.float32)


def build_variants(names, source=SOURCE, variants=None, cuts=None,
                   entry="pgvt_fused_topk", tag="k1"):
    """Compile every variant of ``source`` at once (K1's by default);
    name -> loaded library with ``entry`` bound."""
    variants = VARIANTS if variants is None else variants
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    jobs = {}
    for name in names:
        src = _cuda.BUILD_DIR / f"{tag}_{name}.cu"
        src.write_text(variant_source(variants[name], text, cuts))
        so = _cuda.BUILD_DIR / f"{tag}_{name}.so"
        jobs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.SRC_DIR),
             "-shared", "-o", str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        getattr(lib, entry).argtypes = _cuda._SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launcher(lib, qs, db, dbsq, k):
    nq, d = qs.shape
    n = db.shape[0]
    splits, per = _splits(nq, n, torch.cuda.get_device_properties(
        qs.device).multi_processor_count, _K1_RT)
    part_d = torch.empty((splits, nq, k), device=qs.device)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=qs.device)
    qsplit = torch.empty(-(-nq // _QT) * -(-d // 32) * _K1_QCH,
                         device=qs.device)
    kth = torch.empty(nq, dtype=torch.int32, device=qs.device)
    out_d = torch.empty((nq, k), device=qs.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=qs.device)

    def run():
        _cuda.check(lib.pgvt_fused_topk(
            qs.data_ptr(), db.data_ptr(), dbsq.data_ptr(), nq, n, d, k,
            splits, per, qsplit.data_ptr(), kth.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "pgvt_fused_topk")
        return out_d, out_i
    return run


def timed(fn, reps=5):
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=8000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to time (whole first)")
    args = ap.parse_args(argv)
    names = ["whole"] + [v for v in args.variants.split(",")
                         if v and v != "whole"]
    if any(v not in VARIANTS for v in names):
        raise SystemExit(f"k1_breakdown: variants are {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown needs a CUDA device")
    smi = smi_line()
    libs = build_variants(names)
    db, qs = (torch.as_tensor(a, device="cuda")
              for a in clustered(args.n, args.queries))
    dbsq = (db * db).sum(1)
    runs = {name: _launcher(lib, qs, db, dbsq, args.k)
            for name, lib in libs.items()}
    # the whole kernel against its plain version: the sorted k-lists of
    # distances agree within K1's derived bound (ids may differ at ties)
    d1, i1 = runs["whole"]()
    d0, i0 = fused_topk_plain(qs, db, dbsq, args.k)
    if not bool(((d1 - d0).abs() <= k1_error_bound(
            qs, db, dbsq, i0, i1)).all()):
        raise SystemExit("k1_breakdown: the whole kernel disagrees with "
                         "fused_topk_plain")
    order = list(runs) + list(runs)[::-1]
    ms = {name: 0.0 for name in runs}
    for name in order:
        ms[name] += timed(runs[name]) / 2
    print(json.dumps({
        "tool": "k1_breakdown", "nvidia_smi": smi, "n": args.n,
        "queries": args.queries, "k": args.k,
        "max_abs_err": float((d1 - d0).abs().max()),
        "ids_equal_frac": float((i1 == i0).float().mean()),
        "ms": ms, "cuts": {v: list(VARIANTS[v]) for v in names}}))


if __name__ == "__main__":
    main()
