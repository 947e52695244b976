"""Where K1's pass-1 time goes on the card: ``csrc/fused_topk.cu`` timed
whole and with parts of its work cut out.

    python -m pgvector_tpu_torch.tools.k1_breakdown [--n 1000000]
        [--queries 8000] [--k 10]

Each variant is the source with the cuts of its name applied by text
substitution (a cut whose anchor is not in the source fails the tool, so
the cuts cannot silently stop applying), built by ``nvcc`` into
``_build/``, and launched through the same C entry and split layout as
:func:`..ops.fused_topk.fused_topk`.  A cut kernel's answers are wrong;
only the whole kernel is checked, against the plain version.  The data
is the clustered surrogate of ``bench.make_data`` (same recipe, seed 0).
Times are CUDA-event means of two rounds, the variants run in one order
and then in the reverse.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..ops import _cuda
from ..ops.fused_topk import _splits, fused_topk_plain

SOURCE = _cuda.SRC_DIR / "fused_topk.cu"
_FOLD_START = "    const int qb = warp * (BQ / 8);\n"
_FOLD_END = "    // the next step's barrier orders this fold"
_LO_PRODUCTS = ("          mma(part[i][j], al[i], bh);\n"
                "          mma(part[i][j], ah[i], bl);\n")
_HI_PRODUCT = "          mma(part[i][j], ah[i], bh);\n"
_Q_PREFETCH = "      load_chunk(st, qs, q0, nq, nch * DK, d, vec);\n"

#: cut -> its (anchor, replacement) pairs
CUTS = {
    # the fold of each finished tile into the k-lists
    "fold": ((_FOLD_START, "#if 0\n" + _FOLD_START),
             (_FOLD_END, "#endif\n" + _FOLD_END)),
    # two of the three TF32 products (hi.lo and lo.hi)
    "lo_products": ((_LO_PRODUCTS, ""),),
    # the third product as well
    "hi_product": ((_HI_PRODUCT, ""),),
    # the query chunks after the first tile's (the rows still stream)
    "query_reload": ((_Q_PREFETCH,
                      "      if (s + 1 < nchunks)\n" + _Q_PREFETCH),),
}

#: variant -> cuts; "whole" is the kernel as committed
VARIANTS = {
    "whole": (),
    "no_fold": ("fold",),
    "one_product": ("lo_products",),
    "one_product_no_fold": ("lo_products", "fold"),
    "loads_only": ("lo_products", "hi_product", "fold"),
    "queries_once": ("query_reload",),
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
        qs.device).multi_processor_count)
    part_d = torch.empty((splits, nq, k), device=qs.device)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=qs.device)
    out_d = torch.empty((nq, k), device=qs.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=qs.device)

    def run():
        _cuda.check(lib.pgvt_fused_topk(
            qs.data_ptr(), db.data_ptr(), dbsq.data_ptr(), nq, n, d, k,
            splits, per, part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "pgvt_fused_topk")
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_breakdown needs a CUDA device")
    smi = smi_line()
    libs = build_variants(VARIANTS)
    db, qs = (torch.as_tensor(a, device="cuda")
              for a in clustered(args.n, args.queries))
    dbsq = (db * db).sum(1)
    runs = {name: _launcher(lib, qs, db, dbsq, args.k)
            for name, lib in libs.items()}
    # the whole kernel against its plain version: the sorted k-lists of
    # distances agree within f32 tolerance (ids may differ at ties)
    d1, i1 = runs["whole"]()
    d0, i0 = fused_topk_plain(qs, db, dbsq, args.k)
    if not torch.allclose(d1, d0, atol=1e-4, rtol=1e-5):
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
        "ms": ms, "cuts": {v: list(c) for v, c in VARIANTS.items()}}))


if __name__ == "__main__":
    main()
