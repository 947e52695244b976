"""Where K2's time goes on the card: ``csrc/packed_hop.cu`` timed whole and
with parts of its work cut out, as :mod:`.k3_k6_breakdown` does for K6.

    python -m pgvector_tpu_torch.tools.k2_breakdown [--n 1000000] [--ef 40]

K2 takes one layer-0 query hop at the main path's shape: the rows of
``bench.make_data``'s surrogate (:func:`.k1_breakdown.clustered`, seed 0,
1M × 128), a seeded random graph of 32-wide lists and its adjacency-packed
bf16 slab (``nbr_vals[s] = rows[nbr0[s]]``, 8 KB an element), 8,000
queries that are stored rows, sorted pools of the ef true distances of
random elements (30 % expanded), E = 8.  The lists are random, so almost
every candidate is new: the most a hop of this shape scores.  The bound
counts each distinct slab read once.  Variants:

- ``whole``: the kernel as committed;
- ``copies``: the slab copies alone: the selection, the bulk copies and
  their waits, with no dedupe, no score and no sort (the merge writes the
  pool as it is);
- ``front``: the selection, the lists, the dedupe and the merge, with no
  slab copied or scored;
- ``control``: neither: the pool and query loads, the selection, the list
  reads and the writes.

Beside them ``torch.index_select`` of the hop's slabs into a buffer (the
card's rate for the same blocks, read and written).  The whole kernel is
checked against its plain version (pools apart from ties, done flags and
hop counts equal).  Times are the kernels' own device time
(torch.profiler's kernel events over 50 launches), the mean of two
rounds, the variants run in one order and then in the reverse.  Prints
one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops import _cuda
from ..ops.gather_hop import hop_buffers, select_expand
from ..ops.metric import Metric
from ..ops.packed_hop import hop_candidates, packed_hop_plain
from .k1_breakdown import build_variants, clustered, smi_line
from .k3_k6_breakdown import kernel_ms

K2_SOURCE = _cuda.SRC_DIR / "packed_hop.cu"

#: cut -> its (anchor, replacement) pairs; each cut's condition is false
#: at run time whatever the compiler makes of it
K2_CUTS = {
    "copies": (("      const int np = n_live * a.pieces;\n",
                "      const int np = a.q < 0 ? n_live * a.pieces : 0;\n"),),
    "work": (("        if (n_live > 0) {\n",
              "        if (n_live > 0 && a.q < 0) {\n"),
             ("          for (int i0 = li; i0 < hi; i0 += groups * UNROLL)"
              " {\n",
              "          for (int i0 = li; i0 < hi && a.q < 0;\n"
              "               i0 += groups * UNROLL) {\n"),
             ("        whole = __any_sync(FULL, whole);\n",
              "        whole = __any_sync(FULL, whole) && a.q < 0;\n"),
             ("          for (int c0 = 0; c0 < w && n > 0; c0 += 32) {\n",
              "          for (int c0 = 0; c0 < w && n > 0 && a.q < 0; "
              "c0 += 32) {\n")),
}
K2_VARIANTS = {"whole": (), "copies": ("work",), "front": ("copies",),
               "control": ("copies", "work")}


def _k2_state(n, q=8000, ef=40, m2=32, seed=0):
    """The hop's inputs (pool_d, pool_p, nbr0, nbr_vals, qs) on the card:
    a random graph over the surrogate's rows and its bf16 slab."""
    rows = torch.as_tensor(clustered(n, 1)[0], device="cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    nbr0 = torch.randint(0, n, (n, m2), generator=g,
                         dtype=torch.int32).cuda()
    vals = torch.empty((n, m2, rows.shape[1]), dtype=torch.bfloat16,
                       device="cuda")
    for s in range(0, n, 1 << 16):
        vals[s: s + (1 << 16)] = rows[nbr0[s: s + (1 << 16)].long()].to(
            torch.bfloat16)
    qs = rows[torch.randint(0, n, (q,), generator=g).cuda()].contiguous()
    pool_i = torch.randint(0, n, (q, ef), generator=g,
                           dtype=torch.int32).cuda()
    pool_d = torch.sum((qs[:, None, :] - rows[pool_i.long()]) ** 2, dim=-1)
    pool_d, order = torch.sort(pool_d, dim=1, stable=True)
    pool_i = torch.gather(pool_i, 1, order)
    pool_x = (torch.rand((q, ef), generator=g) < 0.3).cuda()
    return (pool_d.contiguous(), (pool_i * 2 + pool_x.int()).contiguous(),
            nbr0, vals, qs)


def _k2_launcher(lib, st, ef, expand):
    pool_d, pool_p, nbr0, vals, qs = st
    q, d = qs.shape
    out = hop_buffers(q, ef, "cuda")
    path = ctypes.c_int(-1)

    def run():
        _cuda.check(lib.pgvt_packed_hop(
            pool_d.data_ptr(), pool_p.data_ptr(), nbr0.data_ptr(),
            nbr0.shape[0], nbr0.shape[1], vals.data_ptr(), 1, qs.data_ptr(),
            None, None, None, None, None, None, None, q, ef, expand, d, 0,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[4].data_ptr(), out[5].data_ptr(), out[3].data_ptr(),
            ctypes.addressof(path), torch.cuda.current_stream().cuda_stream),
            "pgvt_packed_hop")
        if path.value != 0:
            raise SystemExit("k2_breakdown: the hop left the bulk-copy path")
        return out[:5]
    return run


def _rounds(runs):
    """Kernel ms of each run: two rounds, in one order and then reversed."""
    ms = {name: 0.0 for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms[name] += kernel_ms(runs[name]) / 2
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--ef", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_breakdown needs a CUDA device")
    smi = smi_line()
    libs = build_variants(K2_VARIANTS, K2_SOURCE, K2_VARIANTS, K2_CUTS,
                          "pgvt_packed_hop", "k2")
    ef, expand = args.ef, 8
    st = _k2_state(args.n, ef=ef)
    runs = {name: _k2_launcher(lib, st, ef, expand)
            for name, lib in libs.items()}
    d1, p1, done1, left1, hops1 = runs["whole"]()
    d0, p0, done0, left0, hops0 = packed_hop_plain(*st, ef, expand,
                                                   Metric.L2)
    fin = torch.isfinite(d0)
    if not (torch.equal(done1, done0) and torch.equal(left1, left0)
            and torch.equal(hops1, hops0)
            and torch.allclose(d1[fin], d0[fin], atol=1e-4, rtol=1e-5)):
        raise SystemExit("k2_breakdown: K2 differs from packed_hop_plain")
    ms = _rounds(runs)
    # the slabs this hop reads, gathered by the library
    pool_p, sel, _ = select_expand(st[0], st[1], ef, expand)
    live = sel[sel >= 0].long()
    scored = int((hop_candidates(sel, st[2], pool_p) >= 0).sum())
    slabs = st[3].view(st[3].shape[0], -1)
    gathered = torch.empty((live.numel(), slabs.shape[1]),
                           dtype=slabs.dtype, device="cuda")
    gather_ms = kernel_ms(lambda: torch.index_select(slabs, 0, live,
                                                     out=gathered))
    q, m2, d = st[4].shape[0], st[2].shape[1], st[4].shape[1]
    slab_bytes = live.numel() * slabs.shape[1] * slabs.element_size()
    unique = int(torch.unique(live).numel())  # each distinct slab read once
    nbytes = (16 * q * ef + 10 * q + 4 * m2 * unique + 4 * q * d
              + unique * slabs.shape[1] * slabs.element_size())
    bound = nbytes / 3.35e12 * 1e3
    print(json.dumps({
        "tool": "k2_breakdown", "nvidia_smi": smi, "n": args.n,
        "queries": q, "ef": ef, "expand": expand, "slab": "bfloat16",
        "slabs": live.numel(), "unique_slabs": unique,
        "slab_bytes": slab_bytes, "scored": scored,
        "ms": ms, "bound_ms": bound, "bound_bytes": nbytes,
        "share_of_bound": bound / ms["whole"],
        "copies_tb_s": slab_bytes / ms["copies"] / 1e9,
        "index_select_ms": gather_ms,
        "index_select_tb_s": 2 * slab_bytes / gather_ms / 1e9,
        "cuts": {v: list(c) for v, c in K2_VARIANTS.items()}}))


if __name__ == "__main__":
    main()
