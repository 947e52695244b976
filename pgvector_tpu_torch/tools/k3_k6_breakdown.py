"""Where K6's and K3's time goes on the card: ``csrc/gather_hop.cu`` and
``csrc/select_neighbors.cu`` timed whole and with parts of their work cut
out, as :mod:`.k4_breakdown` does for K4.

    python -m pgvector_tpu_torch.tools.k3_k6_breakdown [--n 1000000]

K6 takes one level-0 build hop at the main path's shape: the rows of
``bench.make_data``'s surrogate (:func:`.k1_breakdown.clustered`, seed 0,
1M × 128 f32), 1,024 queries that are stored rows, a seeded random graph
of 32-wide lists, sorted pools of the 64 true distances of random
elements (30 % expanded), E = 4.  The lists are random, so almost every
candidate is a row to read and score: the most a hop of this shape reads.
Variants:

- ``whole``: the kernel as committed;
- ``no_scores``: no candidate row read or scored;
- ``no_sorts``: neither the Knuth-keyed sort nor the candidates' sort
  (the merge writes the pool as it is);
- ``control``: neither the rows nor the sorts: the pool and query loads,
  the E-selection, the list reads, the pool mask and the writes.

Beside them ``torch.index_select`` of the rows the hop scores, into a
buffer (the card's rate for the same random rows, read and written).

K3 takes a backlink chunk's select in the Gram form: 16,384 pools of 64
candidates of 128-d seeded normal values (their products by
``torch.bmm`` and norms), base distances seeded, 30 % forced, lm 32;
``whole`` and ``no_loop`` (the keep loop cut: no row of the block read).

The whole kernels are checked against their plain versions (K6: done
flags equal, distances within f32 tolerance; K3: bit for bit).  Times are
the kernels' own device time (torch.profiler's kernel events over 50
launches; at tens of microseconds CUDA events would time the host's
launch pace), the mean of two rounds, the variants run in one order and
then in the reverse.  Prints one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops import _cuda
from ..ops.gather_hop import (dedupe_hop, gather_hop_plain, hop_buffers,
                              hop_lists, select_expand)
from ..ops.metric import Metric
from ..ops.select_neighbors import Gram, select_neighbors_plain
from .k1_breakdown import build_variants, clustered, smi_line

K6_SOURCE = _cuda.SRC_DIR / "gather_hop.cu"
K3_SOURCE = _cuda.SRC_DIR / "select_neighbors.cu"

#: cut -> its (anchor, replacement) pairs; each cut's condition is false
#: at run time whatever the compiler makes of it
K6_CUTS = {
    "scores": (("    for (int c0 = 0; c0 < n; c0 += groups * ROWS) {\n",
                "    for (int c0 = 0; c0 < n && n < 0; c0 += groups * ROWS) "
                "{\n"),),
    "sorts": (("    if (e_sel > 1 && any)\n",
               "    if (e_sel > 1 && any && e_sel < 0)\n"),
              ("    } else if (n == 0) {\n", "    } else if (true) {\n")),
}
K6_VARIANTS = {"whole": (), "no_scores": ("scores",),
               "no_sorts": ("sorts",), "control": ("scores", "sorts")}
K3_CUTS = {"loop": (("  for (int t = 0; t < nf && count < lm; ++t) {\n",
                     "  for (int t = 0; t < nf && count < lm && nf < 0; "
                     "++t) {\n"),)}
K3_VARIANTS = {"whole": (), "no_loop": ("loop",)}


def _k6_state(n, q=1024, ef=64, m2=32, seed=0):
    """The hop's inputs (pool_d, pool_p, nbr0, nbr_up, up_slot, rows, qs)
    on the card."""
    rows = torch.as_tensor(clustered(n, 1)[0], device="cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    nbr0 = torch.randint(0, n, (n, m2), generator=g,
                         dtype=torch.int32).cuda()
    nbr_up = torch.full((1, 1, m2 // 2), -1, dtype=torch.int32,
                        device="cuda")
    up_slot = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    qs = rows[torch.randint(0, n, (q,), generator=g).cuda()].contiguous()
    pool_i = torch.randint(0, n, (q, ef), generator=g,
                           dtype=torch.int32).cuda()
    pool_d = torch.sum((qs[:, None, :] - rows[pool_i.long()]) ** 2, dim=-1)
    pool_d, order = torch.sort(pool_d, dim=1, stable=True)
    pool_i = torch.gather(pool_i, 1, order)
    pool_x = (torch.rand((q, ef), generator=g) < 0.3).cuda()
    return (pool_d.contiguous(), (pool_i * 2 + pool_x.int()).contiguous(),
            nbr0, nbr_up, up_slot, rows, qs)


def _k6_launcher(lib, st, ef, expand):
    pool_d, pool_p, nbr0, nbr_up, up_slot, rows, qs = st
    q, d = qs.shape
    out = hop_buffers(q, ef, "cuda")

    def run():
        _cuda.check(lib.pgvt_gather_hop(
            pool_d.data_ptr(), pool_p.data_ptr(), nbr0.data_ptr(),
            nbr0.shape[0], nbr0.shape[1], nbr_up.data_ptr(),
            up_slot.data_ptr(), nbr_up.shape[0], nbr_up.shape[1],
            nbr_up.shape[2], 0, rows.data_ptr(), rows.shape[0],
            qs.data_ptr(), q, ef, expand, d, 0, 0, 0, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), None, None,
            out[4].data_ptr(), out[5].data_ptr(), out[3].data_ptr(),
            torch.cuda.current_stream().cuda_stream),
            "pgvt_gather_hop")
        return out
    return run


def _k3_state(t=16384, c=64, dim=128, seed=0):
    """A Gram-form select's inputs (base_d, Gram, valid, forced)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    v = torch.randn((t, c, dim), generator=g).cuda()
    gram = Gram(torch.bmm(v, v.transpose(1, 2)), torch.sum(v * v, dim=-1),
                True)
    base = (torch.rand((t, c), generator=g) * 100).cuda()
    valid = (torch.rand((t, c), generator=g) > 0.05).cuda()
    forced = (torch.rand((t, c), generator=g) < 0.3).cuda()
    return base, gram, valid, forced


def _k3_launcher(lib, st, lm):
    base, gram, valid, forced = st
    t, c = base.shape
    pos = torch.empty((t, lm), dtype=torch.int32, device="cuda")
    kept = torch.empty((t, lm), dtype=torch.bool, device="cuda")

    def run():
        _cuda.check(lib.pgvt_select_neighbors(
            base.data_ptr(), gram.ip.data_ptr(), gram.sq.data_ptr(), 1,
            valid.data_ptr(), forced.data_ptr(), t, c, lm, pos.data_ptr(),
            kept.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "pgvt_select_neighbors")
        return pos, kept
    return run


def kernel_ms(fn, reps=50):
    """Device ms of one kernel that each call of ``fn`` launches: the
    summed time of torch.profiler's CUDA kernel events over their count,
    after one call outside the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    count = sum(e.count for e in ev)
    if not count:
        raise SystemExit("k3_k6_breakdown: the profile holds no kernel")
    return sum(e.self_device_time_total for e in ev) / 1e3 / count


def _rounds(runs):
    """Kernel ms of each run: two rounds, in one order and then reversed."""
    ms = {name: 0.0 for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        ms[name] += kernel_ms(runs[name]) / 2
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_k6_breakdown needs a CUDA device")
    smi = smi_line()
    k6_libs = build_variants(K6_VARIANTS, K6_SOURCE, K6_VARIANTS, K6_CUTS,
                             "pgvt_gather_hop", "k6")
    k3_libs = build_variants(K3_VARIANTS, K3_SOURCE, K3_VARIANTS, K3_CUTS,
                             "pgvt_select_neighbors", "k3")
    ef, expand, lm = 64, 4, 32

    st = _k6_state(args.n, ef=ef)
    runs = {name: _k6_launcher(lib, st, ef, expand)
            for name, lib in k6_libs.items()}
    d1, p1, done1, left1, hops1, _ = runs["whole"]()
    d0, p0, done0, left0, hops0 = gather_hop_plain(*st[:5], 0, *st[5:], ef,
                                                   expand, Metric.L2)
    fin = torch.isfinite(d0)
    if not (torch.equal(done1, done0) and torch.equal(left1, left0)
            and torch.equal(hops1, hops0)
            and torch.allclose(d1[fin], d0[fin], atol=1e-4, rtol=1e-5)):
        raise SystemExit("k3_k6_breakdown: K6 differs from gather_hop_plain")
    k6_ms = _rounds(runs)
    # the rows this hop scores, gathered by the library
    pool_p, sel, _ = select_expand(st[0], st[1], ef, expand)
    nbrs = dedupe_hop(hop_lists(sel, st[2], st[3], st[4], 0,
                                st[5].shape[0]))
    in_pool = torch.any(nbrs[:, :, None] == (pool_p >> 1)[:, None, :], dim=2)
    ids = nbrs[(nbrs >= 0) & ~in_pool].long()
    gathered = torch.empty((ids.numel(), st[5].shape[1]), device="cuda")
    gather_ms = kernel_ms(lambda: torch.index_select(st[5], 0, ids,
                                                     out=gathered))
    row_bytes = st[5].shape[1] * st[5].element_size()
    del st, runs, gathered

    st3 = _k3_state()
    runs3 = {name: _k3_launcher(lib, st3, lm)
             for name, lib in k3_libs.items()}
    p1, k1 = runs3["whole"]()
    p0, k0 = select_neighbors_plain(st3[0], st3[1], st3[2], lm, st3[3])
    if not (torch.equal(p1, p0) and torch.equal(k1, k0)):
        raise SystemExit("k3_k6_breakdown: K3 differs from "
                         "select_neighbors_plain")
    k3_ms = _rounds(runs3)
    print(json.dumps({
        "tool": "k3_k6_breakdown", "nvidia_smi": smi, "n": args.n,
        "k6": {"queries": 1024, "ef": ef, "expand": expand,
               "rows_scored": ids.numel(), "ms": k6_ms,
               "scores_ms": k6_ms["whole"] - k6_ms["no_scores"],
               "sorts_ms": k6_ms["whole"] - k6_ms["no_sorts"],
               "index_select_ms": gather_ms,
               "index_select_tb_s": 2 * ids.numel() * row_bytes
               / gather_ms / 1e9,
               "scores_tb_s": ids.numel() * row_bytes
               / (k6_ms["whole"] - k6_ms["no_scores"]) / 1e9},
        "k3": {"rows": 16384, "c": 64, "lm": lm, "ms": k3_ms,
               "loop_ms": k3_ms["whole"] - k3_ms["no_loop"]},
        "cuts": {"k6": {v: list(c) for v, c in K6_VARIANTS.items()},
                 "k3": {v: list(c) for v, c in K3_VARIANTS.items()}}}))


if __name__ == "__main__":
    main()
