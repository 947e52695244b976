"""K1 — fused exact top-k scan; replaces ``pgvector_tpu.ops.pallas_topk``.

The Pallas kernel (``pallas_topk._kernel``) scores each DB tile on the MXU
and folds it into a running (Q, k) best in VMEM, so no (Q, N) score block
reaches device memory.  Here the same contract is the hand-written CUDA
kernel ``csrc/fused_topk.cu`` (its header says how it is built), with a
plain PyTorch version of the same function beside it.

L2 ordering trick (as in the reference): per query, ``|q|² - 2 q·x + |x|²``
orders like ``|x|² - 2 q·x``, so the scan tracks the q-independent form
and :func:`exact_topk` adds ``|q|²`` back at the end; for inner product the
norm column is 0 and the score ``-2 q·x`` is halved back to ``-ip``.

:func:`fused_topk` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .distance import dot_precision
from .metric import Metric
from .topk import merge_topk

#: the kernel keeps each query's k best in shared memory
MAX_K = 64
#: queries per pass-1 block, DB rows per tile, the most DB splits pass 2
#: merges (K4's csrc/bit_scan.cu: BQ, BR; topk_fold.cuh: TOPK_MAX_SPLITS)
_QT, _RT, _MAX_SPLITS = 128, 128, 64
#: K1's rows a tile and floats of one 32-dim chunk of 128 split queries
#: (csrc/fused_topk.cu: BR, QCH)
_K1_RT, _K1_QCH = 64, 8192


def supported(metric: Metric, dtype) -> bool:
    """The metrics and dtype K1 scans (``pallas_topk.supported``): cosine
    needs pre-normalized rows, which FlatIndex does not hold."""
    return metric in (Metric.L2, Metric.IP) and dtype == torch.float32


def fused_topk_plain(qs: torch.Tensor, db: torch.Tensor, dbsq: torch.Tensor,
                     k: int, tile: int = 8192
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: (Q, k) smallest ``dbsq - 2·qs·dbᵀ`` with int32 row
    ids, ties to the lower id, ids -1 where the score is +inf.  A tiled f32
    matmul merged into the running best by a stable sort (tiled_topk's
    recipe)."""
    dot_precision()
    nq, n = qs.shape[0], db.shape[0]
    best_d = torch.full((nq, k), torch.inf, device=qs.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=qs.device)
    for start in range(0, n, tile):
        end = min(start + tile, n)
        s = dbsq[None, start:end] - 2.0 * (qs @ db[start:end].T)
        ids = torch.arange(start, end, dtype=torch.int32, device=qs.device)
        best_d, best_i = merge_topk(best_d, best_i, s,
                                    ids.expand(nq, -1), k)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def _splits(nq: int, n: int, sms: int, rows: int = _RT) -> Tuple[int, int]:
    """(DB splits, tiles of ``rows`` rows per split).  Pass 1 holds one
    block per SM and its blocks take equal time, so the grid should fill
    whole waves: of the split counts that give at least one full wave,
    take the one whose last wave is fullest, and the fewest splits among
    equals."""
    tiles = -(-n // rows)
    q_tiles = -(-nq // _QT)
    top = min(_MAX_SPLITS, tiles)
    lo = min(top, max(1, -(-sms // q_tiles)))

    def fill(s):
        blocks = q_tiles * -(-tiles // -(-tiles // s))
        return blocks / (-(-blocks // sms) * sms)

    want = max(range(lo, top + 1), key=lambda s: (round(fill(s), 3), -s))
    per = -(-tiles // want)
    return -(-tiles // per), per


def fused_topk(qs: torch.Tensor, db: torch.Tensor, dbsq: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper: ``qs`` (Q, D) f32, ``db`` (N, D) f32, ``dbsq`` (N,) f32
    with +inf on rows that must not match.  Returns ((Q, k) f32 scores,
    (Q, k) int32 ids) sorted by (score, id).  CUDA tensors launch the
    kernel; CPU tensors take :func:`fused_topk_plain`."""
    if not qs.is_cuda:
        return fused_topk_plain(qs, db, dbsq, k)
    _cuda.check_tensor(qs, "qs", torch.float32, 2)
    _cuda.check_tensor(db, "db", torch.float32, 2)
    _cuda.check_tensor(dbsq, "dbsq", torch.float32, 1)
    nq, d = qs.shape
    n = db.shape[0]
    if db.shape[1] != d or dbsq.shape[0] != n:
        raise ValueError(f"shape mismatch: qs {tuple(qs.shape)}, "
                         f"db {tuple(db.shape)}, dbsq {tuple(dbsq.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_topk takes 1 <= k <= {MAX_K}, got {k}")
    if n >= 2**31 - 2**20:  # row offsets are 32-bit in the kernel
        raise ValueError(f"fused_topk scans fewer than 2^31 - 2^20 rows, got {n}")
    if not (qs.device == db.device == dbsq.device):
        raise ValueError("qs, db and dbsq must be on one device")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=qs.device)
    if nq == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(torch.inf), out_i.fill_(-1)
    if d % 4 or db.data_ptr() % 16:
        # the tensor map takes 16-byte aligned rows: copy the table once,
        # zero-padded to a multiple of 4 dims (zeros add nothing to q.x)
        d4 = -(-d // 4) * 4
        db = torch.nn.functional.pad(db, (0, d4 - d))
        qs = torch.nn.functional.pad(qs, (0, d4 - d))
        d = d4
    splits, per = _splits(nq, n, torch.cuda.get_device_properties(
        qs.device).multi_processor_count, _K1_RT)
    part_d = torch.empty((splits, nq, k), dtype=torch.float32,
                         device=qs.device)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=qs.device)
    # scratch: the split queries, and each query's bound shared by splits
    qsplit = torch.empty(-(-nq // _QT) * -(-d // 32) * _K1_QCH,
                         dtype=torch.float32, device=qs.device)
    kth = torch.empty(nq, dtype=torch.int32, device=qs.device)
    lib = _cuda.lib()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgvt_fused_topk(
            qs.data_ptr(), db.data_ptr(), dbsq.data_ptr(), nq, n, d, k,
            splits, per, qsplit.data_ptr(), kth.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    _cuda.check(err, "pgvt_fused_topk")
    fused_topk.launches += 1
    return out_d, out_i


fused_topk.launches = 0


# K1's error against its plain version, from the arithmetic of each.
#
# u = 2^-24 is f32's unit roundoff.  For a query q and a row x of D dims,
# let S = sum_i |q_i| |x_i| (at most |q| |x|).  K1 (csrc/fused_topk.cu):
#
# - split: hi = tf32(a) rounds to 11 significant bits (cvt.rna, in
#   split_queries for the queries and in registers for the rows), so
#   |a - hi| <= 2^-11 |a|, and lo = tf32(a - hi) leaves |a - hi - lo| <=
#   2^-22 |a| = 4u |a|.  lo.hi + hi.lo + hi.hi then misses lo.lo (<= 4u
#   |a||b|) and the two rounding remainders times the other operand (<= 4u
#   |a||b| each): 12u S over the D products.  wgmma reads each operand as
#   the rounded value it is given (its tf32 truncation keeps all 11 bits),
#   the zeros past D and past the table add nothing, and TF32 products of
#   11-bit significands are exact in its f32 accumulator.
# - accumulation: each 32-dim chunk runs 12 wgmma.m64n128k8 ops (3
#   products x 4 k8 slices, each op adding its slice's 8 products) into fresh
#   accumulators, so no chain is longer than 12 ops; an op may truncate
#   rather than round when it adds its 8 products into the accumulator,
#   so allow two roundings of 2u each an op against the chunk's sum of
#   |terms|: 48u S over the chunks.  Each chunk's sum is then added to the
#   tile's running sum in f32 (u S an add, at most ceil(D/32) adds).
# - the score dbsq - 2 q.x rounds once: u (dbsq + 2S).  The shared bound
#   only skips rows that k others beat outright; it changes no score.
#
# The plain version (one f32 product, TF32 off) accumulates D products in
# some order: at most D u S, plus the same final rounding.  The two scores
# of one (q, x) therefore differ by at most
#
#     bound = 2u ((60 + ceil(D/32) + D) S + dbsq + 2S)
#
# (the factor 2 on the dot products is the score's -2 q.x).  The bound
# grows with the terms |x|^2 and 2 q.x, not with the score, which can
# cancel far below them: at 1M x 128 the scores near 18.8 sit on terms
# near 400.  A measured error above the bound is a kernel fault.
_U = 2.0 ** -24


def _row_bound(qs, db, ids, chunk, fn):
    """The largest ``fn(query slice, row ids, S, rows)`` over the id
    tensors ``ids`` at each (Q, k) position, 0 where the id is -1; S =
    sum_i |q_i| |x_i|."""
    qa = qs.abs().float()
    out = torch.zeros(ids[0].shape, dtype=torch.float32, device=qs.device)
    for t in ids:
        t = (t if torch.is_tensor(t) else torch.tensor(t)).to(qs.device)
        t = t.long()
        for s in range(0, qs.shape[0], chunk):
            ti = t[s: s + chunk]
            safe = ti.clamp(min=0)
            rows = db[safe].float()
            sabs = torch.einsum("qd,qkd->qk", qa[s: s + chunk], rows.abs())
            b = fn(slice(s, s + chunk), safe, sabs, rows)
            out[s: s + chunk] = torch.maximum(
                out[s: s + chunk], torch.where(ti >= 0, b, 0.0))
    return out


def k1_error_bound(qs: torch.Tensor, db: torch.Tensor, dbsq: torch.Tensor,
                   *ids: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """(Q, k) f32 bound on |K1 − fused_topk_plain| for the scores of rows
    ``ids`` (one or more (Q, k) id tensors, e.g. both results; the largest
    bound of the rows at a position is taken), derived above.  Positions
    whose id is -1 get 0."""
    c = 60 + -(-qs.shape[1] // 32) + qs.shape[1]
    return _row_bound(qs, db, ids, chunk, lambda qi, safe, sabs, rows:
                      2.0 * _U * (c * sabs + dbsq[safe] + 2.0 * sabs))


# The bound carried to the L2 distances FlatIndex returns, sqrt(max(|q|^2 +
# s, 0)) with s the score above: K1's on the card, an f32 evaluation on
# the CPU (the port's plain version, or the reference package's).
#
# One f32 evaluation of |q|^2 + |x|^2 - 2 q.x lies within
#
#     e = u ((D + 2)(|q|^2 + |x|^2) + (2D + 4) S)
#
# of the exact value: the two norms are sums of D squares (D u each), the
# product -2 q.x sums D products (2 D u S), and two adds round once each
# (u (|q|^2 + |x|^2 + 2S) together).  K1's score lies within
# k1_error_bound of the plain version's on the same inputs, and the card
# computes its own norms as that evaluation would.  So the squared
# distances a (reference) and b (card) differ by at most
#
#     E = k1_error_bound + 2e,
#
# and two plain f32 evaluations by at most 2e < E, so one E holds either
# pair.  The clamp at 0 moves neither value further apart.  For a, b >= 0,
# |sqrt(a) - sqrt(b)| = |a - b| / (sqrt(a) + sqrt(b)), which is at most
# sqrt(|a - b|) and at most |a - b| / sqrt(a): the roots differ by at most
# min(sqrt(E), E / r), r = sqrt(a) the reference's root.  Each side's
# square root rounds once more, and r is itself a rounded root; 4u (r +
# sqrt(E)) covers the three.  Near zero (a query equal to a row) the
# root's error is sqrt(E), far above E, and no fixed atol holds it: at 128
# dims and |x|^2 near 400 sqrt(E) is 0.18.


def k1_l2_error_bound(qs: torch.Tensor, db: torch.Tensor,
                      *ids: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """(Q, k) f32 bound E on the difference of two squared L2 distances of
    queries ``qs`` to rows ``ids`` of ``db``: K1's on the card through
    :func:`exact_topk` against an f32 evaluation on the CPU (derived
    above).  Positions whose id is -1 get 0."""
    d = qs.shape[1]
    c = 60 + -(-d // 32) + d
    qsq = torch.sum(qs.float() * qs.float(), dim=1)

    def bound(qi, safe, sabs, rows):
        xsq = torch.sum(rows * rows, dim=-1)
        norms = qsq[qi, None] + xsq
        k1 = c * sabs + xsq + 2.0 * sabs
        return 2.0 * _U * (k1 + (d + 2) * norms + (2 * d + 4) * sabs)

    return _row_bound(qs, db, ids, chunk, bound)


def l2_root_bound(sq_bound, d_ref) -> torch.Tensor:
    """(Q, k) bound on |sqrt(b) − d_ref| for squared distances b within
    ``sq_bound`` of the reference's, whose roots are ``d_ref`` (derived
    above); 0 where ``d_ref`` is +inf (no row)."""
    e = torch.as_tensor(sq_bound, dtype=torch.float32)
    r = (d_ref if torch.is_tensor(d_ref) else torch.tensor(d_ref))
    r = r.to(device=e.device, dtype=torch.float32)
    fin = torch.isfinite(r)
    r0 = torch.where(fin, r, 0.0)
    root = torch.sqrt(e)
    far = torch.where(r0 > 0, e / torch.where(r0 > 0, r0, 1.0), torch.inf)
    out = torch.minimum(root, far) + 4.0 * _U * (r0 + root)
    return torch.where(fin, out, 0.0)


def exact_topk(
    metric: Metric,
    qs: torch.Tensor,  # (Q, D)
    db: torch.Tensor,  # (N, D)
    k: int,
    valid: Optional[torch.Tensor] = None,  # (N,) live rows
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2/IP top-k through K1.  Returns stored distances (L2 →
    squared, IP → -ip) and int32 row ids, ``tiled_topk``'s contract
    (``pallas_topk.exact_topk``)."""
    dbf = db.float().contiguous()
    qf = qs.float().contiguous()
    if metric is Metric.L2:
        dbsq = torch.sum(dbf * dbf, dim=1)
    else:
        dbsq = torch.zeros(dbf.shape[0], device=dbf.device)
    if valid is not None:  # dead rows score beyond any live one
        dbsq = torch.where(valid[: dbf.shape[0]], dbsq, torch.inf)
    raw_d, ids = fused_topk(qf, dbf, dbsq.contiguous(), k)
    if metric is Metric.L2:
        q_sq = torch.sum(qf * qf, dim=1, keepdim=True)
        d_out = torch.where(torch.isinf(raw_d), torch.inf,
                            torch.clamp(raw_d + q_sq, min=0.0))
    else:
        d_out = torch.where(torch.isinf(raw_d), torch.inf, raw_d * 0.5)
    return d_out, ids
