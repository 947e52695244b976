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
#: DB rows per pass-1 tile and the most DB splits pass 2 merges
_RT, _MAX_SPLITS = 64, 64
_QT, _SMS = 64, 132


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


def _splits(nq: int, n: int) -> Tuple[int, int]:
    """(DB splits, row tiles per split): enough blocks to fill the SMs
    about four times over."""
    tiles = -(-n // _RT)
    q_tiles = -(-nq // _QT)
    want = min(_MAX_SPLITS, tiles, max(1, -(-4 * _SMS // q_tiles)))
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
    splits, per = _splits(nq, n)
    part_d = torch.empty((splits, nq, k), dtype=torch.float32,
                         device=qs.device)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=qs.device)
    lib = _cuda.lib()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgvt_fused_topk(
            qs.data_ptr(), db.data_ptr(), dbsq.data_ptr(), nq, n, d, k,
            splits, per, part_d.data_ptr(), part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), stream)
    _cuda.check(err, "pgvt_fused_topk")
    fused_topk.launches += 1
    return out_d, out_i


fused_topk.launches = 0


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
