"""K4 ``bit_topk`` and K5 ``bit_point_scores`` — Hamming and Jaccard over
packed words, the CUDA kernels of ``csrc/bit_scan.cu`` (its header says
what each replaces, its bound and its design).

Neither replaces a Pallas kernel: the JAX package computes both with
``lax.population_count`` in XLA (``ops/distance.bit_scores`` under
``ops/topk.tiled_topk``; the bit branches of ``hnsw_kernels.make_scorer``
and ``_pairwise_dists``).  Torch has no popcount operator, so the plain
versions beside the kernels count bits with a 256-entry byte table
(:func:`..ops.distance.popcount_rows`), tile by tile.

Words are int32 tensors holding the reference's uint32 bit patterns.  Both
wrappers launch the kernel for CUDA tensors and take the plain version
only for CPU tensors; each counts its launches in ``launches``.
Distances are bitwise equal to the plain versions' (integer popcounts; the
kernels are built without fast math, so Jaccard's f32 division rounds the
same).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .distance import bit_scores, jaccard_from_counts, popcount_rows
from .fused_topk import MAX_K, _splits
from .metric import Metric
from .topk import merge_topk

BIT_METRICS = (Metric.HAMMING, Metric.JACCARD)

#: int32 words a plain tile's (Q, rows, W) block may hold
_PLAIN_BLOCK = 1 << 25


def _check_metric(metric: Metric) -> bool:
    if metric not in BIT_METRICS:
        raise ValueError(f"metric {metric} is not a bit metric")
    return metric is Metric.JACCARD


def bit_topk_plain(metric: Metric, qs: torch.Tensor, db: torch.Tensor,
                   k: int, valid: torch.Tensor,
                   pop: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: (Q, k) smallest distances of words ``qs`` (Q, W) over
    ``db`` (N, W) where ``valid`` (N,) holds, with int32 row ids, ties to
    the lower id, -1 where the distance is +inf (``tiled_topk`` over
    ``bit_scores``)."""
    _check_metric(metric)
    nq, n = qs.shape[0], db.shape[0]
    tile = max(1, _PLAIN_BLOCK // max(nq * qs.shape[1], 1))
    best_d = torch.full((nq, k), torch.inf, device=qs.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=qs.device)
    for start in range(0, n, tile):
        end = min(start + tile, n)
        s = bit_scores(metric, qs, db[start:end],
                       None if pop is None else pop[start:end])
        s = torch.where(valid[None, start:end], s, torch.inf)
        ids = torch.arange(start, end, dtype=torch.int32, device=qs.device)
        best_d, best_i = merge_topk(best_d, best_i, s, ids.expand(nq, -1), k)
    return best_d, torch.where(torch.isinf(best_d), -1, best_i)


def bit_topk(metric: Metric, qs: torch.Tensor, db: torch.Tensor, k: int,
             valid: torch.Tensor, pop: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 wrapper: ``qs`` (Q, W) and ``db`` (N, W) int32 words, ``valid``
    (N,) bool (live and passing the filter), 1 <= k <= 64.  Returns ((Q,
    k) f32 distances, (Q, k) int32 ids) sorted by (distance, id).
    ``pop`` (N,) int32 row popcounts is optional: the plain version uses
    it for Jaccard where given, and the kernel counts |x| itself."""
    jac = _check_metric(metric)
    if not qs.is_cuda:
        return bit_topk_plain(metric, qs, db, k, valid, pop)
    _cuda.check_tensor(qs, "qs", torch.int32, 2)
    _cuda.check_tensor(db, "db", torch.int32, 2)
    _cuda.check_tensor(valid, "valid", torch.bool, 1)
    nq, w = qs.shape
    n = db.shape[0]
    if db.shape[1] != w or valid.shape[0] != n:
        raise ValueError(f"shape mismatch: qs {tuple(qs.shape)}, "
                         f"db {tuple(db.shape)}, valid {tuple(valid.shape)}")
    if pop is not None:
        _cuda.check_tensor(pop, "pop", torch.int32, 1)
        if pop.shape[0] != n:
            raise ValueError(f"pop has {pop.shape[0]} rows, db {n}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"bit_topk takes 1 <= k <= {MAX_K}, got {k}")
    if n >= 2**31 - 2**20:
        raise ValueError(f"bit_topk scans fewer than 2^31 - 2^20 rows, got {n}")
    if not all(t.device == qs.device for t in (db, valid)):
        raise ValueError("qs, db and valid must be on one device")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=qs.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=qs.device)
    if nq == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(torch.inf), out_i.fill_(-1)
    if valid.data_ptr() % 16:  # the kernel copies it in 16-byte pieces
        valid = valid.clone()
    splits, per = _splits(nq, n, torch.cuda.get_device_properties(
        qs.device).multi_processor_count)
    part_d = torch.empty((splits, nq, k), dtype=torch.float32,
                         device=qs.device)
    part_i = torch.empty((splits, nq, k), dtype=torch.int32, device=qs.device)
    lib = _cuda.lib()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgvt_bit_topk(
            qs.data_ptr(), db.data_ptr(), None,
            valid.data_ptr(), nq, n, w, k, int(jac), splits, per,
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), stream)
    _cuda.check(err, "pgvt_bit_topk")
    bit_topk.launches += 1
    return out_d, out_i


bit_topk.launches = 0


def bit_point_scores_plain(metric: Metric, qs: torch.Tensor,
                           table: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """Plain K5: (B, R) distances of words ``qs`` (B, W) to the table rows
    ``rows`` (B, R) (ids < N), +inf where an id is negative."""
    jac = _check_metric(metric)
    x = table[torch.clamp(rows, min=0).long()]  # (B, R, W)
    q = qs[:, None, :]
    if jac:
        d = jaccard_from_counts(popcount_rows(q & x),
                                popcount_rows(qs)[:, None], popcount_rows(x))
    else:
        d = popcount_rows(q ^ x).float()
    return torch.where(rows >= 0, d, torch.inf)


def bit_point_scores(metric: Metric, qs: torch.Tensor, table: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """K5 wrapper: ``qs`` (B, W) and ``table`` (N, W) int32 words,
    ``rows`` (B, R) int32 ids below N (-1: none).  Returns (B, R) f32."""
    jac = _check_metric(metric)
    if not qs.is_cuda:
        return bit_point_scores_plain(metric, qs, table, rows)
    rows = rows.to(torch.int32).contiguous()
    qs = qs.contiguous()
    _cuda.check_tensor(qs, "qs", torch.int32, 2)
    _cuda.check_tensor(table, "table", torch.int32, 2)
    _cuda.check_tensor(rows, "rows", torch.int32, 2)
    nb, w = qs.shape
    if table.shape[1] != w or rows.shape[0] != nb:
        raise ValueError(f"shape mismatch: qs {tuple(qs.shape)}, "
                         f"table {tuple(table.shape)}, "
                         f"rows {tuple(rows.shape)}")
    if not (table.device == rows.device == qs.device):
        raise ValueError("qs, table and rows must be on one device")
    out = torch.empty(rows.shape, dtype=torch.float32, device=qs.device)
    if out.numel() == 0:
        return out
    lib = _cuda.lib()
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgvt_bit_point_scores(
            qs.data_ptr(), table.data_ptr(), rows.data_ptr(), nb,
            rows.shape[1], w, int(jac), out.data_ptr(), stream)
    _cuda.check(err, "pgvt_bit_point_scores")
    bit_point_scores.launches += 1
    return out


bit_point_scores.launches = 0
