"""K3 — SelectNeighbors (Algorithm 4, hnswutils.c:1062-1163) over a batch
of candidate pools; replaces the XLA program of
``pgvector_tpu.index.hnsw_kernels.select_neighbors`` under
``select_neighbors_batch`` (its keep/prune ``fori_loop``).

Each of the T rows is a pool of C candidates with base distances, a
(C, C) pairwise block, validity and sticky ``forced`` flags.  Candidates
are visited closest first (a stable sort); one is kept when it is forced
or closer to the base than to every kept candidate, while fewer than lm
are kept (the cap applies in pop order to forced candidates too).  The lm
slots go to the kept candidates in distance order, then to the closest
pruned ones as backfill (keepPrunedConnections, hnswutils.c:1133-1156).

:func:`select_neighbors` launches ``csrc/select_neighbors.cu`` for CUDA
tensors and takes :func:`select_neighbors_plain` only for CPU tensors.
The kernel only compares and takes minima, and its rank is the plain
version's one f32 add, so both return the same positions and flags bit
for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda

BIG = 3.0e38


def select_neighbors_plain(base_d: torch.Tensor, pair_d: torch.Tensor,
                           valid: torch.Tensor, lm: int,
                           forced: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: the pool permuted into closest-first order once,
    then one step a column, so step t reads column t of every tensor."""
    t_rows, c = base_d.shape
    big_d = torch.where(valid, base_d, torch.inf)
    if forced is None:
        forced = torch.zeros_like(valid)
    forced = forced & valid & torch.isfinite(big_d)
    sd, order = torch.sort(big_d, dim=1, stable=True)
    sf = torch.gather(forced, 1, order)
    fin = torch.isfinite(sd)
    # pp[b, a, t] = pair_d[b, order[a], order[t]]
    pp = torch.gather(pair_d, 1, order[:, :, None].expand(t_rows, c, c))
    pp = torch.gather(pp, 2, order[:, None, :].expand(t_rows, c, c))
    min_pair = torch.full_like(sd, torch.inf)
    kept_s = torch.zeros_like(sf)
    count = torch.zeros(t_rows, dtype=torch.int32, device=sd.device)
    for t in range(c):
        ok = (sf[:, t] | (sd[:, t] < min_pair[:, t])) & fin[:, t] & (count < lm)
        kept_s[:, t] = ok
        torch.minimum(min_pair, torch.where(ok[:, None], pp[:, :, t],
                                            torch.inf), out=min_pair)
        count += ok
    kept = torch.zeros_like(kept_s).scatter_(1, order, kept_s)
    rank = torch.where(kept, big_d,
                       torch.where(torch.isfinite(big_d), big_d + BIG,
                                   torch.inf))
    rank_s, pos = torch.sort(rank, dim=1, stable=True)
    rank_s, pos = rank_s[:, :lm], pos[:, :lm].to(torch.int32)
    pos = torch.where(torch.isinf(rank_s), -1, pos)
    kept_sel = torch.gather(kept, 1, torch.clamp(pos, min=0).long()) & (pos >= 0)
    if pos.shape[1] < lm:  # fewer candidates than slots
        fill = lm - pos.shape[1]
        pos = torch.cat([pos, pos.new_full((t_rows, fill), -1)], dim=1)
        kept_sel = torch.cat(
            [kept_sel, kept_sel.new_zeros((t_rows, fill))], dim=1)
    return pos, kept_sel


def select_neighbors(base_d: torch.Tensor, pair_d: torch.Tensor,
                     valid: torch.Tensor, lm: int,
                     forced: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper: ``base_d`` (T, C) f32, ``pair_d`` (T, C, C) f32,
    ``valid`` and ``forced`` (T, C) bool (``forced`` may be None), the cap
    ``lm`` → ((T, lm) int32 selected positions, -1 padded; (T, lm) bool
    kept flags).  CUDA tensors launch the kernel; CPU tensors take
    :func:`select_neighbors_plain`.  ``launches`` counts every launch."""
    if not base_d.is_cuda:
        return select_neighbors_plain(base_d, pair_d, valid, lm, forced)
    _cuda.check_tensor(base_d, "base_d", torch.float32, 2)
    _cuda.check_tensor(pair_d, "pair_d", torch.float32, 3)
    _cuda.check_tensor(valid, "valid", torch.bool, 2)
    t_rows, c = base_d.shape
    flags = (valid,) if forced is None else (valid, forced)
    if forced is not None:
        _cuda.check_tensor(forced, "forced", torch.bool, 2)
    if (tuple(pair_d.shape) != (t_rows, c, c)
            or any(tuple(f.shape) != (t_rows, c) for f in flags)
            or lm < 1):
        raise ValueError(
            f"select_neighbors shapes: base_d {tuple(base_d.shape)}, "
            f"pair_d {tuple(pair_d.shape)}, valid {tuple(valid.shape)}, "
            f"forced {None if forced is None else tuple(forced.shape)}, "
            f"lm={lm}")
    if len({t.device for t in (base_d, pair_d, *flags)}) != 1:
        raise ValueError("select_neighbors inputs must be on one device")
    pos = torch.empty((t_rows, lm), dtype=torch.int32, device=base_d.device)
    kept = torch.empty((t_rows, lm), dtype=torch.bool, device=base_d.device)
    if t_rows == 0:
        return pos, kept
    lib = _cuda.lib()
    with torch.cuda.device(base_d.device):
        err = lib.pgvt_select_neighbors(
            base_d.data_ptr(), pair_d.data_ptr(), valid.data_ptr(),
            forced.data_ptr() if forced is not None else None, t_rows, c,
            lm, pos.data_ptr(), kept.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "pgvt_select_neighbors")
    select_neighbors.launches += 1
    return pos, kept


def staged(c: int) -> bool:
    """Whether the kernel stages a row's (C, C) pair block in shared
    memory (C ≤ 110), or reads it from device memory."""
    return bool(_cuda.lib().pgvt_select_neighbors_staged(c))


select_neighbors.launches = 0
