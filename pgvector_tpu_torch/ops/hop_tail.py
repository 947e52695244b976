"""K2's tail — the hop tail of the packed HNSW beam search, the function
of ``pgvector_tpu.ops.pallas_hop``.  The search runs it inside the fused
hop (:mod:`.packed_hop`); this entry takes distances scored elsewhere.

Per query row the tail merges W freshly scored candidates into the ef pool
(ids packed as ``id·2 | expanded``):

1. order [pool ∥ candidates] by (id, position) and mask every later copy
   of an id — the pool's copy has the smallest position, so it survives
   with its expanded flag.  This replaces both the in-hop dedup and the
   in-pool membership block of the unfused tail;
2. order by (distance, position) — the stable distance order;
3. emit the first ef lanes, +inf / -2 where empty.

The CUDA kernel (``csrc/hop_tail.cu`` over ``csrc/hop_merge.cuh``) does
this with two bitonic sorts in registers and warp shuffles;
:func:`hop_tail_plain` does it with two stable ``torch.sort`` calls.
Both only move values, so they agree bit for bit.
:func:`hop_tail` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

#: finite sentinel — masked lanes sort to the end (pallas_hop.BIG)
BIG = 3.0e38
#: id sentinel for masked lanes, after every real id (pallas_hop.ID_INF)
ID_INF = 2**31 - 2**20
#: widest row the kernel sorts in shared memory: ef_search ≤ 1000 with W up
#: to 2m·expand
MAX_WIDTH = 4096


def hop_tail_plain(pool_d: torch.Tensor, pool_p: torch.Tensor,
                   cand_d: torch.Tensor, cand_i: torch.Tensor, ef: int,
                   w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2.  The kernel's padding lanes (BIG, ID_INF) sort
    after every real lane and are not needed here; only the order of the
    lanes below BIG reaches the output."""
    ids = torch.cat([pool_p >> 1, cand_i], dim=1)
    ids = torch.where(ids < 0, ID_INF, ids)
    d = torch.cat([pool_d, cand_d], dim=1)
    d = torch.where(torch.isinf(d) | (ids == ID_INF), BIG, d)
    packed = torch.cat([pool_p, cand_i * 2], dim=1)
    # pass 1: a stable sort by id is the (id, position) order
    ids_s, perm = torch.sort(ids, dim=1, stable=True)
    dup_s = torch.zeros_like(ids_s, dtype=torch.bool)
    dup_s[:, 1:] = (ids_s[:, 1:] == ids_s[:, :-1]) & (ids_s[:, 1:] != ID_INF)
    dup = torch.zeros_like(dup_s).scatter_(1, perm, dup_s)
    d = torch.where(dup, BIG, d)
    # pass 2: a stable sort by distance, in position order
    d_f, order = torch.sort(d, dim=1, stable=True)
    d_f, order = d_f[:, :ef], order[:, :ef]
    empty = d_f >= BIG
    return (torch.where(empty, torch.inf, d_f),
            torch.where(empty, -2, torch.gather(packed, 1, order)))


def hop_tail(pool_d: torch.Tensor, pool_p: torch.Tensor,
             cand_d: torch.Tensor, cand_i: torch.Tensor, ef: int,
             w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: pool (Q, ef) f32 distances and int32 packed ids,
    candidates (Q, W) f32 distances and int32 ids (-1 = none).  Returns
    the new (Q, ef) pool.  CUDA tensors launch the kernel; CPU tensors
    take :func:`hop_tail_plain`."""
    if not pool_d.is_cuda:
        return hop_tail_plain(pool_d, pool_p, cand_d, cand_i, ef, w)
    _cuda.check_tensor(pool_d, "pool_d", torch.float32, 2)
    _cuda.check_tensor(pool_p, "pool_p", torch.int32, 2)
    _cuda.check_tensor(cand_d, "cand_d", torch.float32, 2)
    _cuda.check_tensor(cand_i, "cand_i", torch.int32, 2)
    q = pool_d.shape[0]
    if (tuple(pool_p.shape) != (q, ef) or tuple(pool_d.shape) != (q, ef)
            or tuple(cand_d.shape) != (q, w)
            or tuple(cand_i.shape) != (q, w)):
        raise ValueError(
            f"hop_tail shapes: pool {tuple(pool_d.shape)}/"
            f"{tuple(pool_p.shape)}, candidates {tuple(cand_d.shape)}/"
            f"{tuple(cand_i.shape)}, ef={ef}, w={w}")
    if not (pool_d.device == pool_p.device == cand_d.device == cand_i.device):
        raise ValueError("hop_tail inputs must be on one device")
    if ef + w > MAX_WIDTH:
        raise ValueError(f"hop_tail sorts at most {MAX_WIDTH} lanes per row; "
                         f"ef + W = {ef + w}")
    out_d = torch.empty((q, ef), dtype=torch.float32, device=pool_d.device)
    out_p = torch.empty((q, ef), dtype=torch.int32, device=pool_d.device)
    if q == 0:
        return out_d, out_p
    lib = _cuda.lib()
    with torch.cuda.device(pool_d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgvt_hop_tail(
            pool_d.data_ptr(), pool_p.data_ptr(), cand_d.data_ptr(),
            cand_i.data_ptr(), q, ef, w, out_d.data_ptr(), out_p.data_ptr(),
            stream)
    _cuda.check(err, "pgvt_hop_tail")
    hop_tail.launches += 1
    return out_d, out_p


hop_tail.launches = 0
