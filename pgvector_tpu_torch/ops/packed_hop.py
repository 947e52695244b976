"""K2 — one fused hop of the packed HNSW layer-0 beam search; replaces
``pgvector_tpu.ops.pallas_hop`` and the packed scoring in front of it
(``pgvector_tpu.index.hnsw_kernels._hop_body``, its Pallas-tail branch).

Given each query row's E expanded element ids (``sel_flat``, -1 for none),
the hop reads their level-0 lists ``nbr0[s]`` (the W = E·2m candidate ids,
selection-major), scores the adjacency-packed slabs ``nbr_vals[s]``
against the query in f32 (the metrics of
:func:`.distance.dense_point_scores`), and merges the candidates into the
ef pool with the hop tail of :mod:`.hop_tail`.  No (Q, W, D) tensor and no
(Q, W) score block reach device memory.

:func:`packed_hop` launches ``csrc/packed_hop.cu`` for CUDA tensors and
takes :func:`packed_hop_plain` only for CPU tensors.  The kernel sums each
distance in another order than ``torch.sum``, so the two agree on
distances within f32 tolerance and on ids apart from ties; given the same
distances the tail is bit-identical (``csrc/hop_merge.cuh``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda
from .distance import dense_point_scores
from .hop_tail import MAX_WIDTH, hop_tail_plain
from .metric import Metric

#: the kernel's metric codes; cosine values are stored normalized and
#: ordered by -ip
_METRIC_CODE = {Metric.L2: 0, Metric.IP: 1, Metric.COSINE: 1, Metric.L1: 2}


def packed_hop_plain(pool_d: torch.Tensor, pool_p: torch.Tensor,
                     sel_flat: torch.Tensor, nbr0: torch.Tensor,
                     nbr_vals: torch.Tensor, qs: torch.Tensor, ef: int,
                     metric: Metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: the slab gather, :func:`dense_point_scores`, then
    :func:`hop_tail_plain`."""
    nq = pool_d.shape[0]
    safe = torch.clamp(sel_flat, min=0).long()
    nbrs = torch.where(sel_flat[:, None] >= 0, nbr0[safe], -1).reshape(nq, -1)
    w = nbrs.shape[1]
    v = nbr_vals[safe].reshape(nq, w, nbr_vals.shape[-1])
    nd = dense_point_scores(metric, qs, v, nbrs)
    return hop_tail_plain(pool_d, pool_p, nd, nbrs, ef, w)


def packed_hop(pool_d: torch.Tensor, pool_p: torch.Tensor,
               sel_flat: torch.Tensor, nbr0: torch.Tensor,
               nbr_vals: torch.Tensor, qs: torch.Tensor, ef: int,
               metric: Metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: pool (Q, ef) f32 distances and int32 packed ids
    (``id·2 | expanded``), ``sel_flat`` (Q·E,) int32 expanded element ids,
    ``nbr0`` (cap, 2m) int32, ``nbr_vals`` (cap, 2m, D) f32 or bf16, ``qs``
    (Q, D) f32.  Returns the new (Q, ef) pool, as :func:`.hop_tail.hop_tail`
    does.  CUDA tensors launch the kernel; CPU tensors take
    :func:`packed_hop_plain`."""
    if not pool_d.is_cuda:
        return packed_hop_plain(pool_d, pool_p, sel_flat, nbr0, nbr_vals, qs,
                                ef, metric)
    _cuda.check_tensor(pool_d, "pool_d", torch.float32, 2)
    _cuda.check_tensor(pool_p, "pool_p", torch.int32, 2)
    _cuda.check_tensor(sel_flat, "sel_flat", torch.int32, 1)
    _cuda.check_tensor(nbr0, "nbr0", torch.int32, 2)
    _cuda.check_tensor(nbr_vals, "nbr_vals", nbr_vals.dtype, 3)
    _cuda.check_tensor(qs, "qs", torch.float32, 2)
    if nbr_vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"nbr_vals must be f32 or bf16, got {nbr_vals.dtype}")
    q, m2 = pool_d.shape[0], nbr0.shape[1]
    d = nbr_vals.shape[2]
    if (tuple(pool_p.shape) != (q, ef) or pool_d.shape[1] != ef
            or sel_flat.shape[0] % max(q, 1)
            or tuple(nbr_vals.shape[:2]) != tuple(nbr0.shape)
            or tuple(qs.shape) != (q, d)):
        raise ValueError(
            f"packed_hop shapes: pool {tuple(pool_d.shape)}/"
            f"{tuple(pool_p.shape)}, sel {tuple(sel_flat.shape)}, nbr0 "
            f"{tuple(nbr0.shape)}, nbr_vals {tuple(nbr_vals.shape)}, qs "
            f"{tuple(qs.shape)}, ef={ef}")
    if len({t.device for t in (pool_d, pool_p, sel_flat, nbr0, nbr_vals,
                               qs)}) != 1:
        raise ValueError("packed_hop inputs must be on one device")
    out_d = torch.empty((q, ef), dtype=torch.float32, device=pool_d.device)
    out_p = torch.empty((q, ef), dtype=torch.int32, device=pool_d.device)
    if q == 0:
        return out_d, out_p
    e_sel = sel_flat.shape[0] // q
    if ef + e_sel * m2 > MAX_WIDTH:
        raise ValueError(f"packed_hop sorts at most {MAX_WIDTH} lanes per "
                         f"row; ef + W = {ef + e_sel * m2}")
    lib = _cuda.lib()
    with torch.cuda.device(pool_d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pgvt_packed_hop(
            pool_d.data_ptr(), pool_p.data_ptr(), sel_flat.data_ptr(),
            nbr0.data_ptr(), nbr_vals.data_ptr(), qs.data_ptr(), q, ef,
            e_sel, m2, d, int(nbr_vals.dtype == torch.bfloat16),
            _METRIC_CODE[metric], out_d.data_ptr(), out_p.data_ptr(), stream)
    _cuda.check(err, "pgvt_packed_hop")
    packed_hop.launches += 1
    return out_d, out_p


packed_hop.launches = 0
