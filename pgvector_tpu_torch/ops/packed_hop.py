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

An int8 slab (the reference's int8 tier) comes with ``int8 = (qc, sq, q2,
pnorm2, scale)``, the query quantized once a search and the slab's norms
and scale (:func:`.distance.int8_query`), and is scored as
:func:`.distance.int8_point_scores` scores it: an exact int8 dot, then an
f32 close.

:func:`packed_hop` launches ``csrc/packed_hop.cu`` for CUDA tensors and
takes :func:`packed_hop_plain` only for CPU tensors.  For f32 and bf16
slabs, and for int8 under L1, the kernel sums each distance in another
order than ``torch.sum``, so the two agree on distances within f32
tolerance and on ids apart from ties; for int8 under L2, inner product
and cosine the distances are equal bit for bit.  Given the same distances
the tail is bit-identical (``csrc/hop_merge.cuh``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda
from .distance import dense_point_scores, int8_point_scores
from .hop_tail import MAX_WIDTH, hop_tail_plain
from .metric import Metric

#: the kernel's metric codes; cosine values are stored normalized and
#: ordered by -ip
_METRIC_CODE = {Metric.L2: 0, Metric.IP: 1, Metric.COSINE: 1, Metric.L1: 2}


def int8_l1_bound(d_plain: torch.Tensor, dim: int) -> torch.Tensor:
    """The largest |kernel - plain| of K2-int8's L1 distances.  Both sum
    the same ``dim`` nonnegative f32 terms ``|q - float(x) · scale|``
    (each rounded alike) in different orders; each sum lies within
    γ·S of the exact sum S, γ = (dim-1)·u / (1 - (dim-1)·u), u = 2^-24
    (recursive or tree summation alike), so the two differ by at most
    2γ·S ≤ 2γ·d / (1 - γ).  Zero where the distance is not finite."""
    g = (dim - 1) * 2.0**-24
    g = g / (1.0 - g)
    return torch.where(torch.isfinite(d_plain), d_plain * (2 * g / (1 - g)),
                       0.0)


def packed_hop_plain(pool_d: torch.Tensor, pool_p: torch.Tensor,
                     sel_flat: torch.Tensor, nbr0: torch.Tensor,
                     nbr_vals: torch.Tensor, qs: torch.Tensor, ef: int,
                     metric: Metric, int8: Optional[tuple] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2: the slab gather, :func:`dense_point_scores` (or
    :func:`int8_point_scores` for an int8 slab), then
    :func:`hop_tail_plain`."""
    nq = pool_d.shape[0]
    safe = torch.clamp(sel_flat, min=0).long()
    nbrs = torch.where(sel_flat[:, None] >= 0, nbr0[safe], -1).reshape(nq, -1)
    w = nbrs.shape[1]
    v = nbr_vals[safe].reshape(nq, w, nbr_vals.shape[-1])
    if int8 is None:
        nd = dense_point_scores(metric, qs, v, nbrs)
    else:
        qc, sq, q2, pnorm2, scale = int8
        nd = int8_point_scores(metric, qs, scale, pnorm2, v, nbrs,
                               query=(qc, sq, q2))
    return hop_tail_plain(pool_d, pool_p, nd, nbrs, ef, w)


def packed_hop(pool_d: torch.Tensor, pool_p: torch.Tensor,
               sel_flat: torch.Tensor, nbr0: torch.Tensor,
               nbr_vals: torch.Tensor, qs: torch.Tensor, ef: int,
               metric: Metric, int8: Optional[tuple] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: pool (Q, ef) f32 distances and int32 packed ids
    (``id·2 | expanded``), ``sel_flat`` (Q·E,) int32 expanded element ids,
    ``nbr0`` (cap, 2m) int32, ``nbr_vals`` (cap, 2m, D) f32, bf16 or int8,
    ``qs`` (Q, D) f32; an int8 slab also takes ``int8 = (qc, sq, q2,
    pnorm2, scale)``: (Q, D) int8, (Q,), (Q,), (rows,) and (D,) f32.
    Returns the new (Q, ef) pool, as :func:`.hop_tail.hop_tail` does.
    CUDA tensors launch the kernel; CPU tensors take
    :func:`packed_hop_plain`.  ``launches`` counts every launch,
    ``launches_by_slab`` each slab type's."""
    if not pool_d.is_cuda:
        return packed_hop_plain(pool_d, pool_p, sel_flat, nbr0, nbr_vals, qs,
                                ef, metric, int8)
    _cuda.check_tensor(pool_d, "pool_d", torch.float32, 2)
    _cuda.check_tensor(pool_p, "pool_p", torch.int32, 2)
    _cuda.check_tensor(sel_flat, "sel_flat", torch.int32, 1)
    _cuda.check_tensor(nbr0, "nbr0", torch.int32, 2)
    _cuda.check_tensor(nbr_vals, "nbr_vals", nbr_vals.dtype, 3)
    _cuda.check_tensor(qs, "qs", torch.float32, 2)
    slab = _SLABS.get(nbr_vals.dtype)
    if slab is None:
        raise ValueError(
            f"nbr_vals must be f32, bf16 or int8, got {nbr_vals.dtype}")
    if (slab == "int8") != (int8 is not None):
        raise ValueError("an int8 slab, and only an int8 slab, takes "
                         "int8=(qc, sq, q2, pnorm2, scale)")
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
    extra = ()
    if int8 is not None:
        qc, sq, q2, pnorm2, scale = int8
        _cuda.check_tensor(qc, "qc", torch.int8, 2)
        for name, t in (("sq", sq), ("q2", q2), ("pnorm2", pnorm2),
                        ("scale", scale)):
            _cuda.check_tensor(t, name, torch.float32, 1)
        if (tuple(qc.shape) != (q, d) or sq.shape[0] != q
                or q2.shape[0] != q or scale.shape[0] != d
                or pnorm2.shape[0] < nbr0.shape[0]):
            raise ValueError(
                f"packed_hop int8 shapes: qc {tuple(qc.shape)}, sq "
                f"{tuple(sq.shape)}, q2 {tuple(q2.shape)}, pnorm2 "
                f"{tuple(pnorm2.shape)}, scale {tuple(scale.shape)}")
        extra = (qc, sq, q2, pnorm2, scale)
    if len({t.device for t in (pool_d, pool_p, sel_flat, nbr0, nbr_vals,
                               qs, *extra)}) != 1:
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
        head = (pool_d.data_ptr(), pool_p.data_ptr(), sel_flat.data_ptr(),
                nbr0.data_ptr(), nbr_vals.data_ptr())
        tail = (_METRIC_CODE[metric], out_d.data_ptr(), out_p.data_ptr(),
                stream)
        if int8 is None:
            name = "pgvt_packed_hop"
            err = lib.pgvt_packed_hop(
                *head, qs.data_ptr(), q, ef, e_sel, m2, d,
                int(slab == "bf16"), *tail)
        else:
            name = "pgvt_packed_hop_int8"
            err = lib.pgvt_packed_hop_int8(
                *head, *(t.data_ptr() for t in extra), qs.data_ptr(), q, ef,
                e_sel, m2, d, *tail)
    _cuda.check(err, name)
    packed_hop.launches += 1
    packed_hop.launches_by_slab[slab] += 1
    return out_d, out_p


_SLABS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
packed_hop.launches = 0
packed_hop.launches_by_slab = dict.fromkeys(_SLABS.values(), 0)
