"""K6 — one fused hop of the HNSW beam search over rows gathered by id;
replaces the row-gather branch of
``pgvector_tpu.index.hnsw_kernels._hop_body`` (the Knuth-keyed dedupe, the
pool membership mask, the row scores and ``_hop_merge``) for dense values
with no visited table and no discarded pool.

Given each query row's E expanded element ids (``sel_flat``, -1 for none)
and their neighbor lists ``nb`` (Q·E, 2m) (the lists
``neighbors_of(sel_flat)`` gathers; an upper level's m-wide lists come
padded to 2m with -1), the hop takes the W = E·2m candidates — with E > 1
deduplicated and in the order of the Knuth key ``id·2654435761 mod 2^32``
(:func:`dedupe_hop`), with E = 1 in adjacency order — masks those already
in the pool, scores the others' rows of the (N, D) value table against the
query in f32 (:func:`.distance.dense_point_scores`) and merges them into
the ef pool by a stable sort on distance.  No (Q, W, D) tensor and no
(Q, W) score block reach device memory.

:func:`gather_hop` launches ``csrc/gather_hop.cu`` for CUDA tensors and
takes :func:`gather_hop_plain` only for CPU tensors.  The kernel sums each
distance in another order than ``torch.sum``, so the two agree on
distances within f32 tolerance and on ids apart from ties; given the same
distances the merge is the same (``csrc/hop_merge.cuh``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda
from .distance import dense_point_scores
from .hop_tail import MAX_WIDTH
from .metric import Metric
from .packed_hop import _METRIC_CODE

#: Knuth's multiplicative hash and its inverse mod 2^32: a bijection on
#: ids, so equal keys ⇔ equal ids, and the permuted order is unbiased
_PERM = 2654435761
_PERM_INV = 244002641
_MASK32 = 0xFFFFFFFF

#: the kernel's dtype codes, of the value table and of the queries
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dedupe_hop(nbrs: torch.Tensor) -> torch.Tensor:
    """Dedupe one hop's (Q, W) candidate ids (two expanded nodes sharing a
    neighbor): sort by the Knuth permutation of the id and mask adjacent
    equals (-1 at the repeats and at the end, where the -1 keys sort)."""
    inval = _MASK32  # no id < 2^30 maps here
    key = torch.where(nbrs >= 0, (nbrs.long() * _PERM) & _MASK32, inval)
    key, _ = torch.sort(key, dim=1)
    dup = torch.zeros_like(key, dtype=torch.bool)
    dup[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] != inval)
    ids = ((key * _PERM_INV) & _MASK32).to(torch.int32)
    return torch.where(dup | (key == inval), -1, ids)


def gather_hop_plain(pool_d: torch.Tensor, pool_p: torch.Tensor,
                     sel_flat: torch.Tensor, nb: torch.Tensor,
                     rows: torch.Tensor, qs: torch.Tensor, ef: int,
                     metric: Metric) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6: the candidates (:func:`dedupe_hop` with E > 1),
    the pool membership mask, the row gather and
    :func:`.distance.dense_point_scores`, then the stable merge."""
    nq = pool_d.shape[0]
    nbrs = torch.where(sel_flat[:, None] >= 0, nb, -1).reshape(nq, -1)
    if sel_flat.shape[0] > nq:
        nbrs = dedupe_hop(nbrs)
    # pool-membership check keeps the ef pool duplicate-free
    in_pool = torch.any(nbrs[:, :, None] == (pool_p >> 1)[:, None, :], dim=2)
    nbrs = torch.where(in_pool, -1, nbrs)
    nd = dense_point_scores(metric, qs, rows[torch.clamp(nbrs, min=0).long()],
                            nbrs)
    # (id·2 | expanded) rides a stable sort by distance (-1 packs to -2)
    d = torch.cat([pool_d, nd], dim=1)
    packed = torch.cat([pool_p, nbrs * 2], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :ef], torch.gather(packed, 1, order[:, :ef])


def gather_hop(pool_d: torch.Tensor, pool_p: torch.Tensor,
               sel_flat: torch.Tensor, nb: torch.Tensor, rows: torch.Tensor,
               qs: torch.Tensor, ef: int, metric: Metric
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper: pool (Q, ef) f32 distances and int32 packed ids
    (``id·2 | expanded``), ``sel_flat`` (Q·E,) int32 expanded element
    ids, ``nb`` (Q·E, 2m) int32 their neighbor lists, ``rows`` the (N, D)
    f32, bf16 or f16 value table, ``qs`` (Q, D) f32, bf16 or f16 queries.
    Returns the new (Q, ef) pool, distances and packed ids.  CUDA tensors
    launch the kernel (which skips ids at or past N: the graph holds none);
    CPU tensors take :func:`gather_hop_plain`.  ``launches`` counts every
    launch."""
    if not pool_d.is_cuda:
        return gather_hop_plain(pool_d, pool_p, sel_flat, nb, rows, qs, ef,
                                metric)
    _cuda.check_tensor(pool_d, "pool_d", torch.float32, 2)
    _cuda.check_tensor(pool_p, "pool_p", torch.int32, 2)
    _cuda.check_tensor(sel_flat, "sel_flat", torch.int32, 1)
    _cuda.check_tensor(nb, "nb", torch.int32, 2)
    _cuda.check_tensor(rows, "rows", rows.dtype, 2)
    _cuda.check_tensor(qs, "qs", qs.dtype, 2)
    if rows.dtype not in _DTYPES or qs.dtype not in _DTYPES:
        raise ValueError(f"rows and qs must be f32, bf16 or f16, got "
                         f"{rows.dtype} and {qs.dtype}")
    q, d = pool_d.shape[0], rows.shape[1]
    if (tuple(pool_p.shape) != (q, ef) or pool_d.shape[1] != ef
            or sel_flat.shape[0] % max(q, 1)
            or nb.shape[0] != sel_flat.shape[0]
            or tuple(qs.shape) != (q, d) or rows.shape[0] == 0):
        raise ValueError(
            f"gather_hop shapes: pool {tuple(pool_d.shape)}/"
            f"{tuple(pool_p.shape)}, sel {tuple(sel_flat.shape)}, nb "
            f"{tuple(nb.shape)}, rows {tuple(rows.shape)}, qs "
            f"{tuple(qs.shape)}, ef={ef}")
    if len({t.device for t in (pool_d, pool_p, sel_flat, nb, rows, qs)}) != 1:
        raise ValueError("gather_hop inputs must be on one device")
    out_d = torch.empty((q, ef), dtype=torch.float32, device=pool_d.device)
    out_p = torch.empty((q, ef), dtype=torch.int32, device=pool_d.device)
    if q == 0:
        return out_d, out_p
    e_sel, m2 = sel_flat.shape[0] // q, nb.shape[1]
    if ef + e_sel * m2 > MAX_WIDTH:
        raise ValueError(f"gather_hop sorts at most {MAX_WIDTH} lanes per "
                         f"row; ef + W = {ef + e_sel * m2}")
    lib = _cuda.lib()
    with torch.cuda.device(pool_d.device):
        err = lib.pgvt_gather_hop(
            pool_d.data_ptr(), pool_p.data_ptr(), sel_flat.data_ptr(),
            nb.data_ptr(), rows.data_ptr(), rows.shape[0], qs.data_ptr(), q,
            ef, e_sel, m2, d, _DTYPES[rows.dtype], _DTYPES[qs.dtype],
            _METRIC_CODE[metric], out_d.data_ptr(), out_p.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "pgvt_gather_hop")
    gather_hop.launches += 1
    return out_d, out_p


gather_hop.launches = 0
