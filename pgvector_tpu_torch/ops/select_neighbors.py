"""K3 — SelectNeighbors (Algorithm 4, hnswutils.c:1062-1163) over a batch
of candidate pools; replaces the XLA program of
``pgvector_tpu.index.hnsw_kernels.select_neighbors`` under
``select_neighbors_batch`` (its keep/prune ``fori_loop``).

Each of the T rows is a pool of C candidates with base distances, a
(C, C) pairwise block, validity and sticky ``forced`` flags.  For dense
L2, inner product and cosine the block comes as its :class:`Gram` form,
the (T, C, C) products ``ip`` and (for L2) the (T, C) norms ``sq``, and
each entry is formed where it is needed as ``_pairwise_dists`` forms it
(:func:`form_pairs`); L1, bit and sparse pools pass the formed block.
Candidates are visited closest first (a stable sort); one is kept when it
is forced or closer to the base than to every kept candidate, while fewer
than lm are kept (the cap applies in pop order to forced candidates too).
The lm slots go to the kept candidates in distance order, then to the
closest pruned ones as backfill (keepPrunedConnections,
hnswutils.c:1133-1156).

:func:`select_neighbors` launches ``csrc/select_neighbors.cu`` for CUDA
tensors and takes :func:`select_neighbors_plain` only for CPU tensors.
The kernel forms an entry with the plain version's rounded operations,
only compares and takes minima, and its rank is the plain version's one
f32 add, so both return the same positions and flags bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import _cuda

BIG = 3.0e38


class Gram(NamedTuple):
    """The pairwise block of a dense pool in its product form: ``ip`` the
    (T, C, C) f32 products of the candidates' values, ``sq`` their (T, C)
    squared norms (L2; None otherwise) and ``l2``: the entries are
    ``(sq_i - 2·ip_ij) + sq_j`` clamped at 0 (L2) or ``-ip_ij`` (inner
    product and cosine)."""
    ip: torch.Tensor
    sq: Optional[torch.Tensor]
    l2: bool


def form_pairs(gram: Gram, valid: torch.Tensor) -> torch.Tensor:
    """The (T, C, C) pairwise distances of a :class:`Gram` form, +inf
    where either candidate is invalid: the ops of ``_pairwise_dists``."""
    ip = gram.ip
    if gram.l2:
        sq = gram.sq
        d = torch.clamp(sq[:, :, None] - 2.0 * ip + sq[:, None, :], min=0.0)
    else:
        d = -ip
    return torch.where(valid[:, :, None] & valid[:, None, :], d, torch.inf)


def select_neighbors_plain(base_d: torch.Tensor,
                           pair_d: Union[torch.Tensor, Gram],
                           valid: torch.Tensor, lm: int,
                           forced: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: a :class:`Gram` form made into its block
    (:func:`form_pairs`), the pool permuted into closest-first order once,
    then one step a column, so step t reads column t of every tensor."""
    if isinstance(pair_d, Gram):
        pair_d = form_pairs(pair_d, valid)
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


def select_neighbors(base_d: torch.Tensor,
                     pair_d: Union[torch.Tensor, Gram], valid: torch.Tensor,
                     lm: int, forced: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 wrapper: ``base_d`` (T, C) f32, ``pair_d`` the (T, C, C) f32
    block or its :class:`Gram` form, ``valid`` and ``forced`` (T, C) bool
    (``forced`` may be None), the cap ``lm`` → ((T, lm) int32 selected
    positions, -1 padded; (T, lm) bool kept flags).  CUDA tensors launch
    the kernel; CPU tensors take :func:`select_neighbors_plain`.
    ``launches`` counts every launch."""
    if not base_d.is_cuda:
        return select_neighbors_plain(base_d, pair_d, valid, lm, forced)
    gram = isinstance(pair_d, Gram)
    block = pair_d.ip if gram else pair_d
    _cuda.check_tensor(base_d, "base_d", torch.float32, 2)
    _cuda.check_tensor(block, "pair_d", torch.float32, 3)
    _cuda.check_tensor(valid, "valid", torch.bool, 2)
    t_rows, c = base_d.shape
    flags = (valid,) if forced is None else (valid, forced)
    if forced is not None:
        _cuda.check_tensor(forced, "forced", torch.bool, 2)
    sq = pair_d.sq if gram and pair_d.l2 else None
    if sq is not None:
        _cuda.check_tensor(sq, "sq", torch.float32, 2)
    if (tuple(block.shape) != (t_rows, c, c)
            or any(tuple(f.shape) != (t_rows, c) for f in flags)
            or (gram and pair_d.l2
                and (sq is None or tuple(sq.shape) != (t_rows, c)))
            or lm < 1):
        raise ValueError(
            f"select_neighbors shapes: base_d {tuple(base_d.shape)}, "
            f"pair_d {tuple(block.shape)}, valid {tuple(valid.shape)}, "
            f"forced {None if forced is None else tuple(forced.shape)}, "
            f"sq {None if sq is None else tuple(sq.shape)}, lm={lm}")
    tensors = (base_d, block, *flags) + ((sq,) if sq is not None else ())
    if len({t.device for t in tensors}) != 1:
        raise ValueError("select_neighbors inputs must be on one device")
    pos = torch.empty((t_rows, lm), dtype=torch.int32, device=base_d.device)
    kept = torch.empty((t_rows, lm), dtype=torch.bool, device=base_d.device)
    if t_rows == 0:
        return pos, kept
    mode = (1 if pair_d.l2 else 2) if gram else 0
    lib = _cuda.lib()
    with torch.cuda.device(base_d.device):
        err = lib.pgvt_select_neighbors(
            base_d.data_ptr(), block.data_ptr(),
            sq.data_ptr() if sq is not None else None, mode,
            valid.data_ptr(),
            forced.data_ptr() if forced is not None else None, t_rows, c,
            lm, pos.data_ptr(), kept.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "pgvt_select_neighbors")
    select_neighbors.launches += 1
    return pos, kept


select_neighbors.launches = 0
