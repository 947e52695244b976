"""K2 — one whole hop of the packed HNSW layer-0 beam search; replaces
``pgvector_tpu.ops.pallas_hop`` and the packed hop around it
(``pgvector_tpu.index.hnsw_kernels._hop_body``, its Pallas-tail branch:
the E-selection, the neighbor lists, the slab scores and the tail).

One call takes the sorted ef pool, packed as (Q, ef) f32 distances and
(Q, ef) int32 ``id·2 | expanded``, the level-0 lists ``nbr0`` (cap, 2m),
the adjacency-packed slabs ``nbr_vals[cap, 2m, D]`` (each element's
neighbor values, one contiguous block) and the previous hop's ``done``
flags and hop counts, and returns the next packed pool, each query's
``done`` flag, the count of queries not done and each query's hops:

1. the E-selection (:func:`.gather_hop.select_expand`): the first E
   unexpanded lanes in the order of ``torch.argmin`` (E = 1) or of a
   stable sort (E > 1), ``done`` when the first is infinite or worse than
   the pool's worst; a selected lane is expanded when finite, not past the
   worst and its query not done;
2. the W = E·2m candidates ``nbr0[s]``, selection-major in adjacency
   order (-1 where s is -1 or the slot is empty);
3. the reference tail's dedupe: a candidate already in the pool is masked
   (the pool's copy and its expanded flag survive), and so is one whose id
   came at an earlier position of the hop;
4. the others scored against the query from their slabs in f32 (the
   metrics of :func:`.distance.dense_point_scores`), or, for an int8 slab
   (``int8 = (qc, sq, q2, pnorm2, scale)``, the query quantized once a
   search, :func:`.distance.int8_query`), as
   :func:`.distance.int8_point_scores` scores them;
5. the merge in the tail's order (``pallas_hop._tail_kernel``): lanes with
   no id, at ±inf or at ``BIG`` (3e38) and beyond are empty, the rest by
   a stable sort on distance, NaN after the empty ones; the first ef kept,
   +inf / -2 in the empty ones;
6. a query done on entry keeps its pool and hop count; every other one
   counts one more hop, up to and including the hop that finds it done.

:func:`packed_hop` launches ``csrc/packed_hop.cu`` for CUDA tensors and
takes :func:`packed_hop_plain` only for CPU tensors.  For f32 and bf16
slabs, and for int8 under L1, the kernel sums each distance in another
order than ``torch.sum``, so the two agree on distances within f32
tolerance and on ids apart from ties; for int8 under L2, inner product
and cosine the distances are equal bit for bit.  The selection, the ids,
the masks and, given the same distances, the merge are the plain
version's exactly.  The pool holds each id once (every lane that enters
it is checked against it), as the kernel's pool scan assumes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .distance import dense_point_scores, int8_point_scores
from .gather_hop import (_METRIC_CODE, _ptr, check_out, check_state,
                         hop_buffers, hop_state, select_expand)
from .hop_tail import BIG, MAX_WIDTH
from .metric import Metric

#: the kernel's slab codes
_SLABS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
_SLAB_CODE = {"f32": 0, "bf16": 1, "int8": 2}
#: the kernel's scoring paths: slabs through the bulk-copy ring, or rows
#: read from device memory as single values (slab rows or base not a
#: multiple of 16 bytes)
PATHS = ("bulk", "scalar")


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


def hop_candidates(sel: torch.Tensor, nbr0: torch.Tensor,
                   pool_p: torch.Tensor) -> torch.Tensor:
    """(Q, E) expanded element ids → the (Q, E·2m) candidate ids of the
    hop, -1 where the element is -1, the slot empty, the id already in
    the pool or seen at an earlier position of the hop."""
    q = sel.shape[0]
    live = (sel >= 0) & (sel < nbr0.shape[0])
    nbrs = torch.where(live[..., None], nbr0[torch.where(live, sel, 0).long()],
                       -1).reshape(q, -1)
    nbrs = torch.where(nbrs >= 0, nbrs, -1)
    in_pool = torch.any(nbrs[:, :, None] == (pool_p >> 1)[:, None, :], dim=2)
    # a stable sort by id is the (id, position) order: the first copy stays
    none = torch.iinfo(torch.int32).max  # after every id
    key_s, perm = torch.sort(torch.where(nbrs >= 0, nbrs, none), dim=1,
                             stable=True)
    rep = torch.zeros_like(key_s, dtype=torch.bool)
    rep[:, 1:] = (key_s[:, 1:] == key_s[:, :-1]) & (key_s[:, 1:] != none)
    rep = torch.zeros_like(rep).scatter_(1, perm, rep)
    return torch.where(in_pool | rep, -1, nbrs)


def tail_merge(pool_d: torch.Tensor, pool_p: torch.Tensor,
               cand_d: torch.Tensor, cand_i: torch.Tensor, ef: int):
    """The reference tail's merge of deduped candidates into the pool:
    lanes with no id, at ±inf or at :data:`.hop_tail.BIG` and beyond sort
    as empty (+inf), NaN after them, the rest by a stable sort on
    distance; the first ef, +inf / -2 in the empty ones."""
    d = torch.cat([pool_d, cand_d], dim=1)
    p = torch.cat([pool_p, cand_i * 2], dim=1)
    empty = (p < 0) | torch.isinf(d) | (d >= BIG)
    d, order = torch.sort(torch.where(empty, torch.inf, d), dim=1,
                          stable=True)
    d, order = d[:, :ef], order[:, :ef]
    empty = torch.isinf(d)
    return d, torch.where(empty, -2, torch.gather(p, 1, order))


def packed_hop_plain(pool_d: torch.Tensor, pool_p: torch.Tensor,
                     nbr0: torch.Tensor, nbr_vals: torch.Tensor,
                     qs: torch.Tensor, ef: int, expand: int, metric: Metric,
                     int8: Optional[tuple] = None, *, done=None, hops=None,
                     out=None):
    """Plain PyTorch K2, the whole hop: :func:`.gather_hop.select_expand`,
    :func:`hop_candidates`, the slab gather and
    :func:`.distance.dense_point_scores` (or
    :func:`.distance.int8_point_scores`), :func:`tail_merge` and
    :func:`.gather_hop.hop_state`.  Returns (pool_d, pool_p, done, left,
    hops); ``out`` (the kernel's output buffers) is not used."""
    nq = pool_d.shape[0]
    expand = min(expand, ef)
    new_p, sel, found = select_expand(pool_d, pool_p, ef, expand)
    nbrs = hop_candidates(sel, nbr0, new_p)
    w = nbrs.shape[1]
    safe = torch.where((sel >= 0) & (sel < nbr0.shape[0]), sel, 0).long()
    v = nbr_vals[safe].reshape(nq, w, nbr_vals.shape[-1])
    if int8 is None:
        nd = dense_point_scores(metric, qs, v, nbrs)
    else:
        qc, sq, q2, pnorm2, scale = int8
        nd = int8_point_scores(metric, qs, scale, pnorm2, v, nbrs,
                               query=(qc, sq, q2))
    d, p = tail_merge(pool_d, new_p, nd, nbrs, ef)
    return hop_state(pool_d, pool_p, d, p, found, done, hops)


def packed_hop(pool_d: torch.Tensor, pool_p: torch.Tensor,
               nbr0: torch.Tensor, nbr_vals: torch.Tensor, qs: torch.Tensor,
               ef: int, expand: int, metric: Metric,
               int8: Optional[tuple] = None, *, done=None, hops=None,
               out=None):
    """K2 wrapper: pool (Q, ef) f32 distances and int32 packed ids
    (``id·2 | expanded``), ``nbr0`` (cap, 2m) int32, ``nbr_vals`` (cap,
    2m, D) f32, bf16 or int8, ``qs`` (Q, D) f32, E = ``expand``; an int8
    slab also takes ``int8 = (qc, sq, q2, pnorm2, scale)``: (Q, D) int8,
    (Q,), (Q,), (rows,) and (D,) f32; ``done`` (Q,) bool and ``hops``
    (Q,) int32 are the previous hop's (None: none done, no hops).  Returns
    (pool_d, pool_p, done, left (1,) int32, hops), written into ``out``
    where it is given (:func:`.gather_hop.hop_buffers`, whose scratch is
    zero before its first launch; launches that share it run one after
    another).  CUDA tensors launch the kernel; CPU tensors take
    :func:`packed_hop_plain`.  ``launches`` counts every launch,
    ``launches_by_slab`` each slab type's and ``launches_by_path`` each
    scoring path's (:data:`PATHS`)."""
    if not pool_d.is_cuda:
        return packed_hop_plain(pool_d, pool_p, nbr0, nbr_vals, qs, ef,
                                expand, metric, int8, done=done, hops=hops)
    _cuda.check_tensor(pool_d, "pool_d", torch.float32, 2)
    _cuda.check_tensor(pool_p, "pool_p", torch.int32, 2)
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
            or tuple(nbr_vals.shape[:2]) != tuple(nbr0.shape)
            or tuple(qs.shape) != (q, d) or expand < 1):
        raise ValueError(
            f"packed_hop shapes: pool {tuple(pool_d.shape)}/"
            f"{tuple(pool_p.shape)}, nbr0 {tuple(nbr0.shape)}, nbr_vals "
            f"{tuple(nbr_vals.shape)}, qs {tuple(qs.shape)}, ef={ef}, "
            f"expand={expand}")
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
    dev = pool_d.device
    if len({t.device for t in (pool_d, pool_p, nbr0, nbr_vals, qs,
                               *extra)}) != 1:
        raise ValueError("packed_hop inputs must be on one device")
    check_state(done, hops, q, dev)
    if out is None:
        out = hop_buffers(q, ef, dev)
    check_out(out, pool_d, pool_p, q, "packed_hop")
    out_d, out_p, out_done, left, out_hops, work = out
    if q == 0:
        return out_d, out_p, out_done, left.zero_(), out_hops
    expand = min(expand, ef)
    if ef + expand * m2 > MAX_WIDTH:
        raise ValueError(f"packed_hop sorts at most {MAX_WIDTH} lanes per "
                         f"row; ef + W = {ef + expand * m2}")
    lib = _cuda.lib()
    path = ctypes.c_int(-1)

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        return lib.pgvt_packed_hop(
            pool_d.data_ptr(), pool_p.data_ptr(), nbr0.data_ptr(),
            nbr0.shape[0], m2, nbr_vals.data_ptr(), _SLAB_CODE[slab],
            qs.data_ptr(), *(_ptr(t) for t in (extra or (None,) * 5)),
            _ptr(done), _ptr(hops), q, ef, expand, d, _METRIC_CODE[metric],
            out_d.data_ptr(), out_p.data_ptr(), out_done.data_ptr(),
            out_hops.data_ptr(), work.data_ptr(), left.data_ptr(),
            ctypes.addressof(path), stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    _cuda.check(err, "pgvt_packed_hop")
    packed_hop.launches += 1
    packed_hop.launches_by_slab[slab] += 1
    packed_hop.launches_by_path[PATHS[path.value]] += 1
    return out_d, out_p, out_done, left, out_hops


packed_hop.launches = 0
packed_hop.launches_by_slab = dict.fromkeys(_SLABS.values(), 0)
packed_hop.launches_by_path = dict.fromkeys(PATHS, 0)
