"""K7 — the greedy ef = 1 descent of the HNSW search over the upper levels
of a dense index, every level in one launch; replaces the JAX package's
``greedy_descent`` / ``_greedy_body``
(``pgvector_tpu/index/hnsw_kernels.py:703-740``, an XLA
``lax.while_loop`` with no Pallas kernel).

One call takes the (N, D) f32, bf16 or f16 value table, the upper lists
``nbr_up`` (slots, L, m) and ``up_slot`` (cap,) int32, the (Q, D) queries,
each query's starting element ``cur`` (int32) and its distance ``cur_d``
(f32), and walks the levels ``level_hi`` down to ``level_lo``.  At each
level a query repeats the greedy step until it no longer moves, at most
``max_steps`` steps:

1. the element's m-wide list ``nbr_up[up_slot[cur], level-1]`` (an
   element with no slot has no list; a listed id at or past the value
   table's rows counts as -1);
2. the listed ids' rows scored in f32 (:func:`.distance.dense_point_scores`,
   -1 at +inf);
3. the first minimum, as ``torch.argmin`` takes it (a NaN first);
4. a move only if its distance is below ``cur_d``.

Each query's walk depends on that query alone, so its end is the batched
loop's, step cap included.  :func:`greedy_walk` launches
``csrc/greedy_walk.cu`` for CUDA tensors and takes
:func:`greedy_walk_plain` only for CPU tensors.  The kernel sums each
distance in another order than ``torch.sum``, so the two agree on
distances within f32 tolerance and on ids apart from ties.
"""

from __future__ import annotations

import torch

from ..utils.telemetry import host_read
from . import _cuda
from .distance import dense_point_scores
from .gather_hop import _DTYPES, _METRIC_CODE, hop_lists
from .metric import Metric


def walk_step(values: torch.Tensor, nbr_up: torch.Tensor,
              up_slot: torch.Tensor, qs: torch.Tensor, cur: torch.Tensor,
              cur_d: torch.Tensor, level: int, metric: Metric):
    """One greedy step of every query at ``level`` >= 1: each element's
    list (:func:`.gather_hop.hop_lists`: -1 where it has none, and for
    ids at or past the value table's rows), the lists' scores, the first
    minimum and the move.  Returns (cur, cur_d, moved, the (Q, m) lists
    read)."""
    nbrs = hop_lists(cur[:, None], None, nbr_up, up_slot, level,
                     values.shape[0])
    nd = dense_point_scores(metric, qs,
                            values[torch.clamp(nbrs, min=0).long()], nbrs)
    best = torch.argmin(nd, dim=1, keepdim=True)  # first minimum, NaN first
    best_d = torch.gather(nd, 1, best)[:, 0]
    move = best_d < cur_d
    return (torch.where(move, torch.gather(nbrs, 1, best)[:, 0], cur),
            torch.where(move, best_d, cur_d), move, nbrs)


def greedy_walk_plain(values: torch.Tensor, nbr_up: torch.Tensor,
                      up_slot: torch.Tensor, qs: torch.Tensor,
                      cur: torch.Tensor, cur_d: torch.Tensor, level_hi: int,
                      level_lo: int, metric: Metric, max_steps: int = 512):
    """Plain PyTorch K7: the batched walk, level by level, :func:`walk_step`
    until no query moves, one host read of "did any query move" a step
    (``descent.moved``).  Returns (cur, cur_d)."""
    for level in range(level_hi, level_lo - 1, -1):
        for _ in range(max_steps):
            cur, cur_d, move, _ = walk_step(values, nbr_up, up_slot, qs, cur,
                                            cur_d, level, metric)
            host_read("descent.moved")
            if not bool(move.any()):
                break
    return cur, cur_d


#: the wrapper's inputs: name, dtype (None: f32, bf16 or f16) and rank
_INPUTS = (("values", None, 2), ("nbr_up", torch.int32, 3),
           ("up_slot", torch.int32, 1), ("qs", None, 2),
           ("cur", torch.int32, 1), ("cur_d", torch.float32, 1))


def greedy_walk(values: torch.Tensor, nbr_up: torch.Tensor,
                up_slot: torch.Tensor, qs: torch.Tensor, cur: torch.Tensor,
                cur_d: torch.Tensor, level_hi: int, level_lo: int,
                metric: Metric, max_steps: int = 512):
    """K7 wrapper: the (N, D) f32, bf16 or f16 ``values``, ``nbr_up``
    (slots, L, m) and ``up_slot`` (cap,) int32, the (Q, D) f32, bf16 or
    f16 queries ``qs``, the (Q,) int32 starting elements ``cur`` and their
    (Q,) f32 distances ``cur_d``, the levels ``level_hi`` down to
    ``level_lo`` (1 <= level_lo <= level_hi <= L) and the steps a level.
    Returns new (cur, cur_d).  CUDA tensors launch the kernel; CPU tensors
    take :func:`greedy_walk_plain`.  ``launches`` counts every launch."""
    if not values.is_cuda:
        return greedy_walk_plain(values, nbr_up, up_slot, qs, cur, cur_d,
                                 level_hi, level_lo, metric, max_steps)
    dev = values.device
    inputs = (values, nbr_up, up_slot, qs, cur, cur_d)
    for t, (name, dtype, ndim) in zip(inputs, _INPUTS):
        if (t.device != dev or t.dim() != ndim or not t.is_contiguous()
                or (t.dtype not in _DTYPES if dtype is None
                    else t.dtype != dtype)):
            _cuda.check_tensor(t, name, dtype or t.dtype, ndim)
            raise ValueError(f"greedy_walk's {name} must be on {dev}, and "
                             f"values and qs f32, bf16 or f16, got "
                             f"{t.device}, {t.dtype}")
    q, d = qs.shape
    if (values.shape[1] != d or values.shape[0] == 0 or up_slot.shape[0] == 0
            or nbr_up.shape[0] == 0 or nbr_up.shape[2] == 0
            or tuple(cur.shape) != (q,) or tuple(cur_d.shape) != (q,)
            or not 1 <= level_lo <= level_hi <= nbr_up.shape[1]
            or max_steps < 0):
        raise ValueError(
            f"greedy_walk shapes: values {tuple(values.shape)}, nbr_up "
            f"{tuple(nbr_up.shape)}, up_slot {tuple(up_slot.shape)}, qs "
            f"{tuple(qs.shape)}, cur {tuple(cur.shape)}, cur_d "
            f"{tuple(cur_d.shape)}, levels {level_hi}..{level_lo}, "
            f"max_steps={max_steps}")
    out_cur, out_d = torch.empty_like(cur), torch.empty_like(cur_d)
    if q == 0:
        return out_cur, out_d
    lib = _cuda.lib()

    def launch():
        return lib.pgvt_greedy_walk(
            values.data_ptr(), values.shape[0], _DTYPES[values.dtype],
            nbr_up.data_ptr(), nbr_up.shape[0], nbr_up.shape[1],
            nbr_up.shape[2], up_slot.data_ptr(), up_slot.shape[0],
            qs.data_ptr(), _DTYPES[qs.dtype], q, d, cur.data_ptr(),
            cur_d.data_ptr(), level_hi, level_lo, max_steps,
            _METRIC_CODE[metric], out_cur.data_ptr(), out_d.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    _cuda.check(err, "pgvt_greedy_walk")
    greedy_walk.launches += 1
    return out_cur, out_d


greedy_walk.launches = 0
