"""Exact top-k engines — counterpart of ``pgvector_tpu.ops.topk``.

The exact-search ground truth (pgvector's no-index path: a seq scan feeding
``ORDER BY distance LIMIT k``) becomes a scan over DB tiles.  The tiled
engine merges each tile's (Q, T) score block into a running (Q, k)
result; the grouped engine reduces each block to per-group minima, picks
the k best groups and re-scores their rows.  Peak memory is O(Q·T), never
O(Q·N).

Ties: ``lax.top_k`` breaks ties toward the lower index, and ``torch.topk``
promises no order, so selection here is a stable ascending sort sliced to
k.  Running results sit before the tile in every merge, so equal distances
keep the lower row id.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

#: device bytes the grouped engine's refine may gather a step: the
#: (Q, chunk, row) f32 block ``score_rows`` materializes (topk.py:23)
REFINE_BYTES = 2**30


def topk_smallest(
    scores: torch.Tensor, k: int, ids: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis, ties to the lower index.  Returns
    (dists, indices); when ``ids`` is given, indices are translated
    through it."""
    d, sel = torch.sort(scores, dim=-1, stable=True)
    d, sel = d[..., :k], sel[..., :k]
    if ids is not None:
        if ids.ndim == 1:
            sel = ids[sel]
        else:
            sel = torch.gather(ids, -1, sel)
    return d, sel


def merge_topk(
    d_a: torch.Tensor, i_a: torch.Tensor, d_b: torch.Tensor, i_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (…, ka)/(…, kb) candidate sets into the smallest k."""
    d = torch.cat([d_a, d_b], dim=-1)
    i = torch.cat([i_a, i_b], dim=-1)
    return topk_smallest(d, k, ids=i)


def tiled_topk(
    score_tile: Callable[..., torch.Tensor],
    db_cols: Tuple[torch.Tensor, ...],
    n: int,
    k: int,
    tile: int = 8192,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream the database through ``score_tile`` and keep the smallest k.

    ``db_cols`` is a tuple of tensors with leading axis N; ``score_tile``
    maps one tile of each column to a (Q, T) score block.  ``valid`` masks
    deleted rows.  Returns (dists, ids) of shape (Q, k), ids int32; empty
    slots hold +inf / -1.  The ragged last tile is scored as it is: the
    reference pads it with invalid rows, which never enter the result."""
    tile = min(tile, max(n, 1))
    best_d = best_i = None
    for start in range(0, max(n, 1), tile):  # n == 0: one empty tile
        end = min(start + tile, n)
        s = score_tile(*(c[start:end] for c in db_cols)).float()
        if valid is not None:
            s = torch.where(valid[start:end][None, :], s, torch.inf)
        ids = torch.arange(start, end, dtype=torch.int32, device=s.device)
        ids = ids.expand(s.shape[0], -1)
        if best_d is None:
            best_d = torch.full((s.shape[0], k), torch.inf, device=s.device)
            best_i = torch.full((s.shape[0], k), -1, dtype=torch.int32,
                                device=s.device)
        best_d, best_i = merge_topk(best_d, best_i, s, ids, k)
        # deleted rows carry +inf scores; keep their ids at -1
        best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i


def grouped_exact_topk(
    score_tile: Callable[..., torch.Tensor],
    score_rows: Callable[[torch.Tensor], torch.Tensor],
    db_cols: Tuple[torch.Tensor, ...],
    n: int,
    k: int,
    group: int = 16,
    tile: int = 65536,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by group-min filtering (``topk.py:49-143``): O(1)
    selection work per row instead of a merge per tile.

    1. **filter**: stream tiles of at most ``tile`` rows; each (Q, T)
       score block reduces to per-``group`` minima, ``gmins (Q, N/group)``.
    2. **select**: the k groups of smallest minimum per query.  Exact: the
       k nearest rows have distance ≤ d_k, every group holding one has
       its minimum ≤ d_k, and at most k groups can (ties at d_k may swap
       tied rows, a valid top-k either way).
    3. **refine**: gather the k·group candidate rows and re-score them
       exactly with ``score_rows`` ((Q, C) row ids → (Q, C) scores), in
       chunks under ``REFINE_BYTES`` merged into a running best.

    ``score_tile`` maps one tile of each of ``db_cols`` to a (Q, T) block.
    Ties break by candidate position (the selected groups in order, rows
    in order within a group), as ``lax.top_k`` breaks them in the
    reference.  Returns (dists, int32 ids) of shape (Q, k); empty slots
    hold +inf / -1."""
    tile = min(tile, max(n, group))
    tile = max(group, tile - tile % group)
    n_tiles = -(-n // tile)
    n_pad = n_tiles * tile
    gms = []
    for start in range(0, n_pad, tile):
        end = min(start + tile, n)
        s = score_tile(*(c[start:end] for c in db_cols)).float()
        if valid is not None:
            s = torch.where(valid[start:end][None, :], s, torch.inf)
        if end - start < tile:  # the reference pads with invalid rows
            s = torch.nn.functional.pad(s, (0, tile - (end - start)),
                                        value=torch.inf)
        gms.append(s.reshape(s.shape[0], tile // group, group).amin(dim=-1))
    gms = torch.cat(gms, dim=1)  # (Q, n_pad / group)
    q_count, dev = gms.shape[0], gms.device
    kk = min(k, gms.shape[1])
    _, gsel = topk_smallest(gms, kk)
    cand = (gsel[:, :, None] * group
            + torch.arange(group, device=dev)).reshape(q_count, kk * group)
    ok = cand < n
    if valid is not None:
        ok &= valid[torch.clamp(cand, max=n - 1)]
    safe = torch.where(ok, cand, 0)
    row_f32 = 4 * sum(max(1, math.prod(c.shape[1:])) for c in db_cols)
    cc = max(group,
             (REFINE_BYTES // max(1, q_count * row_f32)) // group * group)
    d = torch.full((q_count, k), torch.inf, device=dev)
    i = torch.full((q_count, k), -1, dtype=torch.int64, device=dev)
    if cc >= cand.shape[1]:
        s = torch.where(ok, score_rows(safe).float(), torch.inf)
        d, i = topk_smallest(s, min(k, s.shape[1]), ids=cand)
    else:
        for s0 in range(0, cand.shape[1], cc):
            o_blk = ok[:, s0:s0 + cc]
            s = torch.where(o_blk, score_rows(safe[:, s0:s0 + cc]).float(),
                            torch.inf)
            d, i = merge_topk(d, i, s, cand[:, s0:s0 + cc], k)
    if d.shape[1] < k:
        d = torch.cat([d, d.new_full((q_count, k - d.shape[1]), torch.inf)],
                      dim=1)
        i = torch.cat([i, i.new_full((q_count, k - i.shape[1]), -1)], dim=1)
    return d, torch.where(torch.isinf(d), -1, i).to(torch.int32)
