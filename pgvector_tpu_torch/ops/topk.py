"""Tiled top-k search engine — counterpart of ``pgvector_tpu.ops.topk``.

The exact-search ground truth (pgvector's no-index path: a seq scan feeding
``ORDER BY distance LIMIT k``) becomes a scan over DB tiles: each tile's
(Q, T) score block is merged into a running (Q, k) result.  Peak memory is
O(Q·T), never O(Q·N).

Ties: ``lax.top_k`` breaks ties toward the lower index, and ``torch.topk``
promises no order, so selection here is a stable ascending sort sliced to
k.  Running results sit before the tile in every merge, so equal distances
keep the lower row id.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


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
