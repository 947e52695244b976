"""Batched dense distances — counterpart of ``pgvector_tpu.ops.distance``
(the dense part; bit and sparse scores come with their tables).

Every function computes a full (Q, N) block: L2² / IP / cosine ride one
``q @ db.T`` product plus row norms, L1 is an elementwise reduction.
Distances are the *stored* forms used by index ordering (L2 → squared,
IP → negative, cosine → 1 - cos); ``metric.stored_to_user`` converts.
Accumulation is f32, like the reference kernels (src/vector.c:560-735).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..config import config
from .metric import Metric

#: compute.matmul_precision → torch.set_float32_matmul_precision.  JAX's
#: DEFAULT is one bf16 pass, HIGH three (about TF32), HIGHEST full f32.
_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


def dot_precision() -> str:
    """Apply ``compute.matmul_precision`` (config.py, default ``highest``)
    to torch's f32 matmuls and return the torch name.  pgvector accumulates
    in f32 (src/vector.c:560-574); a reduced-precision pairwise product
    cost the reference build recall in its first round (BASELINE.md)."""
    name = _PRECISION[config.get("compute.matmul_precision")]
    if torch.get_float32_matmul_precision() != name:
        torch.set_float32_matmul_precision(name)
    return name


@contextlib.contextmanager
def highest_precision() -> Iterator[None]:
    """Full f32 matmuls inside the block whatever ``compute.matmul_precision``
    says, as the reference's ``Precision.HIGHEST`` products (k-means
    assignment: a reduced-precision product scrambles near-tie
    assignments)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def sq_norms(db: torch.Tensor) -> torch.Tensor:
    """Row squared norms, f32 accumulation."""
    dbf = db.float()
    return torch.sum(dbf * dbf, dim=-1)


def dense_scores(
    metric: Metric,
    q: torch.Tensor,  # (Q, D)
    db: torch.Tensor,  # (N, D)
    db_sq: Optional[torch.Tensor] = None,  # (N,) precomputed squared norms
) -> torch.Tensor:
    """(Q, N) stored distances for a dense block.

    One matmul serves L2²/IP/cosine; L1 is an elementwise reduction
    (callers tile N to bound the (Q, N, D) intermediate)."""
    qf = q.float()
    dbf = db.float()
    if metric in (Metric.L2, Metric.IP, Metric.COSINE):
        dot_precision()
        ip = qf @ dbf.T  # (Q, N)
        if metric is Metric.IP:
            return -ip
        if metric is Metric.L2:
            q_sq = torch.sum(qf * qf, dim=-1, keepdim=True)
            d_sq = sq_norms(dbf)[None, :] if db_sq is None else db_sq[None, :]
            return torch.clamp(q_sq - 2.0 * ip + d_sq, min=0.0)
        # cosine: zero-norm rows get +inf distance so they sort last (the
        # reference refuses to index zero vectors for cosine,
        # hnswutils.c:417-423)
        q_n = torch.sqrt(torch.sum(qf * qf, dim=-1, keepdim=True))
        d_sq = sq_norms(dbf)[None, :] if db_sq is None else db_sq[None, :]
        denom = q_n * torch.sqrt(d_sq)
        cos = torch.where(denom > 0,
                          ip / torch.where(denom > 0, denom, 1.0), -torch.inf)
        return 1.0 - cos
    if metric is Metric.L1:
        return torch.sum(torch.abs(qf[:, None, :] - dbf[None, :, :]), dim=-1)
    raise ValueError(f"metric {metric} is not a dense metric")


def dense_point_scores(metric: Metric, qs: torch.Tensor, vf: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """(Q, W, D) candidate values vs (Q, D) queries → (Q, W) f32 stored
    distances; negative ids give +inf.  Elementwise f32 math, as the
    reference's scorer (no expanded-norm form)."""
    qf = qs.float()[:, None, :]
    vf = vf.float()
    if metric is Metric.L2:
        d = torch.sum((qf - vf) ** 2, dim=-1)
    elif metric is Metric.IP or metric is Metric.COSINE:
        # cosine opclasses store normalized values and order by -ip
        # (sql/vector.sql:437-441)
        d = -torch.sum(qf * vf, dim=-1)
    elif metric is Metric.L1:
        d = torch.sum(torch.abs(qf - vf), dim=-1)
    else:
        raise ValueError(metric)
    return torch.where(rows >= 0, d, torch.inf)


def dense_pair(metric: Metric, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise stored distance for aligned batches (B, D) x (B, D) → (B,)."""
    af = a.float()
    bf = b.float()
    if metric is Metric.L2:
        d = af - bf
        return torch.sum(d * d, dim=-1)
    if metric is Metric.IP:
        return -torch.sum(af * bf, dim=-1)
    if metric is Metric.COSINE:
        ip = torch.sum(af * bf, dim=-1)
        denom = torch.sqrt(torch.sum(af * af, dim=-1) * torch.sum(bf * bf, dim=-1))
        cos = torch.where(denom > 0,
                          ip / torch.where(denom > 0, denom, 1.0), -torch.inf)
        return 1.0 - cos
    if metric is Metric.L1:
        return torch.sum(torch.abs(af - bf), dim=-1)
    raise ValueError(f"metric {metric} is not a dense metric")
