"""Distance metrics — the operator set of pgvector, on torch tensors.

pgvector exposes six distance operators (reference sql/vector.sql:254-272,
882-890): ``<->`` L2, ``<#>`` negative inner product, ``<=>`` cosine,
``<+>`` L1, ``<~>`` Hamming, ``<%>`` Jaccard.  Index opclasses order by a
cheaper *ordering-equivalent* form (L2 opclasses order by squared L2,
sql/vector.sql:409,430; cosine opclasses index normalized vectors and order
by negative IP, sql/vector.sql:437-441).  Counterpart of
``pgvector_tpu.ops.metric``.
"""

from __future__ import annotations

import enum

import torch


class Metric(enum.Enum):
    """User-facing distance operators."""

    L2 = "<->"
    IP = "<#>"  # returns the NEGATIVE inner product (README.md:81)
    COSINE = "<=>"
    L1 = "<+>"
    HAMMING = "<~>"
    JACCARD = "<%>"

    @property
    def op(self) -> str:
        return self.value


# Metrics whose index form stores normalized vectors and orders by -IP
# (sql/vector.sql:437-441; scans re-normalize the query, hnswscan.c:108-110).
NORMALIZED_METRICS = (Metric.COSINE,)


def stored_to_user(metric: Metric, stored: torch.Tensor) -> torch.Tensor:
    """Convert the internal stored distance to the user-facing operator value.

    - L2 indexes order by squared distance; user sees sqrt.
    - Cosine indexes order by -IP of unit vectors; user sees 1 + stored
      (since cos_dist = 1 - ip = 1 + (-ip)); clamped to [0, 2].
    - Everything else is stored as-is.
    - +inf marks an absent result slot and passes through unchanged.
    """
    if metric is Metric.L2:
        return torch.sqrt(torch.clamp(stored, min=0.0))
    if metric is Metric.COSINE:
        return torch.where(torch.isinf(stored), stored,
                           torch.clamp(1.0 + stored, 0.0, 2.0))
    return stored
