"""Tensor ops — dense distances, tiled top-k and the two CUDA kernels:
K1 (:mod:`.fused_topk`, exact scan) and K2 (:mod:`.hop_tail`, beam-search
hop tail)."""

from .metric import Metric, stored_to_user, NORMALIZED_METRICS
from .distance import dense_scores, dense_pair, sq_norms, dot_precision
from .topk import topk_smallest, merge_topk, tiled_topk

__all__ = [
    "Metric",
    "stored_to_user",
    "NORMALIZED_METRICS",
    "dense_scores",
    "dense_pair",
    "sq_norms",
    "dot_precision",
    "topk_smallest",
    "merge_topk",
    "tiled_topk",
]
