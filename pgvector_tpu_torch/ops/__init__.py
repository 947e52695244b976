"""Tensor ops — dense distances, the tiled and grouped top-k engines and
the CUDA kernels: K1
(:mod:`.fused_topk`, exact scan), K2 (:mod:`.packed_hop`, one whole
beam-search hop over the packed slabs; the reference's tail alone is
:mod:`.hop_tail`), K3 (:mod:`.select_neighbors`, the build's SelectNeighbors),
K4 and K5 (:mod:`.bit_scan`), K6 (:mod:`.gather_hop`, one fused hop
over rows gathered by id) and K7 (:mod:`.greedy_walk`, the greedy descent
over the upper levels)."""

from .metric import Metric, stored_to_user, NORMALIZED_METRICS
from .distance import dense_scores, dense_pair, sq_norms, dot_precision
from .topk import topk_smallest, merge_topk, tiled_topk, grouped_exact_topk

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
    "grouped_exact_topk",
]
