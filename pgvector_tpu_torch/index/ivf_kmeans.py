"""K-means center training for IVFFlat — counterpart of
``pgvector_tpu.index.ivf_kmeans``.

k-means++ D² seeding, then Lloyd's iterations with one full
samples × centers product each (the reference's plain Lloyd's in place of
the Elkan bounds of src/ivfkmeans.c).  Preserved semantics:

- at most 500 iterations, stopping when no assignment changed; the first
  assignment compares against all −1, and the returned centers are the
  means of the final assignment;
- empty clusters reseed from a random sample row;
- spherical variant (IP, cosine): assignment by argmax ip, centers
  re-normalized every round;
- binary variant: centers thresholded at 0.5 every round;
- post-checks: no NaN/Inf centers, no zero-norm spherical centers.

Randomness comes from a ``torch.Generator`` seeded from ``seed`` on the
data's device.  The reference draws from ``jax.random``, so the two
packages draw different centers from the same seed; from the same initial
centers, Lloyd's loop gives the same assignments.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..errors import InternalError
from ..ops.distance import highest_precision

KMEANS_MAX_ITERATIONS = 500  # ivfkmeans.c:347


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _assign(data: torch.Tensor, centers: torch.Tensor,
            spherical: bool) -> torch.Tensor:
    """Nearest-center ids from one f32 product (ties to the lower center,
    as ``jnp.argmin``).  L2 orders by |c|² − 2x·c (|x|² is constant per
    row); spherical by argmax ip."""
    with highest_precision():
        ip = data @ centers.T
    if spherical:
        return torch.argmax(ip, dim=1)
    c_sq = torch.sum(centers * centers, dim=1)
    return torch.argmin(c_sq[None, :] - 2.0 * ip, dim=1)


def _new_centers(data: torch.Tensor, assign: torch.Tensor, k: int,
                 generator: torch.Generator, spherical: bool,
                 binary: bool) -> torch.Tensor:
    """Mean of each cluster's members; empty clusters reseed from a random
    sample row (ComputeNewCenters, ivfkmeans.c:179-236)."""
    n, d = data.shape
    sums = torch.zeros((k, d), dtype=torch.float32, device=data.device)
    sums.index_add_(0, assign, data)
    counts = torch.zeros(k, dtype=torch.float32, device=data.device)
    counts.index_add_(0, assign, torch.ones(n, device=data.device))
    centers = sums / torch.clamp(counts, min=1.0)[:, None]
    rand_rows = torch.randint(0, n, (k,), generator=generator,
                              device=data.device)
    centers = torch.where((counts == 0)[:, None], data[rand_rows], centers)
    if spherical:
        norms = torch.sqrt(torch.sum(centers * centers, dim=1, keepdim=True))
        centers = centers / torch.clamp(norms, min=1e-30)
    if binary:
        centers = (centers > 0.5).float()
    return centers


def lloyd(data: torch.Tensor, init: torch.Tensor, generator: torch.Generator,
          k: int, spherical: bool, binary: bool
          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Lloyd's loop from ``init``: (centers, assignment, iterations).  One
    host read a round, of whether any assignment changed."""
    centers = init
    assign = torch.full((data.shape[0],), -1, dtype=torch.int64,
                        device=data.device)
    iters, changed = 0, True
    while changed and iters < KMEANS_MAX_ITERATIONS:
        new_assign = _assign(data, centers, spherical)
        changed_t = torch.any(new_assign != assign)
        centers = _new_centers(data, new_assign, k, generator, spherical,
                               binary)
        assign = new_assign
        iters += 1
        changed = bool(changed_t)
    return centers, assign, iters


def _kmeanspp_init(data: torch.Tensor, generator: torch.Generator, k: int,
                   spherical: bool) -> torch.Tensor:
    """k-means++ D² seeding (InitCenters, ivfkmeans.c:23-91): each step
    draws the next center with probability ∝ the current least distance,
    then folds its distances into that minimum."""
    n = data.shape[0]

    def dist_to(c):
        if spherical:
            with highest_precision():
                ip = data @ c
            # angular distance ∝ acos(ip); 1 − ip is monotone in it
            return torch.clamp(1.0 - ip, min=0.0)
        diff = data - c[None, :]
        return torch.sum(diff * diff, dim=1)

    first = int(torch.randint(0, n, (1,), generator=generator,
                              device=data.device))
    centers = torch.empty((k, data.shape[1]), dtype=data.dtype,
                          device=data.device)
    centers[0] = data[first]
    min_d = dist_to(data[first])
    uniform = torch.full_like(min_d, 1.0 / n)
    for j in range(1, k):
        total = torch.sum(min_d)
        # all-zero weights (duplicate data): fall back to uniform
        probs = torch.where(total > 0, min_d / torch.clamp(total, min=1e-30),
                            uniform)
        idx = torch.multinomial(probs, 1, generator=generator)
        c = data[idx[0]]
        centers[j] = c
        min_d = torch.minimum(min_d, dist_to(c))
    return centers


def train_centers(data: torch.Tensor, k: int, *, spherical: bool = False,
                  binary: bool = False, normalize_data: bool = False,
                  seed: int = 0) -> Tuple[torch.Tensor, int]:
    """k-means++ seeding and Lloyd's on the (formed) sample block ``data``:
    (centers, Lloyd's iterations).  Fewer samples than centers tile the
    samples (IvfflatKmeans, ivfkmeans.c:553-569)."""
    data = data.float()
    n = data.shape[0]
    if n == 0:
        raise InternalError("k-means requires at least one sample")
    if n < k:
        reps = -(-k // n)
        centers = data.repeat(reps, 1)[:k]
        if spherical:
            norms = torch.sqrt(torch.sum(centers ** 2, dim=1, keepdim=True))
            centers = centers / torch.clamp(norms, min=1e-30)
        if binary:
            centers = (centers > 0.5).float()
        return centers, 0
    if normalize_data:
        # cosine opclasses index normalized values; IP trains on raw
        # samples with normalized centers (sql/vector.sql:412-425)
        norms = torch.sqrt(torch.sum(data * data, dim=1, keepdim=True))
        data = data / torch.clamp(norms, min=1e-30)
    g = make_generator(seed, data.device)
    init = _kmeanspp_init(data, g, k, spherical)
    if binary:
        init = (init > 0.5).float()
    centers, _, iters = lloyd(data, init, g, k, spherical, binary)
    # post-checks (ivfkmeans.c:490-547)
    host = centers.cpu()
    if not torch.isfinite(host).all():
        raise InternalError(
            "k-means produced non-finite centers. Please report a bug.")
    if spherical and (torch.linalg.norm(host, dim=1) == 0).any():
        raise InternalError(
            "k-means produced a zero-norm center for a spherical metric. "
            "Please report a bug.")
    return centers, iters
