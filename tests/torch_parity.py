"""Shared check of the port's tests: top-k results of two engines agree.

Tolerance for f32 scores: atol 1e-4, rtol 1e-5 — two stacks (or a kernel
and its plain version) sum the same f32 products in different orders.
Ids must agree except among candidates whose distances tie within that
tolerance.  Imports neither jax nor the reference package, so the CUDA
tests can use it on a machine without them.  Failures raise
AssertionError explicitly, so the check holds under ``python -O`` too.
"""

import numpy as np

ATOL, RTOL = 1e-4, 1e-5


def assert_same_topk(d_ref, i_ref, d_got, i_got, atol=ATOL, rtol=RTOL):
    """Distances agree within tolerance; ids agree except inside groups of
    positions whose reference distances tie within the tolerance, where
    the id sets must agree (a group cut by the k boundary only needs
    distinct ids: its other members lie beyond k)."""
    d_ref, d_got = np.asarray(d_ref), np.asarray(d_got)
    i_ref, i_got = np.asarray(i_ref), np.asarray(i_got)
    if d_ref.shape != d_got.shape or i_ref.shape != i_got.shape:
        raise AssertionError(f"shapes differ: {d_ref.shape}/{i_ref.shape} "
                             f"against {d_got.shape}/{i_got.shape}")
    np.testing.assert_allclose(d_got, d_ref, atol=atol, rtol=rtol)
    k = d_ref.shape[1]
    for r in np.flatnonzero((i_ref != i_got).any(axis=1)):
        d = d_ref[r]
        tie = np.abs(np.diff(d)) <= atol + rtol * np.abs(d[1:])
        tie &= np.isfinite(d[1:])
        start = 0
        for j in range(1, k + 1):
            if j < k and tie[j - 1]:
                continue
            a, b = i_ref[r, start:j], i_got[r, start:j]
            if j == k and start < j and len(np.unique(b)) == len(b) \
                    and np.isfinite(d[start]):
                pass  # group cut by the k boundary
            elif sorted(a.tolist()) != sorted(b.tolist()):
                raise AssertionError(f"row {r}, positions {start}:{j}: ids "
                                     f"{a.tolist()} against {b.tolist()}")
            start = j
