"""The card's published peaks and the least time for a piece of work.

Copied from ``chip_smoke.py`` (``HBM_BYTES_S``, ``TF32_FLOPS``, ``bound_ms``)
so that the yardstick cannot change with the program.
"""

#: NVIDIA H100 SXM data sheet, dense rates, 700 W
HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
#: an f32-accurate product as three TF32 products (the split of 3xTF32)
F32_ACCURATE_FLOPS = TF32_FLOPS / 3


def bound_s(nbytes: float, flops: float = 0.0,
            rate: float = F32_ACCURATE_FLOPS):
    """(seconds, what bounds it): bytes moved once at the memory rate
    against operations at ``rate``, whichever takes longer."""
    t_b, t_o = nbytes / HBM_BYTES_S, flops / rate
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def exact_scan_work(nq: int, n: int, d: int, k: int):
    """(operations, bytes) of an exact L2 top-k of ``nq`` f32 queries over
    ``n`` f32 rows of ``d`` dims, fixed by the shapes whatever implements
    it: 2·Q·N·D operations; the queries, the rows and their squared norms
    read once, and the (Q, k) distances and ids written once."""
    flops = 2.0 * nq * n * d
    nbytes = 4.0 * (nq * d + n * (d + 1)) + 8.0 * nq * k
    return flops, nbytes
