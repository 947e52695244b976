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
    distinct ids: its other members lie beyond k).

    ``atol`` may be an array of the distances' shape: a bound per entry
    (such as ``ops.fused_topk.k1_error_bound``).  Then positions j-1 and j
    tie when their distances differ by at most the sum of their bounds,
    since each may move by its own."""
    d_ref, d_got = np.asarray(d_ref), np.asarray(d_got)
    i_ref, i_got = np.asarray(i_ref), np.asarray(i_got)
    if d_ref.shape != d_got.shape or i_ref.shape != i_got.shape:
        raise AssertionError(f"shapes differ: {d_ref.shape}/{i_ref.shape} "
                             f"against {d_got.shape}/{i_got.shape}")
    per_entry = np.ndim(atol) > 0
    if per_entry:
        atol = np.broadcast_to(np.asarray(atol, np.float64), d_ref.shape)
        fin = np.isfinite(d_ref)
        if not (fin == np.isfinite(d_got)).all() or \
                not (d_ref[~fin] == d_got[~fin]).all():
            raise AssertionError("non-finite distances differ")
        err = np.abs(d_got[fin].astype(np.float64) - d_ref[fin])
        over = err > atol[fin] + rtol * np.abs(d_ref[fin])
        if over.any():
            j = np.argmax(err - atol[fin])
            raise AssertionError(f"{int(over.sum())} distances beyond their "
                                 f"bound, the worst {err[j]:.3g} against "
                                 f"{atol[fin][j]:.3g}")
    else:
        np.testing.assert_allclose(d_got, d_ref, atol=atol, rtol=rtol)
    k = d_ref.shape[1]
    for r in np.flatnonzero((i_ref != i_got).any(axis=1)):
        d = d_ref[r]
        pair = atol[r, 1:] + atol[r, :-1] if per_entry else atol
        tie = np.abs(np.diff(d)) <= pair + rtol * np.abs(d[1:])
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


def packed_hop_case(seed, q, ef, e_sel, m2=16, d=16, cap=400, nan=False):
    """Seeded numpy inputs of one whole packed hop: (pool_d, pool_p, nbr0,
    nbr_vals, qs).  Pools are sorted, duplicate-free and partly expanded,
    each with an unexpanded best lane; list slots are partly -1.  Row 0's
    best element lists a pool entry; row 1's pool is half empty; row 2's
    two best elements share half their lists and one list repeats an id;
    row 3's pool is fully expanded (done); with q > 4, row 4 ends in +inf
    lanes with ids; with q > 5, row 5's distances tie in pairs, as do two
    rows of its best element's slab; with q > 6, row 6's pool is empty;
    with ``nan`` and q > 7, row 7 holds a NaN at an unexpanded lane."""
    rng = np.random.default_rng(seed)
    nbr0 = np.stack([rng.choice(cap, m2, replace=False)
                     for _ in range(cap)]).astype(np.int32)
    nbr0[rng.random((cap, m2)) < 0.1] = -1
    vals = rng.normal(size=(cap, m2, d)).astype(np.float32)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    pool_i = np.stack([rng.choice(cap, ef, replace=False)
                       for _ in range(q)]).astype(np.int32)
    pool_d = np.sort(rng.random((q, ef)).astype(np.float32) * 2 * d, axis=1)
    pool_x = rng.random((q, ef)) > 0.5
    pool_x[:, 0] = False
    nbr0[pool_i[0, 0], 0] = pool_i[0, 1]
    pool_i[1, ef // 2:] = -1
    pool_d[1, ef // 2:] = np.inf
    pool_x[1, ef // 2:] = False
    if q > 2:
        a, b = pool_i[2, 0], pool_i[2, 1]
        pool_x[2, :2] = False
        nbr0[b, : m2 // 2] = nbr0[a, : m2 // 2]
        nbr0[a, 3] = nbr0[a, 2] = nbr0[a, 2] if nbr0[a, 2] >= 0 else 5
    if q > 3:
        pool_x[3] = True
    if q > 4:
        pool_d[4, -3:] = np.inf
    if q > 5:
        pool_d[5, 1::2] = pool_d[5, 0::2][: ef // 2]
        vals[pool_i[5, 0], 1] = vals[pool_i[5, 0], 0]
    if q > 6:
        pool_i[6] = -1
        pool_d[6] = np.inf
        pool_x[6] = False
    if nan and q > 7:
        pool_d[7, 3] = np.nan
        pool_x[7, 3] = False
    pool_p = pool_i * 2 + pool_x.astype(np.int32)
    return pool_d, pool_p, nbr0, vals, qs


def int8_hop_case(seed, q, ef, e_sel, m2=16, d=16, cap=400):
    """:func:`packed_hop_case` with the slab quantized as the int8 tier
    quantizes it (per-dim scale max|v| / 127, round half to even) and
    seeded element norms: (pool_d, pool_p, nbr0, int8 slab, qs, scale,
    pnorm2)."""
    pool_d, pool_p, nbr0, vals, qs = packed_hop_case(
        seed, q, ef, e_sel, m2=m2, d=d, cap=cap)
    scale = (np.maximum(np.abs(vals).max(axis=(0, 1)), np.float32(1e-30))
             / np.float32(127.0)).astype(np.float32)
    q8 = np.clip(np.round(vals / scale), -127, 127).astype(np.int8)
    pnorm2 = np.random.default_rng(seed + 1).uniform(
        0.5 * d, 2.0 * d, size=cap).astype(np.float32)
    return pool_d, pool_p, nbr0, q8, qs, scale, pnorm2


def assert_same_pool(d_ref, p_ref, d_got, p_got, atol=ATOL, rtol=RTOL):
    """Two hop results agree: (distance, id) lists as top-k lists, and the
    expanded flags wherever the ids agree."""
    p_ref, p_got = np.asarray(p_ref), np.asarray(p_got)
    assert_same_topk(d_ref, p_ref >> 1, d_got, p_got >> 1, atol, rtol)
    same = (p_ref >> 1) == (p_got >> 1)
    if not ((p_ref & 1) == (p_got & 1))[same].all():
        raise AssertionError("expanded flags differ where the ids agree")


def select_case(seed, t, c, forced=True):
    """Seeded numpy inputs of one SelectNeighbors batch: (base_d, pair_d,
    valid, forced).  Candidates sit on a small integer grid around their
    base, so base and pair distances tie often; about 10 % are invalid, a
    few valid ones lie at +inf, row 0 is all invalid and, with ``forced``,
    about 20 % are forced (invalid and +inf ones too) and row 1 all."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 4, size=(t, c + 1, 3)).astype(np.float32)
    base = ((pts[:, 1:] - pts[:, :1]) ** 2).sum(-1).astype(np.float32)
    pair = ((pts[:, 1:, None] - pts[:, None, 1:]) ** 2).sum(-1)
    valid = rng.random((t, c)) > 0.1
    valid[0] = False
    base[rng.random((t, c)) < 0.05] = np.inf
    pair = np.where(valid[:, :, None] & valid[:, None, :], pair,
                    np.inf).astype(np.float32)
    fc = None
    if forced:
        fc = rng.random((t, c)) < 0.2
        fc[min(1, t - 1)] = True
    return base, pair, valid, fc


def gram_case(seed, t, c, l2=True, forced=True, d=3):
    """Seeded numpy inputs of one SelectNeighbors batch in the Gram form:
    (base_d, ip, sq, valid, forced).  Candidates sit on a small integer
    grid, so products and distances are exact and tie often; ``ip`` is
    their (T, C, C) f32 products with a few NaN, +inf and -inf entries
    planted, ``sq`` the norms (L2; else None); the base distances are the
    formed distances to a base point (some +inf), about 10 % of
    candidates are invalid, row 0 all; with ``forced`` about 20 % are
    forced and row 1 all."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-2, 3, size=(t, c + 1, d)).astype(np.float32)
    v = pts[:, 1:]
    ip = np.einsum("tid,tjd->tij", v, v).astype(np.float32)
    spots = rng.random(ip.shape)
    ip[spots < 0.01] = np.nan
    ip[(spots >= 0.01) & (spots < 0.02)] = np.inf
    ip[(spots >= 0.02) & (spots < 0.03)] = -np.inf
    sq = (v * v).sum(-1).astype(np.float32) if l2 else None
    b = pts[:, :1]
    base = (((v - b) ** 2).sum(-1) if l2 else -(v * b).sum(-1))
    base = base.astype(np.float32)
    base[rng.random((t, c)) < 0.05] = np.inf
    valid = rng.random((t, c)) > 0.1
    valid[0] = False
    fc = None
    if forced:
        fc = rng.random((t, c)) < 0.2
        fc[min(1, t - 1)] = True
    return base, ip, sq, valid, fc


def formed_block(ip, sq, valid):
    """The pairwise distances of a Gram form in numpy f32, each operation
    rounded: (sq_i - 2·ip_ij) + sq_j clamped at 0 (NaN kept) with ``sq``,
    else -ip_ij; +inf where either candidate is invalid."""
    with np.errstate(invalid="ignore", over="ignore"):
        if sq is not None:
            x = (sq[:, :, None] - np.float32(2.0) * ip) + sq[:, None, :]
            d = np.where(x < 0, np.float32(0.0), x)
        else:
            d = -ip
    ok = valid[:, :, None] & valid[:, None, :]
    return np.where(ok, d, np.float32(np.inf)).astype(np.float32)


def gather_hop_case(seed, q, ef, m=8, d=16, cap=400, levels=1):
    """Seeded numpy inputs of one whole row-gather hop: (pool_d, pool_p,
    nbr0, nbr_up, up_slot, rows, qs), the lists 2m wide at level 0 and m
    wide on each of ``levels`` upper levels.  Pools are sorted (NaN last),
    duplicate-free and partly expanded; list slots are partly -1, some
    elements have no upper slot and some listed ids lie at or past the
    ``cap`` rows.  Row 0 meets a pool entry among its best element's
    candidates; row 1's pool is half empty; row 2's two best elements
    share half their lists; row 3's pool is fully expanded; row 4 holds
    a NaN at an expanded lane and one at an unexpanded lane; row 5 ends
    in +inf lanes with ids; row 6's distances tie in pairs; row 7's pool
    is empty."""
    rng = np.random.default_rng(seed)
    m2 = 2 * m
    rows = rng.normal(size=(cap, d)).astype(np.float32)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    nbr0 = np.stack([rng.choice(cap, m2, replace=False)
                     for _ in range(cap)]).astype(np.int32)
    nbr0[rng.random(nbr0.shape) < 0.1] = -1
    nbr_up = np.stack([np.stack([rng.choice(cap, m, replace=False)
                                 for _ in range(levels)])
                       for _ in range(cap)]).astype(np.int32)
    nbr_up[rng.random(nbr_up.shape) < 0.1] = -1
    past = rng.random(nbr0.shape) < 0.03
    nbr0[past] = cap + rng.integers(0, 50, size=int(past.sum()))
    past = rng.random(nbr_up.shape) < 0.03
    nbr_up[past] = cap + rng.integers(0, 50, size=int(past.sum()))
    up_slot = np.arange(cap, dtype=np.int32)
    up_slot[rng.random(cap) < 0.1] = -1
    pool_i = np.stack([rng.choice(cap, ef, replace=False)
                       for _ in range(q)]).astype(np.int32)
    pool_d = np.sort(rng.random((q, ef)).astype(np.float32) * 2 * d, axis=1)
    pool_x = rng.random((q, ef)) > 0.5
    pool_x[:, 0] = False  # a best lane to expand
    nbr0[pool_i[0, 0], 0] = pool_i[0, 1]
    nbr_up[pool_i[0, 0], :, 0] = pool_i[0, 1]
    pool_i[1, ef // 2:] = -1
    pool_d[1, ef // 2:] = np.inf
    pool_x[1, ef // 2:] = False
    if q > 2:
        pool_x[2, :2] = False
        a, b = pool_i[2, :2]
        nbr0[b, : m] = nbr0[a, : m]
        nbr_up[b, :, : m // 2] = nbr_up[a, :, : m // 2]
    if q > 3:
        pool_x[3] = True
    if q > 4 and ef >= 4:
        pool_x[4, -2:] = (True, False)
        pool_d[4, -2:] = np.nan
    if q > 5 and ef >= 4:
        pool_d[5, -3:] = np.inf
    if q > 6:
        pool_d[6] = np.repeat(pool_d[6, ::2], 2)[:ef]
    if q > 7:
        pool_i[7], pool_d[7], pool_x[7] = -1, np.inf, False
    pool_p = pool_i * 2 + pool_x.astype(np.int32)
    return pool_d, pool_p, nbr0, nbr_up, up_slot, rows, qs
