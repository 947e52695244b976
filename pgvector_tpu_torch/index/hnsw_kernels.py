"""HNSW device code — counterpart of ``pgvector_tpu.index.hnsw_kernels``
(the dense, single-device, non-iterative subset).

The reference walks the graph one candidate at a time (HnswSearchLayer,
Algorithm 2, hnswutils.c:822-985).  Here, as in the JAX package, one call
runs the algorithm for a whole batch of queries: the pool (C and W merged
into one ef-bounded sorted tensor with expanded flags), the per-hop
neighbor gather and the distances are (Q, ·)-shaped tensor ops.
SelectNeighbors (Algorithm 4, hnswutils.c:1062-1163) is a pairwise
distance block plus a sequential keep/prune loop over the candidates.

From JAX to PyTorch:

- each ``lax.while_loop`` is a Python loop whose stop test reads one
  device scalar per iteration (``.item()``);
- ids stay int32 in every stored tensor and become int64 only to index;
  JAX clamps out-of-range gathers and drops out-of-range scatters, torch
  raises, so every index is clamped or masked before use;
- ``lax.sort`` and ``lax.top_k`` become stable ``torch.sort`` calls
  sliced to size: ties keep position order, as the Pallas hop tail does;
- graph arrays are updated in place where the reference donates them.

The visited set is mode ``off`` (the reference's default): the pool
membership check keeps the ef pool duplicate-free.  The hash modes come
with iterative scans.  The packed query hop ends in K2
(:func:`..ops.hop_tail.hop_tail`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.hop_tail import hop_tail
from ..ops.metric import Metric

BIG = 3.0e38

#: Knuth's multiplicative hash and its inverse mod 2^32: a bijection on
#: ids, so equal keys ⇔ equal ids, and the permuted order is unbiased
_PERM = 2654435761
_PERM_INV = 244002641
_MASK32 = 0xFFFFFFFF


def _long(x: torch.Tensor) -> torch.Tensor:
    """Clamp ids (-1 = none) to a valid row and widen them to index."""
    return torch.clamp(x, min=0).long()


# ---------------------------------------------------------------------------
# distance closure: query batch -> distances to a (Q, R) block of element ids
# ---------------------------------------------------------------------------


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


def make_scorer(metric: Metric, vecs: torch.Tensor):
    """score(qs, rows) -> (Q, R) f32 distances from the query batch to the
    stored values of element ids ``rows`` (negative ids give +inf) — the
    dense branch of the reference's make_scorer."""

    def score(qs, rows):
        return dense_point_scores(metric, qs, vecs[_long(rows)], rows)

    return score


def elems_as_queries(vecs: torch.Tensor, elems: torch.Tensor) -> torch.Tensor:
    """Stored elements as the query side (build-time searches)."""
    return vecs[_long(elems)]


# ---------------------------------------------------------------------------
# neighbor gather: fixed 2m width at every level
# ---------------------------------------------------------------------------


def _neighbors_closure(nbr0: torch.Tensor, nbr_up: torch.Tensor,
                       up_slot: torch.Tensor):
    """neighbors_of(elems, level) -> (len, 2m) ids: level 0 reads nbr0;
    upper levels read nbr_up[slot, level-1] (m wide) padded with -1.
    Elements without an upper slot (slot -1) and negative elems give -1."""
    m2 = nbr0.shape[1]
    m = nbr_up.shape[2]

    def neighbors_of(elems: torch.Tensor, level: int) -> torch.Tensor:
        safe = _long(elems)
        if level == 0:
            out = nbr0[safe]
        else:
            slot = up_slot[safe]
            out = nbr_up[_long(slot), level - 1]
            out = torch.where(slot[:, None] >= 0, out, -1)
            out = torch.cat([out, out.new_full((out.shape[0], m2 - m), -1)],
                            dim=1)
        return torch.where(elems[:, None] >= 0, out, -1)

    return neighbors_of


# ---------------------------------------------------------------------------
# one beam hop (the body of Algorithm 2)
# ---------------------------------------------------------------------------


def _hop_body(score, neighbors_of, qs, pool_d, pool_i, pool_x, ef: int,
              expand: int = 1, packed=None, metric: Optional[Metric] = None):
    """One expansion hop: pop the ``expand`` nearest unexpanded candidates
    per query, gather their neighbors, score the new ones and merge them
    into the pool.  Returns (pool_d, pool_i, pool_x, done).

    ``packed`` — optional ``(nbr_vals, qs_p)``: adjacency-packed neighbor
    values ``nbr_vals[cap, 2m, D]`` (f32 or bf16) and the queries to score
    them against.  Each expanded node's neighbor values are one contiguous
    slab, and the tail runs in K2."""
    nq = pool_d.shape[0]
    expand = min(expand, pool_d.shape[1])
    cand_mask = (~pool_x) & (pool_i >= 0)
    cand_d = torch.where(cand_mask, pool_d, torch.inf)
    worst = pool_d[:, ef - 1]
    if expand == 1:
        sel = torch.argmin(cand_d, dim=1, keepdim=True)  # first minimum
        sel_d = torch.gather(cand_d, 1, sel)
    else:
        sel_d, sel = torch.sort(cand_d, dim=1, stable=True)
        sel_d, sel = sel_d[:, :expand], sel[:, :expand]
    # done: no unexpanded candidate, or the best one is worse than a full
    # pool's worst (the W-bound termination of Algorithm 2)
    done = torch.isinf(sel_d[:, 0]) | (sel_d[:, 0] > worst)
    ok = torch.isfinite(sel_d) & (sel_d <= worst[:, None]) & ~done[:, None]
    pool_x = pool_x.scatter(1, sel, torch.gather(pool_x, 1, sel) | ok)
    sel_elem = torch.where(ok, torch.gather(pool_i, 1, sel), -1)
    # all selected candidates' neighbors in one flattened gather
    sel_flat = sel_elem.reshape(-1)
    nb = neighbors_of(sel_flat)
    nbrs = torch.where(sel_flat[:, None] >= 0, nb, -1).reshape(nq, -1)
    if packed is not None:
        nbr_vals, qs_p = packed
        w = nbrs.shape[1]
        v = nbr_vals[_long(sel_flat)].reshape(nq, w, nbr_vals.shape[-1])
        nd = dense_point_scores(metric, qs_p, v, nbrs)
        pool_packed = pool_i * 2 + pool_x.to(torch.int32)
        d, pp = hop_tail(pool_d.contiguous(), pool_packed.contiguous(),
                         nd.contiguous(), nbrs.contiguous(), ef, w)
        return d, pp >> 1, (pp & 1) == 1, done
    if sel_elem.shape[1] > 1:
        # dedupe within the hop (two expanded nodes sharing a neighbor):
        # sort by the Knuth permutation of the id and mask adjacent equals
        inval = _MASK32  # no id < 2^30 maps here
        key = torch.where(nbrs >= 0, (nbrs.long() * _PERM) & _MASK32, inval)
        key, _ = torch.sort(key, dim=1)
        dup = torch.zeros_like(key, dtype=torch.bool)
        dup[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] != inval)
        ids = ((key * _PERM_INV) & _MASK32).to(torch.int32)
        nbrs = torch.where(dup | (key == inval), -1, ids)
    # pool-membership check keeps the ef pool duplicate-free
    in_pool = torch.any(nbrs[:, :, None] == pool_i[:, None, :], dim=2)
    nbrs = torch.where(in_pool, -1, nbrs)
    nd = score(qs, nbrs)
    return _hop_merge(pool_d, pool_i, pool_x, nbrs, nd, ef) + (done,)


def _hop_merge(pool_d, pool_i, pool_x, nbrs, nd, ef: int):
    """Merge scored candidates into the ef pool: (id·2 | expanded) packed
    into one int32 rides a stable sort by distance (-1 packs to -2 and
    unpacks back through the arithmetic shift)."""
    d = torch.cat([pool_d, nd], dim=1)
    packed = torch.cat([pool_i * 2 + pool_x.to(torch.int32), nbrs * 2], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    packed = torch.gather(packed, 1, order[:, :ef])
    return d[:, :ef], packed >> 1, (packed & 1) == 1


def _init_pool(init_d, init_i, ef: int):
    nq = init_i.shape[0]
    pad = ef - init_i.shape[1]
    if pad < 0:
        init_d, init_i = init_d[:, :ef], init_i[:, :ef]
        pad = 0
    pool_d = torch.cat([torch.where(init_i >= 0, init_d, torch.inf),
                        init_d.new_full((nq, pad), torch.inf)], dim=1)
    pool_i = torch.cat([init_i, init_i.new_full((nq, pad), -1)], dim=1)
    pool_d, order = torch.sort(pool_d, dim=1, stable=True)
    pool_i = torch.gather(pool_i, 1, order)
    return pool_d, pool_i, torch.zeros_like(pool_i, dtype=torch.bool)


def search_layer(score, neighbors_of, qs, init_d, init_i, ef: int,
                 max_steps: int, expand: int = 1, packed=None, metric=None):
    """Algorithm 2 (HnswSearchLayer, hnswutils.c:822-985), batched.
    Returns (pool_d, pool_i, steps).  One host read per hop decides
    whether every query is done."""
    pool_d, pool_i, pool_x = _init_pool(init_d, init_i, ef)
    steps = 0
    while steps < max_steps:
        pool_d, pool_i, pool_x, done = _hop_body(
            score, neighbors_of, qs, pool_d, pool_i, pool_x, ef, expand,
            packed=packed, metric=metric)
        steps += 1
        if bool(done.all()):
            break
    return pool_d, pool_i, steps


# ---------------------------------------------------------------------------
# greedy ef=1 descent (upper levels)
# ---------------------------------------------------------------------------


def _greedy_body(score, neighbors_of, qs, cur, cur_d):
    nbrs = neighbors_of(cur)
    nd = score(qs, nbrs)
    best = torch.argmin(nd, dim=1, keepdim=True)
    best_d = torch.gather(nd, 1, best)[:, 0]
    best_i = torch.gather(nbrs, 1, best)[:, 0]
    move = best_d < cur_d
    return torch.where(move, best_i, cur), torch.where(move, best_d, cur_d), move


def greedy_descent(score, neighbors_of_level, qs, start, start_d, level: int,
                   max_steps: int):
    """ef=1 greedy walk on one upper level (hnswutils.c:1293-1306)."""
    cur, cur_d = start, start_d
    for _ in range(max_steps):
        cur, cur_d, moved = _greedy_body(
            score, lambda e: neighbors_of_level(e, level), qs, cur, cur_d)
        if not bool(moved.any()):
            break
    return cur, cur_d


# ---------------------------------------------------------------------------
# SelectNeighbors heuristic (Algorithm 4 — hnswutils.c:1062-1163)
# ---------------------------------------------------------------------------


def select_neighbors(base_d, pair_d, valid, lm: int, forced=None):
    """Algorithm 4 over a batch of (T, C) candidate pools: returns ((T, lm)
    selected candidate positions, -1 padded; (T, lm) kept flags) —
    heuristic-kept first, then the closest pruned ones as backfill
    (keepPrunedConnections, hnswutils.c:1133-1156).

    ``forced`` marks candidates whose kept status is sticky (the
    reference's cached ``closer`` flags, hnswutils.c:1094-1131): they skip
    the pair check but still compete for the lm slots in distance order.

    Candidates are visited closest first.  The pool is permuted into that
    order once, so step t reads column t of every tensor."""
    t_rows, c = base_d.shape
    big_d = torch.where(valid, base_d, torch.inf)
    if forced is None:
        forced = torch.zeros_like(valid)
    forced = forced & valid & torch.isfinite(big_d)
    sd, order = torch.sort(big_d, dim=1, stable=True)
    sf = torch.gather(forced, 1, order)
    fin = torch.isfinite(sd)
    # pp[b, a, t] = pair_d[b, order[a], order[t]]
    pp = torch.gather(pair_d, 1, order[:, :, None].expand(t_rows, c, c))
    pp = torch.gather(pp, 2, order[:, None, :].expand(t_rows, c, c))
    min_pair = torch.full_like(sd, torch.inf)
    kept_s = torch.zeros_like(sf)
    count = torch.zeros(t_rows, dtype=torch.int32, device=sd.device)
    for t in range(c):
        ok = (sf[:, t] | (sd[:, t] < min_pair[:, t])) & fin[:, t] & (count < lm)
        kept_s[:, t] = ok
        torch.minimum(min_pair, torch.where(ok[:, None], pp[:, :, t],
                                            torch.inf), out=min_pair)
        count += ok
    kept = torch.zeros_like(kept_s).scatter_(1, order, kept_s)
    rank = torch.where(kept, big_d,
                       torch.where(torch.isfinite(big_d), big_d + BIG,
                                   torch.inf))
    rank_s, pos = torch.sort(rank, dim=1, stable=True)
    rank_s, pos = rank_s[:, :lm], pos[:, :lm]
    pos = torch.where(torch.isinf(rank_s), -1, pos)
    kept_sel = torch.gather(kept, 1, _long(pos)) & (pos >= 0)
    if pos.shape[1] < lm:  # fewer candidates than slots
        fill = lm - pos.shape[1]
        pos = torch.cat([pos, pos.new_full((t_rows, fill), -1)], dim=1)
        kept_sel = torch.cat(
            [kept_sel, kept_sel.new_zeros((t_rows, fill))], dim=1)
    return pos, kept_sel


def _pairwise_dists(metric: Metric, vecs: torch.Tensor,
                    elems: torch.Tensor) -> torch.Tensor:
    """(T, C, C) stored distances among each row's candidate elements.
    Dense L2/IP/cos ride one batched f32 product (the reference left it
    to XLA at HIGHEST precision); L1 is a broadcast block."""
    ok = (elems[:, :, None] >= 0) & (elems[:, None, :] >= 0)
    v = vecs[_long(elems)].float()  # (T, C, D)
    if metric in (Metric.L2, Metric.IP, Metric.COSINE):
        from ..ops.distance import dot_precision

        dot_precision()
        ip = torch.bmm(v, v.transpose(1, 2))
        if metric is Metric.L2:
            sq = torch.sum(v * v, dim=-1)
            d = torch.clamp(sq[:, :, None] - 2.0 * ip + sq[:, None, :], min=0.0)
        else:
            d = -ip
    else:
        d = torch.sum(torch.abs(v[:, :, None, :] - v[:, None, :, :]), dim=-1)
    return torch.where(ok, d, torch.inf)


def _select_from(cand, cand_d, pair, lm: int, forced=None):
    """SelectNeighbors over (T, C) pools → ((T, lm) ids, (T, lm) kept)."""
    pos, kept = select_neighbors(cand_d, pair, cand >= 0, lm, forced)
    sel = torch.where(pos >= 0, torch.gather(cand, 1, _long(pos)), -1)
    return sel, kept & (pos >= 0), pos


def select_connections(metric, vecs, pool_d, pool_i, lm: int):
    """SelectNeighbors over each base element's candidate pool →
    ((Q, lm) neighbor element ids, (Q, lm) heuristic-kept flags)."""
    pair = _pairwise_dists(metric, vecs, pool_i)
    sel, kept, _ = _select_from(pool_i, pool_d, pair, lm)
    return sel, kept


def merge_backlinks_wholesale(metric, vecs, old_lists, old_kept, new_src,
                              targets, lm: int):
    """One SelectNeighbors over old ∪ new per target.  ``old_kept`` marks
    the incumbents whose heuristic-kept status is sticky.  Returns (new
    lists, new kept flags)."""
    score = make_scorer(metric, vecs)
    cand = torch.cat([old_lists, new_src], dim=1)
    forced = torch.cat([old_kept & (old_lists >= 0),
                        torch.zeros_like(new_src, dtype=torch.bool)], dim=1)
    c = cand.shape[1]
    eq = cand[:, :, None] == cand[:, None, :]
    idx = torch.arange(c, device=cand.device)
    earlier = idx[:, None] > idx[None, :]
    dup = torch.any(eq & earlier[None] & (cand[:, :, None] >= 0), dim=2)
    cand = torch.where(dup, -1, cand)
    forced = forced & (cand >= 0)
    base_d = score(elems_as_queries(vecs, targets), cand)
    base_d = torch.where(targets[:, None] >= 0, base_d, torch.inf)
    pair = _pairwise_dists(metric, vecs, cand)
    sel, kept, _ = _select_from(cand, base_d, pair, lm, forced)
    return sel, kept


def _group_edges(tgt, src, d, smax: int):
    """Group an (E,) edge list by target, on device.

    Returns (targets (E,), new_src (E, smax), u_count): row r < u_count of
    ``new_src`` holds the up-to-``smax`` nearest sources pointing at
    ``targets[r]`` (rows past u_count are -1); u_count is a host int."""
    e = tgt.shape[0]
    inval = 2**31 - 1
    key_t = torch.where((tgt >= 0) & (src >= 0), tgt, inval)
    # lexicographic (target, distance): stable sort by the minor key first
    _, o1 = torch.sort(d, stable=True)
    _, o2 = torch.sort(key_t[o1], stable=True)
    order = o1[o2]
    st, ss = key_t[order], src[order]
    valid = st != inval
    newrun = torch.zeros_like(valid)
    newrun[0] = valid[0]
    newrun[1:] = (st[1:] != st[:-1]) & valid[1:]
    run_id = torch.cumsum(newrun.to(torch.int64), 0) - 1
    idx = torch.arange(e, device=tgt.device)
    start = torch.cummax(torch.where(newrun, idx, 0), 0).values
    pos = idx - start
    keep = valid & (pos < smax)
    new_src = torch.full((e, smax), -1, dtype=torch.int32, device=tgt.device)
    new_src[run_id[keep], pos[keep]] = ss[keep]
    targets = torch.full((e,), -1, dtype=torch.int32, device=tgt.device)
    targets[run_id[newrun]] = st[newrun]
    u_count = int(newrun.sum())  # one host read per connect
    return targets, new_src, u_count


def intra_wave_candidates(metric, vecs, elems, eligible, mi: int):
    """Top-mi nearest eligible *wave-mates* per wave member, from one (B, B)
    distance block.  Members of a wave search the frozen graph and never
    see each other; folding the nearest wave-mates into each member's pool
    restores those edges.  Returns (dists (B, mi), elem ids (B, mi))."""
    d = _pairwise_dists(metric, vecs, elems[None, :])[0]  # (B, B)
    b = d.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=d.device)
    d = torch.where(eye | ~eligible[None, :], torch.inf, d)
    d_s, pos = torch.sort(d, dim=1, stable=True)
    d_s, pos = d_s[:, :mi], pos[:, :mi]
    ids = torch.where(torch.isinf(d_s), -1, elems[pos])
    return torch.where(ids >= 0, d_s, torch.inf), ids


def connect_level(metric, vecs, nbr0, nbr_up, kept0, kept_up, up_slot,
                  elems, eligible, level: int, pool_d, pool_i, m: int,
                  mi: int, smax: int, chunk: int) -> None:
    """One connect pass for one level of an insert wave: intra-wave
    candidates, SelectNeighbors per wave member, own-list writes, then
    backlink merges grouped by target.  The graph tensors ``nbr0``,
    ``nbr_up``, ``kept0`` and ``kept_up`` are updated in place, where the
    reference donates them to its jitted kernel."""
    level0 = level == 0
    lm = 2 * m if level0 else m
    # 1. blank ineligible rows, fold intra-wave candidates into the pools
    pool_d = torch.where(eligible[:, None], pool_d, torch.inf)
    pool_i = torch.where(eligible[:, None], pool_i, -1)
    if mi > 0:
        intra_d, intra_i = intra_wave_candidates(metric, vecs, elems, eligible,
                                                 mi)
        intra_i = torch.where(eligible[:, None], intra_i, -1)
        intra_d = torch.where(intra_i >= 0, intra_d, torch.inf)
        pool_d = torch.cat([pool_d, intra_d], dim=1)
        pool_i = torch.cat([pool_i, intra_i], dim=1)
    # 2. SelectNeighbors over each member's pool (Algorithm 4)
    pair = _pairwise_dists(metric, vecs, pool_i)
    sel, keptf, pos = _select_from(pool_i, pool_d, pair, lm)
    sel_d = torch.where(pos >= 0, torch.gather(pool_d, 1, _long(pos)),
                        torch.inf)
    # 3. write own lists (rows of ineligible members are dropped)
    lvl_idx = max(level - 1, 0)
    if level0:
        rows = elems[eligible].long()
        nbr0[rows] = sel[eligible]
        kept0[rows] = keptf[eligible]
    else:
        slots = up_slot[_long(elems)]
        okw = eligible & (slots >= 0)
        nbr_up[slots[okw].long(), lvl_idx] = sel[okw]
        kept_up[slots[okw].long(), lvl_idx] = keptf[okw]
    # 4. backlinks: group (src → tgt) edges by target, then merge chunks of
    # targets with the wholesale select.  Targets are unique, so no chunk
    # reads another chunk's writes and each chunk writes back at once.
    tgt = sel.reshape(-1)
    src = torch.repeat_interleave(torch.where(eligible, elems, -1), lm)
    targets, new_src, u_count = _group_edges(tgt, src, sel_d.reshape(-1),
                                             smax)
    for s in range(0, u_count, chunk):
        t_c = targets[s:min(s + chunk, u_count)]
        s_c = new_src[s:min(s + chunk, u_count)]
        if level0:
            okc = t_c >= 0
            old = torch.where(okc[:, None], nbr0[_long(t_c)], -1)
            oldk = kept0[_long(t_c)] & okc[:, None]
        else:
            slots_c = up_slot[_long(t_c)]
            okc = (t_c >= 0) & (slots_c >= 0)
            old = torch.where(okc[:, None],
                              nbr_up[_long(slots_c), lvl_idx], -1)
            oldk = kept_up[_long(slots_c), lvl_idx] & okc[:, None]
        new_l, new_k = merge_backlinks_wholesale(
            metric, vecs, old, oldk, s_c, torch.where(okc, t_c, -1), lm)
        new_l = torch.where(okc[:, None], new_l, -1)
        new_k = new_k & okc[:, None]
        if level0:
            rows = t_c[okc].long()
            nbr0[rows] = new_l[okc]
            kept0[rows] = new_k[okc]
        else:
            rows = slots_c[okc].long()
            nbr_up[rows, lvl_idx] = new_l[okc]
            kept_up[rows, lvl_idx] = new_k[okc]


# ---------------------------------------------------------------------------
# wave search (Algorithm 1's search phase for a batch of new elements)
# ---------------------------------------------------------------------------


def _wave_level_loop(score, qs, lv, entry: int, entry_level: int, ef: int,
                     l_unroll: int, greedy_fn: Callable, beam_fn: Callable):
    """Level structure of Algorithm 1 over levels l_unroll..0.  ``lv`` is
    the host copy of the wave's levels; a level where no query runs a
    greedy step or a beam changes nothing and is skipped (the reference
    runs it masked)."""
    dev = qs.device
    nq = len(lv)
    lv_t = torch.as_tensor(lv, dtype=torch.int32, device=dev)
    lv_max = int(lv.max()) if nq else -1
    cur = torch.full((nq,), entry, dtype=torch.int32, device=dev)
    cur_d = score(qs, cur[:, None])[:, 0]
    lv_c = torch.clamp(lv_t, max=entry_level)
    pool_d = torch.full((nq, ef), torch.inf, device=dev)
    pool_i = torch.full((nq, ef), -1, dtype=torch.int32, device=dev)
    out_d = [None] * (l_unroll + 1)
    out_i = [None] * (l_unroll + 1)
    for lc in range(l_unroll, -1, -1):
        # above the entry level every list is empty: nothing moves
        active = lc <= entry_level
        if lc >= 1 and active and int(lv.min()) < lc:
            g_cur, g_d = greedy_fn(lc, qs, cur, cur_d)
            gm = lv_t < lc
            cur = torch.where(gm, g_cur, cur)
            cur_d = torch.where(gm, g_d, cur_d)
        if active and lv_max >= lc:
            first = (lv_c == lc)[:, None]
            col0 = torch.arange(ef, device=dev)[None, :] == 0
            pool_d = torch.where(first, torch.where(col0, cur_d[:, None],
                                                    torch.inf), pool_d)
            pool_i = torch.where(first, torch.where(col0, cur[:, None], -1),
                                 pool_i)
            pd, pi = beam_fn(lc, qs, pool_d, pool_i)
            bm = (lv_t >= lc)[:, None]
            pool_d = torch.where(bm, pd, pool_d)
            pool_i = torch.where(bm, pi, pool_i)
        out_d[lc] = pool_d
        out_i[lc] = pool_i
    return torch.stack(out_d), torch.stack(out_i)


def wave_search(metric, vecs, nbr0, nbr_up, up_slot, qs, lv, entry: int,
                entry_level: int, ef: int, l_unroll: int, expand: int = 1):
    """Algorithm 1's search for a wave of new elements.  Returns stacked
    per-level pools (l_unroll+1, Q, ef)."""
    score = make_scorer(metric, vecs)
    nbrs = _neighbors_closure(nbr0, nbr_up, up_slot)

    def greedy_fn(lc, qs_, cur, cur_d):
        return greedy_descent(score, nbrs, qs_, cur, cur_d, lc, max_steps=512)

    def beam_fn(lc, qs_, pool_d, pool_i):
        pd, pi, _ = search_layer(
            score, lambda e: nbrs(e, lc), qs_, pool_d, pool_i, ef=ef,
            max_steps=4 * ef + 64, expand=expand)
        return pd, pi

    return _wave_level_loop(score, qs, lv, entry, entry_level, ef, l_unroll,
                            greedy_fn, beam_fn)


# ---------------------------------------------------------------------------
# query search (Algorithm 5)
# ---------------------------------------------------------------------------


def _expand_topk(pool_d, pool_i, elem_rows, row_valid, fmask, k: int,
                 heaptids: int):
    """Heap-TID expansion + validity/filter mask + top-k
    (hnswscan.c:286-303)."""
    nq = pool_d.shape[0]
    rows = elem_rows[_long(pool_i)].reshape(nq, -1)
    rd = torch.repeat_interleave(pool_d, heaptids, dim=1)
    rows = torch.where(torch.repeat_interleave(pool_i, heaptids, dim=1) >= 0,
                       rows, -1)
    ok = (rows >= 0) & row_valid[_long(rows)]
    if fmask is not None:
        ok = ok & fmask[_long(rows)]
    rd = torch.where(ok, rd, torch.inf)
    kk = min(k, rd.shape[1])
    d, selpos = torch.sort(rd, dim=1, stable=True)
    d, selpos = d[:, :kk], selpos[:, :kk]
    r = torch.gather(rows, 1, selpos)
    if kk < k:
        d = torch.cat([d, d.new_full((nq, k - kk), torch.inf)], dim=1)
        r = torch.cat([r, r.new_full((nq, k - kk), -1)], dim=1)
    return d, torch.where(torch.isinf(d), -1, r)


def query_search(metric, vecs, nbr0, nbr_up, up_slot, elem_rows, row_valid,
                 fmask, qs, entry: int, entry_level: int, ef: int, k: int,
                 heaptids: int, expand: int = 1, packed_vals=None,
                 rerank: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Algorithm 5 (hnswscan.c:25-56): greedy descent through the upper
    levels, the ef beam at layer 0, then heap-TID expansion.

    ``packed_vals`` — optional adjacency-packed neighbor values
    (nbr_vals[cap, 2m, D], f32 or bf16): layer 0 scores whole neighbor
    slabs, and each hop's tail runs in K2.  With ``rerank`` the final pool
    is re-scored against the exact f32 values, so a bf16 cache changes
    only pool admission, never the emitted order.  Returns (stored
    distances, row ids, layer-0 hops)."""
    score = make_scorer(metric, vecs)
    nbrs = _neighbors_closure(nbr0, nbr_up, up_slot)
    nq = qs.shape[0]
    cur = torch.full((nq,), entry, dtype=torch.int32, device=qs.device)
    cur_d = score(qs, cur[:, None])[:, 0]
    for lc in range(entry_level, 0, -1):
        cur, cur_d = greedy_descent(score, nbrs, qs, cur, cur_d, lc,
                                    max_steps=512)
    packed = (packed_vals, qs) if packed_vals is not None else None
    pool_d, pool_i, steps = search_layer(
        score, lambda e: nbrs(e, 0), qs, cur_d[:, None], cur[:, None],
        ef=ef, max_steps=8 * ef + 64, expand=expand,
        packed=packed, metric=metric)
    if rerank:
        pool_d = score(qs, pool_i)  # exact f32 distances for the final pool
        pool_d, order = torch.sort(pool_d, dim=1, stable=True)
        pool_i = torch.gather(pool_i, 1, order)
    d, r = _expand_topk(pool_d, pool_i, elem_rows, row_valid, fmask, k,
                        heaptids)
    return d, r, steps
