"""HNSW device code — counterpart of ``pgvector_tpu.index.hnsw_kernels``
(the single-device subset) for the three kinds of index values: ``dense``
(a (cap, D) tensor), ``bit`` (packed (cap, W) int32 words) and ``sparse``
(an (idx, val) pair of padded (cap, P) rows).  The functions take the
reference's ``(kind, metric, values, ..., sdim)``; ``sdim > 0`` selects
the densified sparse scorer and pairwise block.

The reference walks the graph one candidate at a time (HnswSearchLayer,
Algorithm 2, hnswutils.c:822-985).  Here, as in the JAX package, one call
runs the algorithm for a whole batch of queries: the pool (C and W merged
into one ef-bounded sorted tensor with expanded flags), the per-hop
neighbor gather and the distances are (Q, ·)-shaped tensor ops.
SelectNeighbors (Algorithm 4, hnswutils.c:1062-1163) is a pairwise
distance block plus a sequential keep/prune loop over the candidates.

From JAX to PyTorch:

- each ``lax.while_loop`` is a Python loop whose stop test reads one
  device scalar: the beam loops every :data:`HOP_READ_EVERY` hops
  (``.item()``; a hop after a query is done changes nothing for it), the
  greedy walk every step;
- ids stay int32 in every stored tensor and become int64 only to index;
  JAX clamps out-of-range gathers and drops out-of-range scatters, torch
  raises, so every index is clamped or masked before use;
- ``lax.sort`` and ``lax.top_k`` become stable ``torch.sort`` calls
  sliced to size: ties keep position order, as the Pallas hop tail does;
- graph arrays are updated in place where the reference donates them.

Plain scans and builds take the visited set that
``PGVECTOR_TPU_VISITED`` names (:func:`visited_mode`: ``off`` by default,
as in the reference, where the pool membership check alone keeps the ef
pool duplicate-free; ``hash1`` or ``hash2``), and a caller may pass its
own ``vmode``: the device-sharded HNSW search passes ``hash2``, the
reference's default argument.  Iterative scans keep a ``hash2`` visited
table and a discarded pool across resumes (:func:`query_search_first`,
:func:`query_search_resume`) and, as in the reference, take the
row-gather hop.  The packed query hop of a dense index is one K2 launch
(:func:`..ops.packed_hop.packed_hop`: the E-selection, the lists, the
dedupe, the slab scores and the merge in one kernel, the pool kept packed
from hop to hop) when the visited set is ``off`` (K2 takes no table, as
the reference's Pallas tail); under ``hash1`` or ``hash2`` the hop scores
the same slabs in plain torch ops and probes the table before scoring.
The row-gather hop of a dense index (every build wave's beam) is, under
the same condition, one K6 launch a hop
(:func:`..ops.gather_hop.gather_hop`: the E-selection, the list reads and
the merge in one kernel, the pool kept packed from hop to hop), and
SelectNeighbors' keep/prune loop is K3
(:func:`..ops.select_neighbors.select_neighbors`) everywhere, which for
dense L2, inner product and cosine forms the pairwise distances from the
Gram block itself.  Every bit distance — hop, wave search and pairwise
select block — is K5 (:func:`..ops.bit_scan.bit_point_scores`).

The mesh build (:func:`wave_search_sharded`, :func:`connect_level_sharded`)
splits a wave's queries and its select rows and backlink chunks over the
devices of a ``parallel.Mesh``, one device after another from this
process, and gathers the results in device order; the graph it writes is
the single-device build's, bit for bit.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import torch

from ..ops.bit_scan import bit_point_scores
from ..ops.distance import (dense_point_scores, dot_precision,
                            highest_precision, int8_query, scatter_dense,
                            sparse_scores_batch)
# the int8 slab's scorer sits beside dense_point_scores, which K2's plain
# version imports; the reference keeps it here (hnsw_kernels.py:202)
from ..ops.distance import int8_point_scores  # noqa: F401
from ..ops.gather_hop import dedupe_hop, gather_hop, hop_buffers
from ..ops.metric import Metric
from ..ops.packed_hop import packed_hop
from ..ops.select_neighbors import Gram, form_pairs, select_neighbors
from ..parallel.mesh import all_gather, shard_rows, to_device

_MASK32 = 0xFFFFFFFF

#: the beam loops read the device (is every query done) once every this
#: many hops; the hops run past the last one that did work change nothing
#: (measured on an H100: PERF.md, tools/hop_read_sweep.py)
HOP_READ_EVERY = 4


def _long(x: torch.Tensor) -> torch.Tensor:
    """Clamp ids (-1 = none) to a valid row and widen them to index."""
    return torch.clamp(x, min=0).long()


# ---------------------------------------------------------------------------
# distance closure: query batch -> distances to a (Q, R) block of element ids
# ---------------------------------------------------------------------------


_SPARSE_DENSE_METRICS = (Metric.L2, Metric.IP, Metric.COSINE)


def make_scorer(kind: str, metric: Metric, values, sdim: int = 0):
    """score(qs, rows) -> (Q, R) f32 distances from the query batch ``qs``
    (the query rep: (Q, D) values, (Q, W) words, or a (q_idx, q_val) pair)
    to the stored values of element ids ``rows`` (negative ids give +inf).

    ``bit`` runs K5.  ``sparse`` with ``sdim > 0`` (L2/IP/cosine) is the
    *densified-query* scorer: the query batch is scattered once into dense
    (Q, sdim + 1) lanes and each candidate's query-side values come from a
    gather at its indices; otherwise the merge join."""
    if kind == "dense":
        def score(qs, rows):
            return dense_point_scores(metric, qs, values[_long(rows)], rows)

        return score
    if kind == "bit":
        def score(qs, rows):
            return bit_point_scores(metric, qs, values, rows)

        return score
    if kind != "sparse":
        raise ValueError(kind)
    idx_arr, val_arr = values
    if sdim > 0 and metric in _SPARSE_DENSE_METRICS:
        memo = [None, None]  # the densified query batch of the last call

        def score(qs, rows):
            q_idx, q_val = qs
            if memo[0] is not q_idx:
                memo[0], memo[1] = q_idx, scatter_dense(q_idx, q_val, sdim)
            qd = memo[1]
            safe = _long(rows)
            ridx, rval = idx_arr[safe], val_arr[safe]  # (Q, R, P)
            ci = torch.clamp(ridx, max=sdim).long().reshape(qd.shape[0], -1)
            qv_at = torch.gather(qd, 1, ci).reshape(ridx.shape)
            ip = torch.sum(qv_at * rval, dim=-1)
            if metric is Metric.IP:
                d = -ip
            else:
                q_sq = torch.sum(q_val * q_val, dim=-1)[:, None]
                r_sq = torch.sum(rval * rval, dim=-1)
                if metric is Metric.L2:
                    d = torch.clamp(q_sq + r_sq - 2.0 * ip, min=0.0)
                else:
                    denom = torch.sqrt(q_sq * r_sq)
                    cos = torch.where(
                        denom > 0, ip / torch.where(denom > 0, denom, 1.0),
                        -torch.inf)
                    d = 1.0 - cos
            return torch.where(rows >= 0, d, torch.inf)

        return score

    def score(qs, rows):
        q_idx, q_val = qs
        safe = _long(rows)
        d = sparse_scores_batch(metric, q_idx, q_val, idx_arr[safe],
                                val_arr[safe])
        return torch.where(rows >= 0, d, torch.inf)

    return score


def elems_as_queries(kind: str, values, elems: torch.Tensor):
    """Stored elements as the query side (build-time searches)."""
    safe = _long(elems)
    if kind == "sparse":
        return (values[0][safe], values[1][safe])
    return values[safe]


def _nq(qs) -> int:
    return qs[0].shape[0] if isinstance(qs, tuple) else qs.shape[0]


def _dev(qs) -> torch.device:
    return qs[0].device if isinstance(qs, tuple) else qs.device


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
# visited set: a per-query open-addressing table of element ids
# ---------------------------------------------------------------------------

#: the two multiplicative salts of the table's slots (the golden-ratio
#: constant and murmur3's c2)
_V_SALT1 = 0x9E3779B1
_V_SALT2 = 0x85EBCA77


#: the visited-set structures a scan or build may take
VISITED_MODES = ("off", "hash1", "hash2")


def visited_mode() -> str:
    """The visited set of plain scans and builds, from
    ``PGVECTOR_TPU_VISITED`` (hnsw_kernels.py:303-323): ``off`` (the
    default: no table; the pool membership check keeps the ef pool
    duplicate-free and an evicted node re-enters only while it beats the
    pool's worst), ``hash1`` (one probe a slot) or ``hash2`` (the exact
    2-choice table)."""
    mode = os.environ.get("PGVECTOR_TPU_VISITED", "off")
    if mode not in VISITED_MODES:
        raise ValueError(f'PGVECTOR_TPU_VISITED "{mode}" is not one of '
                         f"{', '.join(VISITED_MODES)}")
    return mode


def visited_capacity(ef: int) -> int:
    """Table width per query: the typical layer-0 visit count (~ef·lm/2
    scored candidates) stays under ~1/3 load with 2-choice probing.  A
    power of two, so a slot is the top bits of a 32-bit hash."""
    h = 8192
    while h < 128 * ef:
        h *= 2
    return h


def visited_init(nq: int, ef: int, mode: str = "hash2",
                 device=None) -> torch.Tensor:
    """An empty (nq, visited_capacity(ef)) table for ``hash1`` or
    ``hash2`` (-1 marks an empty slot)."""
    return torch.full((nq, visited_capacity(ef)), -1, dtype=torch.int32,
                      device=device)


def _v_slots(table: torch.Tensor, elems: torch.Tensor):
    """The two candidate slots of each id: the top bits of id × salt mod
    2^32 (int64 arithmetic; ids are below 2^30, so no product overflows).
    Negative ids hash as 0; their writes are no-ops."""
    bits = int(table.shape[1]).bit_length() - 1
    shift = 32 - bits
    x = _long(elems)
    s1 = ((x * _V_SALT1) & _MASK32) >> shift
    s2 = ((x * _V_SALT2) & _MASK32) >> shift
    return s1, s2


def visited_probe(table: torch.Tensor, elems: torch.Tensor,
                  mode: str = "hash2"):
    """Membership check and insert for a (Q, R) block of element ids
    (negative ids ignored).  Returns (table, seen): ``seen`` is True only
    for elements present before this call.  The table is updated in place.
    ``hash1`` probes one slot (a failed insert means the element may be
    scored again later — wasted work, never a wrong answer).

    Inserts are scatter-max into empty slots (-1): racing inserts into one
    slot pick the largest id, and occupied slots receive -1, so an insert
    never evicts an occupant — the invariant resumed scans depend on."""
    nq, h = table.shape
    base = torch.arange(nq, device=table.device)[:, None] * h
    s1, s2 = _v_slots(table, elems)
    f1, f2 = (base + s1).reshape(-1), (base + s2).reshape(-1)
    flat = table.view(-1)
    live = elems >= 0
    occ1 = flat[f1].view(elems.shape)
    if mode == "hash1":
        seen = (occ1 == elems) & live
        want1 = ~seen & live & (occ1 < 0)
        flat.scatter_reduce_(0, f1, torch.where(want1, elems, -1).reshape(-1),
                             "amax")
        return table, seen
    occ2 = flat[f2].view(elems.shape)
    seen = ((occ1 == elems) | (occ2 == elems)) & live
    # pass 1: empty first slots
    want1 = ~seen & live & (occ1 < 0)
    flat.scatter_reduce_(0, f1, torch.where(want1, elems, -1).reshape(-1),
                         "amax")
    won1 = flat[f1].view(elems.shape) == elems
    # pass 2: the rest try their second slot.  Its occupancy is read again
    # after pass 1, which may have just filled it: a stale read would let
    # the scatter-max evict pass 1's fresh occupant
    rem = ~seen & live & ~(want1 & won1)
    occ2 = flat[f2].view(elems.shape)
    want2 = rem & (occ2 < 0)
    flat.scatter_reduce_(0, f2, torch.where(want2, elems, -1).reshape(-1),
                         "amax")
    return table, seen


# ---------------------------------------------------------------------------
# one beam hop (the body of Algorithm 2)
# ---------------------------------------------------------------------------


def _hop_body(score, neighbors_of, qs, pool_d, pool_i, pool_x, ef: int,
              expand: int = 1, packed=None, metric: Optional[Metric] = None,
              visited=None, disc=None, vmode: str = "off"):
    """One expansion hop: pop the ``expand`` nearest unexpanded candidates
    per query, gather their neighbors, score the unvisited ones and merge
    them into the pool.  Returns (pool_d, pool_i, pool_x, visited, done).

    ``visited`` — the (Q, H) visited table, probed with ``vmode``
    (``hash1``/``hash2``; ``off`` leaves it None).

    ``disc`` — optional (disc_d, disc_i) discarded pool: candidates evicted
    past the ef bound are merged into it (the discarded pairing heap of
    iterative scans, hnswutils.c:936-971).  Then the return is (pool_d,
    pool_i, pool_x, visited, disc, done, scored), ``scored`` the number of
    candidates each query scored in this hop.

    ``packed`` — optional ``(nbr_vals, qs_p, nbr0, int8)``:
    adjacency-packed neighbor values ``nbr_vals[cap, 2m, D]`` (f32, bf16
    or int8), the queries to score them against, the level-0 lists and,
    for an int8 slab, ``(qc, sq, q2, pnorm2, scale)`` (else None).  Each
    expanded node's neighbor values are one contiguous slab, scored in
    torch ops after the duplicate, pool and visited checks (the
    reference's packed path outside its Pallas tail,
    hnsw_kernels.py:464-516).  Without ``packed`` the candidates' rows are
    scored through ``score``.  With the visited set ``off`` and no
    discarded pool, :func:`search_layer` runs a packed hop as one K2
    launch and a dense index's row-gather hop as one K6 launch instead."""
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
    sel_flat = sel_elem.reshape(-1)
    if packed is not None:
        return _packed_hop_visited(pool_d, pool_i, pool_x, sel_flat,
                                   packed, metric, visited, ef, disc, done,
                                   vmode)
    # all selected candidates' neighbors in one flattened gather
    nb = neighbors_of(sel_flat)
    nbrs = torch.where(sel_flat[:, None] >= 0, nb, -1).reshape(nq, -1)
    if sel_elem.shape[1] > 1:
        # dedupe within the hop (two expanded nodes sharing a neighbor)
        nbrs = dedupe_hop(nbrs)
    # pool-membership check keeps the ef pool duplicate-free (also when a
    # visited-table insert failed)
    in_pool = torch.any(nbrs[:, :, None] == pool_i[:, None, :], dim=2)
    nbrs = torch.where(in_pool, -1, nbrs)
    if vmode != "off":
        visited, seen = visited_probe(visited, nbrs, vmode)
        nbrs = torch.where(seen, -1, nbrs)
    nd = score(qs, nbrs)
    return _hop_merge(pool_d, pool_i, pool_x, nbrs, nd, visited, ef, disc,
                      done)


def _packed_hop_visited(pool_d, pool_i, pool_x, sel_flat, packed,
                        metric: Metric, visited, ef: int, disc, done,
                        vmode: str):
    """The packed hop in torch ops (with a visited table, or a
    discarded pool): each selected element's slab stays in adjacency
    order, so a repeated id is masked in place (a strictly-lower-triangle
    compare) rather than sorted away; ids already in the pool and ids the
    table has seen (``vmode`` ``hash1`` / ``hash2``) are masked too, then
    the slab scores and the merge."""
    nbr_vals, qs_p, nbr0, int8 = packed
    nq = pool_d.shape[0]
    safe = _long(sel_flat)
    nbrs = torch.where(sel_flat[:, None] >= 0, nbr0[safe], -1).reshape(nq, -1)
    w = nbrs.shape[1]
    v = nbr_vals[safe].reshape(nq, w, nbr_vals.shape[-1])
    if w > nbr0.shape[1]:
        tri = torch.ones((w, w), dtype=torch.bool,
                         device=nbrs.device).tril(-1)
        dup = torch.any((nbrs[:, :, None] == nbrs[:, None, :]) & tri[None]
                        & (nbrs >= 0)[:, None, :], dim=2)
        nbrs = torch.where(dup, -1, nbrs)
    in_pool = torch.any(nbrs[:, :, None] == pool_i[:, None, :], dim=2)
    nbrs = torch.where(in_pool, -1, nbrs)
    if vmode != "off":
        visited, seen = visited_probe(visited, nbrs, vmode)
        nbrs = torch.where(seen, -1, nbrs)
    if int8 is None:
        nd = dense_point_scores(metric, qs_p, v, nbrs)
    else:
        qc, sq, q2, pnorm2, scale = int8
        nd = int8_point_scores(metric, qs_p, scale, pnorm2, v, nbrs,
                               query=(qc, sq, q2))
    return _hop_merge(pool_d, pool_i, pool_x, nbrs, nd, visited, ef, disc,
                      done)


def _hop_merge(pool_d, pool_i, pool_x, nbrs, nd, visited, ef: int, disc,
               done):
    """Merge scored candidates into the ef pool: (id·2 | expanded) packed
    into one int32 rides a stable sort by distance (-1 packs to -2 and
    unpacks back through the arithmetic shift).  With ``disc``, what falls
    past the ef bound is merged into the discarded pool, and each query's
    scored-candidate count comes back too: the reference counts every
    tuple whose distance HnswSearchLayer computes, which is what
    hnsw.max_scan_tuples meters (hnswscan.c:255-266)."""
    d = torch.cat([pool_d, nd], dim=1)
    packed = torch.cat([pool_i * 2 + pool_x.to(torch.int32), nbrs * 2], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    if disc is None:
        packed = torch.gather(packed, 1, order[:, :ef])
        return d[:, :ef], packed >> 1, (packed & 1) == 1, visited, done
    packed = torch.gather(packed, 1, order)
    i = packed >> 1
    disc_d, disc_i = disc
    dk = disc_d.shape[1]
    dd = torch.cat([disc_d, d[:, ef:]], dim=1)
    di = torch.cat([disc_i, i[:, ef:]], dim=1)
    dd, o = torch.sort(dd, dim=1, stable=True)
    disc = (dd[:, :dk], torch.gather(di, 1, o[:, :dk]))
    scored = torch.sum(nbrs >= 0, dim=1, dtype=torch.int32)
    return (d[:, :ef], i[:, :ef], (packed[:, :ef] & 1) == 1, visited, disc,
            done, scored)


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


def _pool_seed(init_d, init_i, visited, ef: int, vmode: str = "off"):
    """The initial sorted pool, its seeds recorded in the visited table."""
    pool_d, pool_i, pool_x = _init_pool(init_d, init_i, ef)
    if vmode != "off":
        visited, _ = visited_probe(visited, pool_i, vmode)
    return pool_d, pool_i, pool_x, visited


def search_layer(score, neighbors_of, qs, init_d, init_i, ef: int,
                 max_steps: int, expand: int = 1, packed=None, metric=None,
                 visited=None, disc=None, vmode: str = "off", rows=None,
                 lists=None, stats: Optional[dict] = None):
    """Algorithm 2 (HnswSearchLayer, hnswutils.c:822-985), batched.
    Returns (pool_d, pool_i, steps); with ``disc`` (a (disc_d, disc_i)
    pair), (pool_d, pool_i, visited, disc, steps, scanned), ``scanned``
    each query's scored candidates.  ``steps`` is the reference's: the
    hops until every query was done, at most ``max_steps``.  One host
    read every :data:`HOP_READ_EVERY` hops decides whether every query is
    done, so up to HOP_READ_EVERY - 1 hops more than ``steps`` may run
    (never past ``max_steps``); ``stats``, where given, receives the hops
    run (``"launches"``) and ``"steps"``.  With the visited set ``off``
    and no discarded pool, ``packed`` (see :func:`_hop_body`) selects K2,
    one :func:`..ops.packed_hop.packed_hop` launch a hop, and ``rows``,
    the (N, D) value table of a dense index, with ``lists``, the level's
    tables ``(nbr0, nbr_up, up_slot, level)``, selects K6, one
    :func:`..ops.gather_hop.gather_hop` launch a hop; both keep the pool
    packed from hop to hop.  Otherwise each hop is :func:`_hop_body`."""
    if disc is None and vmode == "off":
        if packed is not None:
            nbr_vals, qs_p, nbr0, int8 = packed
            qs_p = qs_p.contiguous()

            def hop(pool_d, pool_p, **kw):
                return packed_hop(pool_d, pool_p, nbr0, nbr_vals, qs_p, ef,
                                  expand, metric, int8, **kw)
            return _kernel_search(hop, init_d, init_i, ef, max_steps, stats)
        if rows is not None and lists is not None:
            nbr0, nbr_up, up_slot, level = lists
            qs_c = qs.contiguous()

            def hop(pool_d, pool_p, **kw):
                return gather_hop(pool_d, pool_p, nbr0, nbr_up, up_slot,
                                  level, rows, qs_c, ef, expand, metric, **kw)
            return _kernel_search(hop, init_d, init_i, ef, max_steps, stats)
    pool_d, pool_i, pool_x, visited = _pool_seed(init_d, init_i, visited,
                                                 ef, vmode)
    nq = pool_d.shape[0]
    scanned = (torch.zeros(nq, dtype=torch.int32, device=pool_d.device)
               if disc is not None else None)
    hops = torch.zeros(nq, dtype=torch.int32, device=pool_d.device)
    done = torch.zeros(nq, dtype=torch.bool, device=pool_d.device)
    launched = 0
    while launched < max_steps:
        hops += (~done).to(torch.int32)  # up to the hop that finds it done
        out = _hop_body(score, neighbors_of, qs, pool_d, pool_i, pool_x, ef,
                        expand, packed=packed, metric=metric, visited=visited,
                        disc=disc, vmode=vmode)
        if disc is None:
            pool_d, pool_i, pool_x, visited, done = out
        else:
            pool_d, pool_i, pool_x, visited, disc, done, scored = out
            scanned += scored
        launched += 1
        if _read_due(launched, max_steps) and bool(done.all()):
            break
    steps = _steps(hops, launched, stats)
    if disc is None:
        return pool_d, pool_i, steps
    return pool_d, pool_i, visited, disc, steps, scanned


def _read_due(launched: int, max_steps: int) -> bool:
    """Whether a beam loop reads the device after this hop: every
    HOP_READ_EVERY hops, and not after the last."""
    return launched % HOP_READ_EVERY == 0 and launched < max_steps


def _steps(hops, launched: int, stats) -> int:
    """The reference's hop count, the largest of the queries' (one host
    read; with no query, the hops run), recorded in ``stats`` with the
    hops run and each query's count."""
    steps = int(hops.max()) if hops is not None and hops.numel() else launched
    if stats is not None:
        stats.update(launches=launched, steps=steps, hops=hops)
    return steps


def _kernel_search(hop, init_d, init_i, ef: int, max_steps: int, stats):
    """:func:`search_layer` on K2 or K6 (``hop``, the kernel's wrapper
    with all but the pool and the state bound): the pool packed once, one
    launch a hop into two sets of buffers in turn, the count of queries
    not done read every :data:`HOP_READ_EVERY` hops, the pool unpacked
    once at the end."""
    pool_d, pool_i, _ = _init_pool(init_d, init_i, ef)
    pool_p = (pool_i * 2).contiguous()  # nothing expanded yet
    outs = [None, None]
    if pool_d.is_cuda:
        outs[0] = hop_buffers(pool_d.shape[0], ef, pool_d.device)
        outs[1] = hop_buffers(pool_d.shape[0], ef, pool_d.device, outs[0][5])
    done = hops = None
    launched = 0
    while launched < max_steps:
        pool_d, pool_p, done, left, hops = hop(
            pool_d, pool_p, done=done, hops=hops, out=outs[launched % 2])
        launched += 1
        if _read_due(launched, max_steps) and int(left.item()) == 0:
            break
    return pool_d, pool_p >> 1, _steps(hops, launched, stats)


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


#: rows of one batched product of the pairwise block.  Every call but the
#: one-row intra-wave block takes this shape, padded, so the library runs
#: one algorithm whatever the number of rows and a row's distances do not
#: depend on the rows beside it: the mesh build splits select rows over
#: devices and must give the single-device graph bit for bit
PAIR_BLOCK = 256

#: the fewest wave queries a device of the mesh build takes: CUDA's sum
#: reductions pick their thread layout by the number of outputs below 16,
#: and the entry point's distance is one output a query
SHARD_MIN_QUERIES = 16


def _gram(v: torch.Tensor) -> torch.Tensor:
    """(T, C, C) products ``v @ v.T`` of a (T, C, D) block, PAIR_BLOCK
    rows a call (the last block zero-padded), each full block written in
    place into the result."""
    t = v.shape[0]
    if t <= 1:
        return torch.bmm(v, v.transpose(1, 2))

    def padded(blk):
        n = blk.shape[0]
        blk = torch.cat([blk, blk.new_zeros((PAIR_BLOCK - n,)
                                            + tuple(blk.shape[1:]))])
        return torch.bmm(blk, blk.transpose(1, 2))[:n]

    if t < PAIR_BLOCK:
        return padded(v)
    out = v.new_empty((t, v.shape[1], v.shape[1]))
    for s in range(0, t, PAIR_BLOCK):
        blk = v[s: s + PAIR_BLOCK]
        if blk.shape[0] == PAIR_BLOCK:
            torch.bmm(blk, blk.transpose(1, 2), out=out[s: s + PAIR_BLOCK])
        else:
            out[s:] = padded(blk)
    return out


def _pair_block(kind: str, metric: Metric, values, elems: torch.Tensor,
                sdim: int = 0):
    """What SelectNeighbors (K3) takes for each row's candidate elements:
    for dense L2/IP/cos the :class:`..ops.select_neighbors.Gram` form of
    the block (the products of :func:`_gram` and, for L2, the norms; K3
    forms each entry it reads), else the formed (T, C, C) block of
    :func:`_pairwise_dists`."""
    if kind == "dense" and metric in (Metric.L2, Metric.IP, Metric.COSINE):
        v = values[_long(elems)].float()  # (T, C, D)
        dot_precision()
        ip = _gram(v)
        if metric is Metric.L2:
            return Gram(ip, torch.sum(v * v, dim=-1), True)
        return Gram(ip, None, False)
    return _pairwise_dists(kind, metric, values, elems, sdim)


def _pairwise_dists(kind: str, metric: Metric, values, elems: torch.Tensor,
                    sdim: int = 0) -> torch.Tensor:
    """(T, C, C) stored distances among each row's candidate elements.

    Dense L2/IP/cos ride batched f32 products (:func:`_pair_block`'s Gram
    form, formed by :func:`..ops.select_neighbors.form_pairs`; the
    reference left them to XLA at HIGHEST precision); dense L1 is a
    broadcast block.  Bit runs
    K5 with the candidates' own words as the queries, (T·C, W) against
    rows (T·C, C), so no (T, C, C, W) block is built.  Sparse with
    ``sdim > 0`` (L2/IP/cos) scatters each candidate dense into (sdim,)
    lanes and takes one batched product plus norm corrections; otherwise
    (L1, huge dims) the merge join of every candidate against its row."""
    if kind == "dense" and metric in (Metric.L2, Metric.IP, Metric.COSINE):
        return form_pairs(_pair_block(kind, metric, values, elems),
                          elems >= 0)
    ok = (elems[:, :, None] >= 0) & (elems[:, None, :] >= 0)
    safe = _long(elems)
    t, c = elems.shape
    if kind == "dense":
        v = values[safe].float()  # (T, C, D)
        d = torch.sum(torch.abs(v[:, :, None, :] - v[:, None, :, :]),
                      dim=-1)
    elif kind == "bit":
        rows = elems[:, None, :].expand(t, c, c).reshape(t * c, c)
        d = bit_point_scores(metric, values[safe.reshape(-1)], values,
                             rows).reshape(t, c, c)
    else:
        ridx, rval = values[0][safe], values[1][safe]  # (T, C, P)
        p = ridx.shape[2]
        if sdim > 0 and metric in _SPARSE_DENSE_METRICS:
            v = scatter_dense(ridx.reshape(t * c, p), rval.reshape(t * c, p),
                              sdim)[:, :sdim].reshape(t, c, sdim)
            with highest_precision():
                ip = _gram(v)
            if metric is Metric.IP:
                d = -ip
            else:
                sq = torch.sum(rval * rval, dim=-1)  # pads add 0
                if metric is Metric.L2:
                    d = torch.clamp(sq[:, :, None] - 2.0 * ip
                                    + sq[:, None, :], min=0.0)
                else:
                    denom = torch.sqrt(sq[:, :, None] * sq[:, None, :])
                    cos = torch.where(
                        denom > 0, ip / torch.where(denom > 0, denom, 1.0),
                        -torch.inf)
                    d = 1.0 - cos
        else:
            rows_i = ridx[:, None].expand(t, c, c, p).reshape(t * c, c, p)
            rows_v = rval[:, None].expand(t, c, c, p).reshape(t * c, c, p)
            d = sparse_scores_batch(metric, ridx.reshape(t * c, p),
                                    rval.reshape(t * c, p), rows_i,
                                    rows_v).reshape(t, c, c)
    return torch.where(ok, d, torch.inf)


def _select_from(cand, cand_d, pair, lm: int, forced=None):
    """SelectNeighbors over (T, C) pools → ((T, lm) ids, (T, lm) kept);
    ``pair`` the pools' block or its Gram form (:func:`_pair_block`)."""
    pos, kept = select_neighbors(cand_d, pair, cand >= 0, lm, forced)
    sel = torch.where(pos >= 0, torch.gather(cand, 1, _long(pos)), -1)
    return sel, kept & (pos >= 0), pos


def select_connections(kind, metric, values, pool_d, pool_i, lm: int,
                       sdim: int = 0):
    """SelectNeighbors over each base element's candidate pool →
    ((Q, lm) neighbor element ids, (Q, lm) heuristic-kept flags)."""
    pair = _pair_block(kind, metric, values, pool_i, sdim)
    sel, kept, _ = _select_from(pool_i, pool_d, pair, lm)
    return sel, kept


def merge_backlinks_wholesale(kind, metric, values, old_lists, old_kept,
                              new_src, targets, lm: int, sdim: int = 0):
    """One SelectNeighbors over old ∪ new per target.  ``old_kept`` marks
    the incumbents whose heuristic-kept status is sticky.  Returns (new
    lists, new kept flags)."""
    score = make_scorer(kind, metric, values, sdim)
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
    base_d = score(elems_as_queries(kind, values, targets), cand)
    base_d = torch.where(targets[:, None] >= 0, base_d, torch.inf)
    pair = _pair_block(kind, metric, values, cand, sdim)
    sel, kept, _ = _select_from(cand, base_d, pair, lm, forced)
    return sel, kept


def merge_backlinks(kind, metric, values, old_lists, old_kept, new_src,
                    targets, lm: int, sdim: int = 0):
    """HnswUpdateConnection batched by target (hnswutils.c:1181-1229), with
    the reference's *incremental* semantics: each new source is folded one
    at a time — appended while the list has room, else one select over the
    lm+1 candidates with the incumbents' sticky kept flags as the forced
    set (the cached ``closer`` reuse, hnswutils.c:1094-1131), so exactly
    one unprotected slot turns over per source.  Returns ((T, lm) lists,
    (T, lm) kept flags)."""
    score = make_scorer(kind, metric, values, sdim)
    t_rep = elems_as_queries(kind, values, targets)
    t = old_lists.shape[0]
    rows = torch.arange(t, device=old_lists.device)
    cur = old_lists
    curk = old_kept & (old_lists >= 0)
    for j in range(new_src.shape[1]):
        s = new_src[:, j]
        skip = (s < 0) | (targets < 0) | torch.any(cur == s[:, None], dim=1)
        has_free = torch.sum(cur >= 0, dim=1) < lm
        # append path: s into the first free slot (its flag stays False —
        # appended members are backfill until a select admits them)
        first_free = torch.argmax((cur < 0).to(torch.int32), dim=1)
        appended = cur.clone()
        appended[rows, first_free] = torch.where(has_free & ~skip, s,
                                                 cur[rows, first_free])
        # replace path: select lm of the lm+1 candidates; sticky
        # incumbents are forced, so turnover happens in the backfill slots
        cand = torch.cat([cur, s[:, None]], dim=1)
        forced = torch.cat([curk, curk.new_zeros((t, 1))], dim=1)
        base_d = score(t_rep, cand)
        base_d = torch.where(targets[:, None] >= 0, base_d, torch.inf)
        pair = _pair_block(kind, metric, values, cand, sdim)
        pruned, pruned_k, _ = _select_from(cand, base_d, pair, lm, forced)
        keep = skip[:, None]
        cur = torch.where(keep, cur, torch.where(has_free[:, None], appended,
                                                 pruned))
        curk = torch.where(keep, curk, torch.where(has_free[:, None], curk,
                                                   pruned_k))
    return cur, curk


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


def intra_wave_candidates(kind, metric, values, elems, eligible, mi: int,
                          sdim: int = 0):
    """Top-mi nearest eligible *wave-mates* per wave member, from one (B, B)
    distance block.  Members of a wave search the frozen graph and never
    see each other; folding the nearest wave-mates into each member's pool
    restores those edges.  Returns (dists (B, mi), elem ids (B, mi))."""
    d = _pairwise_dists(kind, metric, values, elems[None, :], sdim)[0]
    b = d.shape[0]
    eye = torch.eye(b, dtype=torch.bool, device=d.device)
    d = torch.where(eye | ~eligible[None, :], torch.inf, d)
    d_s, pos = torch.sort(d, dim=1, stable=True)
    d_s, pos = d_s[:, :mi], pos[:, :mi]
    ids = torch.where(torch.isinf(d_s), -1, elems[pos])
    return torch.where(ids >= 0, d_s, torch.inf), ids


def _connect_pools(kind, metric, values, elems, eligible, pool_d, pool_i,
                   mi: int, sdim: int):
    """Step 1 of a connect: blank ineligible rows and fold the intra-wave
    candidates into the pools."""
    pool_d = torch.where(eligible[:, None], pool_d, torch.inf)
    pool_i = torch.where(eligible[:, None], pool_i, -1)
    if mi > 0:
        intra_d, intra_i = intra_wave_candidates(kind, metric, values, elems,
                                                 eligible, mi, sdim)
        intra_i = torch.where(eligible[:, None], intra_i, -1)
        intra_d = torch.where(intra_i >= 0, intra_d, torch.inf)
        pool_d = torch.cat([pool_d, intra_d], dim=1)
        pool_i = torch.cat([pool_i, intra_i], dim=1)
    return pool_d, pool_i


def _connect_select(kind, metric, values, pool_d, pool_i, lm: int,
                    sdim: int):
    """Step 2: SelectNeighbors over each row's pool (Algorithm 4) →
    (selected ids, their distances, kept flags), each (rows, lm)."""
    pair = _pair_block(kind, metric, values, pool_i, sdim)
    sel, keptf, pos = _select_from(pool_i, pool_d, pair, lm)
    sel_d = torch.where(pos >= 0, torch.gather(pool_d, 1, _long(pos)),
                        torch.inf)
    return sel, sel_d, keptf


def _write_lists(nbr0, nbr_up, kept0, kept_up, up_slot, rows, ok, lists,
                 kept, level: int) -> None:
    """Write (rows, lm) lists and kept flags for element ids ``rows``
    where ``ok``: level 0 in place of nbr0, upper levels at the elements'
    up slots (elements without one are dropped)."""
    if level == 0:
        r = rows[ok].long()
        nbr0[r] = lists[ok]
        kept0[r] = kept[ok]
    else:
        slots = up_slot[_long(rows)]
        okw = ok & (slots >= 0)
        nbr_up[slots[okw].long(), level - 1] = lists[okw]
        kept_up[slots[okw].long(), level - 1] = kept[okw]


def _merge_chunk(kind, metric, values, nbr0, nbr_up, kept0, kept_up,
                 up_slot, t_c, s_c, level: int, lm: int, sdim: int):
    """Step 4 for one chunk of unique targets ``t_c`` and their new
    sources ``s_c``: the wholesale select over old ∪ new.  Returns the
    new (lists, kept) and the rows that are real targets."""
    lvl_idx = max(level - 1, 0)
    if level == 0:
        okc = t_c >= 0
        old = torch.where(okc[:, None], nbr0[_long(t_c)], -1)
        oldk = kept0[_long(t_c)] & okc[:, None]
    else:
        slots_c = up_slot[_long(t_c)]
        okc = (t_c >= 0) & (slots_c >= 0)
        old = torch.where(okc[:, None], nbr_up[_long(slots_c), lvl_idx], -1)
        oldk = kept_up[_long(slots_c), lvl_idx] & okc[:, None]
    new_l, new_k = merge_backlinks_wholesale(
        kind, metric, values, old, oldk, s_c, torch.where(okc, t_c, -1),
        lm, sdim)
    return (torch.where(okc[:, None], new_l, -1), new_k & okc[:, None],
            okc)


def connect_level(kind, metric, values, nbr0, nbr_up, kept0, kept_up,
                  up_slot, elems, eligible, level: int, pool_d, pool_i,
                  m: int, mi: int, smax: int, chunk: int,
                  sdim: int = 0) -> None:
    """One connect pass for one level of an insert wave: intra-wave
    candidates, SelectNeighbors per wave member, own-list writes, then
    backlink merges grouped by target.  The graph tensors ``nbr0``,
    ``nbr_up``, ``kept0`` and ``kept_up`` are updated in place, where the
    reference donates them to its jitted kernel."""
    lm = 2 * m if level == 0 else m
    pool_d, pool_i = _connect_pools(kind, metric, values, elems, eligible,
                                    pool_d, pool_i, mi, sdim)
    sel, sel_d, keptf = _connect_select(kind, metric, values, pool_d, pool_i,
                                        lm, sdim)
    graph = (nbr0, nbr_up, kept0, kept_up, up_slot)
    _write_lists(*graph, elems, eligible, sel, keptf, level)
    # backlinks: group (src → tgt) edges by target, then merge chunks of
    # targets with the wholesale select.  Targets are unique, so no chunk
    # reads another chunk's writes and each chunk writes back at once.
    tgt = sel.reshape(-1)
    src = torch.repeat_interleave(torch.where(eligible, elems, -1), lm)
    targets, new_src, u_count = _group_edges(tgt, src, sel_d.reshape(-1),
                                             smax)
    for s in range(0, u_count, chunk):
        t_c = targets[s:min(s + chunk, u_count)]
        new_l, new_k, okc = _merge_chunk(
            kind, metric, values, *graph, t_c,
            new_src[s:min(s + chunk, u_count)], level, lm, sdim)
        _write_lists(*graph, t_c, okc, new_l, new_k, level)


def connect_level_sharded(mesh, kind, metric, values, nbr0, nbr_up, kept0,
                          kept_up, up_slot, elems, eligible, level: int,
                          pool_d, pool_i, m: int, mi: int, smax: int,
                          chunk: int, sdim: int = 0) -> None:
    """Mesh-parallel :func:`connect_level`: the select rows split into one
    contiguous block a device of ``mesh``, and the backlink chunks (the
    single-device grid 0, chunk, 2·chunk, … up to the unique targets)
    deal out to the devices in contiguous runs; the results gather in
    device order and the same writes apply.  The intra-wave block and the
    edge grouping are computed once in full.  Every select row and every
    chunk is the same computation as in :func:`connect_level` (the
    pairwise products in fixed PAIR_BLOCK shapes), so the graph is
    bit-identical — the counterpart of the reference's N-process
    shared-memory build (hnswbuild.c:925-1062), where workers share the
    search and the UpdateGraphInMemory work."""
    devs = list(mesh.devices.flat)
    home = nbr0.device
    lm = 2 * m if level == 0 else m
    pool_d, pool_i = _connect_pools(kind, metric, values, elems, eligible,
                                    pool_d, pool_i, mi, sdim)
    parts = []
    for dev, (lo, hi) in zip(devs, shard_rows(elems.shape[0], len(devs))):
        if hi > lo:
            parts.append(_connect_select(
                kind, metric, to_device(values, dev),
                to_device(pool_d[lo:hi], dev), to_device(pool_i[lo:hi], dev),
                lm, sdim))
    sel, sel_d, keptf = (all_gather([p[j] for p in parts], home)
                         for j in range(3))
    graph = (nbr0, nbr_up, kept0, kept_up, up_slot)
    _write_lists(*graph, elems, eligible, sel, keptf, level)
    tgt = sel.reshape(-1)
    src = torch.repeat_interleave(torch.where(eligible, elems, -1), lm)
    targets, new_src, u_count = _group_edges(tgt, src, sel_d.reshape(-1),
                                             smax)
    starts = list(range(0, u_count, chunk))
    merged = []
    for dev, (c0, c1) in zip(devs, shard_rows(len(starts), len(devs))):
        if c1 <= c0:
            continue
        g_dev = to_device(graph, dev)
        v_dev = to_device(values, dev)
        for s in starts[c0:c1]:
            e = min(s + chunk, u_count)
            merged.append((s, e) + _merge_chunk(
                kind, metric, v_dev, *g_dev, to_device(targets[s:e], dev),
                to_device(new_src[s:e], dev), level, lm, sdim))
    for s, e, new_l, new_k, okc in merged:
        _write_lists(*graph, targets[s:e], to_device(okc, home),
                     to_device(new_l, home), to_device(new_k, home), level)


# ---------------------------------------------------------------------------
# wave search (Algorithm 1's search phase for a batch of new elements)
# ---------------------------------------------------------------------------


def _wave_level_loop(score, qs, lv, entry: int, entry_level: int, ef: int,
                     l_unroll: int, greedy_fn: Callable, beam_fn: Callable,
                     self_ids=None):
    """Level structure of Algorithm 1 over levels l_unroll..0.  ``lv`` is
    the host copy of the wave's levels; a level where no query runs a
    greedy step or a beam changes nothing and is skipped (the reference
    runs it masked).  With ``self_ids`` (elements already in the graph,
    re-searched by vacuum's repair) each level's output pool drops the
    query's own element (the existing=true search, hnswutils.c:1278)."""
    dev = _dev(qs)
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
        if self_ids is None:
            out_d[lc], out_i[lc] = pool_d, pool_i
        else:
            o_i = torch.where(pool_i == self_ids[:, None], -1, pool_i)
            out_d[lc] = torch.where(o_i >= 0, pool_d, torch.inf)
            out_i[lc] = o_i
    return torch.stack(out_d), torch.stack(out_i)


def wave_search(kind, metric, values, nbr0, nbr_up, up_slot, qs, lv,
                entry: int, entry_level: int, ef: int, l_unroll: int,
                expand: int = 1, self_ids=None, sdim: int = 0,
                vmode: str = "off"):
    """Algorithm 1's search for a wave of elements.  Returns stacked
    per-level pools (l_unroll+1, Q, ef); ``self_ids`` excludes each
    query's own element from them (vacuum's repair).  Each level's beam
    starts a fresh visited table under ``hash1`` / ``hash2``; with the
    visited set ``off`` a dense index's beam hops run in K6.  Every
    query's pools depend on that query alone, so a split of the wave
    gives the same pools (:func:`wave_search_sharded`)."""
    score = make_scorer(kind, metric, values, sdim)
    nbrs = _neighbors_closure(nbr0, nbr_up, up_slot)
    rows = values if kind == "dense" else None

    def greedy_fn(lc, qs_, cur, cur_d):
        return greedy_descent(score, nbrs, qs_, cur, cur_d, lc, max_steps=512)

    def beam_fn(lc, qs_, pool_d, pool_i):
        visited = (visited_init(_nq(qs_), ef, vmode, _dev(qs_))
                   if vmode != "off" else None)
        pd, pi, _ = search_layer(
            score, lambda e: nbrs(e, lc), qs_, pool_d, pool_i, ef=ef,
            max_steps=4 * ef + 64, expand=expand, metric=metric,
            visited=visited, vmode=vmode, rows=rows,
            lists=(nbr0, nbr_up, up_slot, lc))
        return pd, pi

    return _wave_level_loop(score, qs, lv, entry, entry_level, ef, l_unroll,
                            greedy_fn, beam_fn, self_ids)


def wave_search_sharded(mesh, kind, metric, values, nbr0, nbr_up, up_slot,
                        qs, lv, entry: int, entry_level: int, ef: int,
                        l_unroll: int, expand: int = 1, self_ids=None,
                        sdim: int = 0, vmode: str = "off"):
    """:func:`wave_search` for building one graph over a mesh: the wave's
    queries split into one contiguous block a device of ``mesh`` (the
    SPMD mapping of the reference's parallel build, where N processes run
    HnswFindElementNeighbors against one shared-memory graph,
    hnswbuild.c:925-1062), each block searches a replica of the graph and
    values on its device, and the per-level pools gather in device order
    onto the graph's device, replicated (the reference's reason,
    hnsw_kernels.py:1562-1575: the downstream connect reads whole pools).
    Each query's search is independent of the others, so the pools are
    :func:`wave_search`'s, bit for bit."""
    devs = list(mesh.devices.flat)
    home = nbr0.device
    outs = []
    for dev, (lo, hi) in zip(devs, shard_rows(len(lv), len(devs))):
        if hi <= lo:
            continue
        q = (tuple(t[lo:hi] for t in qs) if isinstance(qs, tuple)
             else qs[lo:hi])
        outs.append(wave_search(
            kind, metric, to_device(values, dev), to_device(nbr0, dev),
            to_device(nbr_up, dev), to_device(up_slot, dev),
            to_device(q, dev), lv[lo:hi], entry, entry_level, ef=ef,
            l_unroll=l_unroll, expand=expand,
            self_ids=(to_device(self_ids[lo:hi], dev)
                      if self_ids is not None else None),
            sdim=sdim, vmode=vmode))
    return (all_gather([o[0] for o in outs], home, dim=1),
            all_gather([o[1] for o in outs], home, dim=1))


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


def query_search(kind, metric, values, nbr0, nbr_up, up_slot, elem_rows,
                 row_valid, fmask, qs, entry: int, entry_level: int, ef: int,
                 k: int, heaptids: int, expand: int = 1, packed_vals=None,
                 packed_scale=None, packed_norm2=None, rerank: bool = False,
                 sdim: int = 0, vmode: str = "hash2", max_steps: int = 0,
                 stats: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Algorithm 5 (hnswscan.c:25-56): greedy descent through the upper
    levels, the ef beam at layer 0, then heap-TID expansion.

    ``packed_vals`` — optional adjacency-packed neighbor values
    (nbr_vals[cap, 2m, D], f32, bf16 or int8): layer 0 scores whole
    neighbor slabs, each hop one K2 launch under the visited set ``off``.
    An int8 slab comes with its per-dim ``packed_scale`` (D,) and
    ``packed_norm2`` (each element's dequantized squared norm); the
    queries are quantized against the scale once here
    (:func:`int8_query`), where the reference
    quantizes them again each hop to the same values.  With ``rerank``
    the final pool is re-scored against the exact f32 values, so a bf16
    or int8 cache changes only pool admission, never the emitted order.
    ``vmode`` is the layer-0 visited set, ``hash2`` by default as in the
    reference's signature (a plain scan passes :func:`visited_mode`);
    ``max_steps`` caps the layer-0 hops (0: the 8·ef + 64 of Algorithm
    2's loop bound).
    Returns (stored distances, row ids, layer-0 hops); ``stats``, where
    given, receives the layer-0 hops launched (:func:`search_layer`).
    Only a dense index has packed values (the reference packs dense rows
    only, hnsw.py:1203); without them a dense index's layer-0 hops under the
    visited set ``off`` run in K6."""
    score = make_scorer(kind, metric, values, sdim)
    nbrs = _neighbors_closure(nbr0, nbr_up, up_slot)
    nq = _nq(qs)
    cur = torch.full((nq,), entry, dtype=torch.int32, device=_dev(qs))
    cur_d = score(qs, cur[:, None])[:, 0]
    for lc in range(entry_level, 0, -1):
        cur, cur_d = greedy_descent(score, nbrs, qs, cur, cur_d, lc,
                                    max_steps=512)
    packed = None
    if packed_vals is not None:
        int8 = None
        if packed_vals.dtype == torch.int8:
            qc, sq, q2 = int8_query(qs, packed_scale)
            int8 = (qc, sq, q2, packed_norm2, packed_scale)
        packed = (packed_vals, qs.contiguous(), nbr0, int8)
    visited = (visited_init(nq, ef, vmode, _dev(qs)) if vmode != "off"
               else None)
    pool_d, pool_i, steps = search_layer(
        score, lambda e: nbrs(e, 0), qs, cur_d[:, None], cur[:, None],
        ef=ef, max_steps=max_steps or (8 * ef + 64), expand=expand,
        packed=packed, metric=metric, visited=visited, vmode=vmode,
        rows=values if kind == "dense" else None,
        lists=(nbr0, nbr_up, up_slot, 0), stats=stats)
    if rerank:
        pool_d = score(qs, pool_i)  # exact f32 distances for the final pool
        pool_d, order = torch.sort(pool_d, dim=1, stable=True)
        pool_i = torch.gather(pool_i, 1, order)
    d, r = _expand_topk(pool_d, pool_i, elem_rows, row_valid, fmask, k,
                        heaptids)
    return d, r, steps


# ---------------------------------------------------------------------------
# iterative scans — persistent visited set + discarded pool
# (GetScanItems with the discarded heap, hnswscan.c:25-56; ResumeScanItems,
# hnswscan.c:61-87).  As in the reference, they take the row-gather hop
# with a hash2 visited table, never the packed slab cache.
# ---------------------------------------------------------------------------


def query_search_first(kind, metric, values, nbr0, nbr_up, up_slot, qs,
                       entry: int, entry_level: int, ef: int, dk: int,
                       expand: int = 1, sdim: int = 0):
    """First batch of an iterative scan: Algorithm 5 with a live discarded
    pool of ``dk`` slots.  Returns (pool_d, pool_i, visited, disc_d,
    disc_i, scanned) — the state a resume continues from, and each query's
    scored candidates."""
    score = make_scorer(kind, metric, values, sdim)
    nbrs = _neighbors_closure(nbr0, nbr_up, up_slot)
    nq, dev = _nq(qs), _dev(qs)
    cur = torch.full((nq,), entry, dtype=torch.int32, device=dev)
    cur_d = score(qs, cur[:, None])[:, 0]
    for lc in range(entry_level, 0, -1):
        cur, cur_d = greedy_descent(score, nbrs, qs, cur, cur_d, lc,
                                    max_steps=512)
    visited = visited_init(nq, ef, device=dev)
    disc = (torch.full((nq, dk), torch.inf, device=dev),
            torch.full((nq, dk), -1, dtype=torch.int32, device=dev))
    pool_d, pool_i, visited, (disc_d, disc_i), _, scanned = search_layer(
        score, lambda e: nbrs(e, 0), qs, cur_d[:, None], cur[:, None], ef=ef,
        max_steps=8 * ef + 64, expand=expand, visited=visited, disc=disc,
        vmode="hash2")
    return pool_d, pool_i, visited, disc_d, disc_i, scanned


def query_search_resume(kind, metric, values, nbr0, nbr_up, up_slot, qs,
                        visited, disc_d, disc_i, ef: int, expand: int = 1,
                        sdim: int = 0):
    """ResumeScanItems (hnswscan.c:61-87): re-seed a layer-0 search from the
    best ef discarded candidates without resetting the visited set
    (initVisited=false), keeping the rest of the discarded pool live."""
    score = make_scorer(kind, metric, values, sdim)
    nbrs = _neighbors_closure(nbr0, nbr_up, up_slot)
    nq, dk = disc_d.shape
    keep = min(ef, dk)
    seed_d, seed_i = disc_d[:, :ef], disc_i[:, :ef]
    rest_d = torch.cat([disc_d[:, keep:], disc_d.new_full((nq, keep),
                                                          torch.inf)], dim=1)
    rest_i = torch.cat([disc_i[:, keep:], disc_i.new_full((nq, keep), -1)],
                       dim=1)
    pool_d, pool_i, visited, (disc_d, disc_i), _, scanned = search_layer(
        score, lambda e: nbrs(e, 0), qs, seed_d, seed_i, ef=ef,
        max_steps=8 * ef + 64, expand=expand, visited=visited,
        disc=(rest_d, rest_i), vmode="hash2")
    return pool_d, pool_i, visited, disc_d, disc_i, scanned


def merge_scan_batches(all_d, all_r, k: int):
    """Merge an iterative scan's batches, (Q, batches·w) distances and row
    ids, into each query's k best.  One row emitted twice carries the same
    distance both times (suppressed entries arrive as row -1), so keeping
    the first copy is keeping any: a stable sort by row, repeats masked to
    +inf, a stable sort by distance, the first k.  Equal distances come
    out in ascending row order."""
    d = torch.where(all_r < 0, torch.inf, all_d)
    sr, o = torch.sort(all_r, dim=1, stable=True)
    sd = torch.gather(d, 1, o)
    dup = torch.zeros_like(sr, dtype=torch.bool)
    dup[:, 1:] = sr[:, 1:] == sr[:, :-1]
    sd = torch.where(dup, torch.inf, sd)
    sd, o = torch.sort(sd, dim=1, stable=True)
    out_d = sd[:, :k]
    out_r = torch.gather(sr, 1, o[:, :k])
    return out_d, torch.where(torch.isinf(out_d), -1, out_r)
