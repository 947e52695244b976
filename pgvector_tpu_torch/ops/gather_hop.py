"""K6 — one whole hop of the HNSW beam search over rows gathered by id;
replaces the row-gather branch of
``pgvector_tpu.index.hnsw_kernels._hop_step`` (``_hop_body`` with the
visited set ``off`` and no discarded pool: the E-selection, the neighbor
lists, the Knuth-keyed dedupe, the pool membership mask, the row scores
and ``_hop_merge``) for dense values.

One call takes the sorted ef pool, packed as (Q, ef) f32 distances and
(Q, ef) int32 ``id·2 | expanded``, the level's list tables and the
previous hop's ``done`` flags and hop counts, and returns the next packed
pool, each query's ``done`` flag, the count of queries not done and each
query's hops (one more, up to and including the hop that found it done;
a query done on entry is copied through and counts none):

1. the E-selection (:func:`select_expand`): among the pool's unexpanded
   lanes with an id, the first E in the order of ``torch.argmin`` (E = 1:
   the first minimum, a NaN first) or of a stable ascending sort (E > 1:
   NaN last), the masked lanes at +inf; ``done`` when the first is
   infinite or worse than the pool's worst ``pool_d[ef-1]``; a selected
   lane is expanded (and marked so) when finite, not past the worst and
   its query not done;
2. the neighbor lists of the expanded elements, read from the tables:
   ``nbr0`` (cap, 2m) at level 0; above it the m-wide ``nbr_up[slot,
   level-1]`` of the element's ``up_slot`` (-1: no list); an element with
   no list and a candidate id at or past N give -1;
3. with E > 1 the W candidates in the order of the Knuth key
   ``id·2654435761 mod 2^32``, a repeated id masked (:func:`dedupe_hop`);
   with E = 1 in adjacency order;
4. the candidates already in the pool masked, the others' rows of the
   (N, D) value table scored against the query in f32
   (:func:`.distance.dense_point_scores`), and the pool and candidates
   merged by a stable sort on distance (NaN last), the first ef kept.

:func:`gather_hop` launches ``csrc/gather_hop.cu`` for CUDA tensors and
takes :func:`gather_hop_plain` only for CPU tensors.  The kernel sums each
distance in another order than ``torch.sum``, so the two agree on
distances within f32 tolerance and on ids apart from ties; the selection,
the lists, the masks and, given the same distances, the merge are the
plain version's exactly.
"""

from __future__ import annotations

import torch

from . import _cuda
from .distance import dense_point_scores
from .hop_tail import MAX_WIDTH
from .metric import Metric

#: Knuth's multiplicative hash and its inverse mod 2^32: a bijection on
#: ids, so equal keys ⇔ equal ids, and the permuted order is unbiased
_PERM = 2654435761
_PERM_INV = 244002641
_MASK32 = 0xFFFFFFFF

#: the kernels' metric codes (K2's and K6's); cosine values are stored
#: normalized and ordered by -ip
_METRIC_CODE = {Metric.L2: 0, Metric.IP: 1, Metric.COSINE: 1, Metric.L1: 2}

#: the kernel's dtype codes, of the value table and of the queries
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the lanes a hop sorts: the next power of two >= ef + W, at least 64
#: (as csrc/hop_merge.cuh's merge_width)
_MIN_WIDTH = 64

def dedupe_hop(nbrs: torch.Tensor) -> torch.Tensor:
    """Dedupe one hop's (Q, W) candidate ids (two expanded nodes sharing a
    neighbor): sort by the Knuth permutation of the id and mask adjacent
    equals (-1 at the repeats and at the end, where the -1 keys sort)."""
    inval = _MASK32  # no id < 2^30 maps here
    key = torch.where(nbrs >= 0, (nbrs.long() * _PERM) & _MASK32, inval)
    key, _ = torch.sort(key, dim=1)
    dup = torch.zeros_like(key, dtype=torch.bool)
    dup[:, 1:] = (key[:, 1:] == key[:, :-1]) & (key[:, 1:] != inval)
    ids = ((key * _PERM_INV) & _MASK32).to(torch.int32)
    return torch.where(dup | (key == inval), -1, ids)


def select_expand(pool_d: torch.Tensor, pool_p: torch.Tensor, ef: int,
                  expand: int):
    """The E-selection of a hop (``_hop_body``'s, hnsw_kernels.py:433-456):
    → (the next packed pool with the expanded lanes marked, (Q, E) the
    expanded element ids or -1, (Q,) done)."""
    pool_i = pool_p >> 1
    cand_d = torch.where(((pool_p & 1) == 0) & (pool_i >= 0), pool_d,
                         torch.inf)
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
    pool_p = pool_p.scatter(1, sel, torch.gather(pool_p, 1, sel)
                            | ok.to(torch.int32))
    return pool_p, torch.where(ok, torch.gather(pool_i, 1, sel), -1), done


def hop_lists(sel: torch.Tensor, nbr0, nbr_up: torch.Tensor,
              up_slot: torch.Tensor, level: int, n_rows: int) -> torch.Tensor:
    """(Q, E) expanded element ids → (Q, E·w) candidate ids, w = 2m at
    level 0 and m above it: each element's list, -1 where the element is
    -1, has no list at this level or lies past the tables (``up_slot``
    has an entry an element, as ``nbr0`` a row; ``nbr0`` is read at level
    0 only), and where a listed id lies at or past ``n_rows``."""
    q, e = sel.shape
    flat = sel.reshape(-1)
    live = (flat >= 0) & (flat < up_slot.shape[0])
    safe = torch.where(live, flat, 0).long()
    if level == 0:
        out = nbr0[safe]
    else:
        slot = up_slot[safe]
        live &= (slot >= 0) & (slot < nbr_up.shape[0])
        out = nbr_up[torch.where(live, slot, 0).long(), level - 1]
    out = torch.where(live[:, None] & (out >= 0) & (out < n_rows), out, -1)
    return out.reshape(q, -1)


def hop_state(pool_d, pool_p, new_d, new_p, found, done, hops):
    """The end of a hop, K2's and K6's plain versions alike: a query
    done on entry (``done``, None: none) keeps its pool and its hop count;
    every other one takes its new pool, its ``found`` flag and one more
    hop.  Returns (pool_d, pool_p, done, left, hops)."""
    q = pool_d.shape[0]
    if done is None:
        done = torch.zeros(q, dtype=torch.bool, device=pool_d.device)
    if hops is None:
        hops = torch.zeros(q, dtype=torch.int32, device=pool_d.device)
    new_d = torch.where(done[:, None], pool_d, new_d)
    new_p = torch.where(done[:, None], pool_p, new_p)
    hops = hops + (~done).to(torch.int32)
    done = done | found
    left = torch.sum(~done, dtype=torch.int32).reshape(1)
    return new_d, new_p, done, left, hops


def gather_hop_plain(pool_d: torch.Tensor, pool_p: torch.Tensor,
                     nbr0: torch.Tensor, nbr_up: torch.Tensor,
                     up_slot: torch.Tensor, level: int, rows: torch.Tensor,
                     qs: torch.Tensor, ef: int, expand: int, metric: Metric,
                     *, done=None, hops=None, out=None):
    """Plain PyTorch K6, the whole hop: :func:`select_expand`,
    :func:`hop_lists`, :func:`dedupe_hop` with E > 1, the pool membership
    mask, :func:`.distance.dense_point_scores`, the stable merge and
    :func:`hop_state`.  Returns (pool_d, pool_p, done, left, hops),
    ``left`` the (1,) int32 count of queries not done; ``out`` (the
    kernel's output buffers) is not used."""
    p_in = pool_p
    expand = min(expand, pool_d.shape[1])
    pool_p, sel, found = select_expand(pool_d, pool_p, ef, expand)
    nbrs = hop_lists(sel, nbr0, nbr_up, up_slot, level, rows.shape[0])
    if expand > 1:
        nbrs = dedupe_hop(nbrs)
    # pool-membership check keeps the ef pool duplicate-free
    in_pool = torch.any(nbrs[:, :, None] == (pool_p >> 1)[:, None, :], dim=2)
    nbrs = torch.where(in_pool, -1, nbrs)
    nd = dense_point_scores(metric, qs, rows[torch.clamp(nbrs, min=0).long()],
                            nbrs)
    # (id·2 | expanded) rides a stable sort by distance (-1 packs to -2)
    d, order = torch.sort(torch.cat([pool_d, nd], dim=1), dim=1, stable=True)
    packed = torch.gather(torch.cat([pool_p, nbrs * 2], dim=1), 1,
                          order[:, :ef])
    return hop_state(pool_d, p_in, d[:, :ef], packed, found, done, hops)


def hop_width(ef: int, expand: int, nbr0: torch.Tensor,
              nbr_up: torch.Tensor, level: int) -> int:
    """The lanes the kernel sorts for a hop: the next power of two >=
    ef + W (W = E·2m at level 0, E·m above it), at least 64."""
    w = min(expand, ef) * (nbr0.shape[1] if level == 0 else nbr_up.shape[2])
    width = _MIN_WIDTH
    while width < ef + w:
        width *= 2
    return width


#: the wrapper's inputs: name, dtype (None: f32, bf16 or f16) and rank
_INPUTS = (("pool_d", torch.float32, 2), ("pool_p", torch.int32, 2),
           ("nbr0", torch.int32, 2), ("nbr_up", torch.int32, 3),
           ("up_slot", torch.int32, 1), ("rows", None, 2), ("qs", None, 2))


def hop_buffers(q: int, ef: int, device, work=None):
    """The output buffers of one :func:`gather_hop` or
    :func:`.packed_hop.packed_hop` (``out``): a (Q, ef) pool, (Q,) done
    flags, the (1,) count, (Q,) hop counts and the scratch (``work``, or a
    new zero one)."""
    return (torch.empty((q, ef), dtype=torch.float32, device=device),
            torch.empty((q, ef), dtype=torch.int32, device=device),
            torch.empty((q,), dtype=torch.bool, device=device),
            torch.empty((1,), dtype=torch.int32, device=device),
            torch.empty((q,), dtype=torch.int32, device=device),
            torch.zeros(2, dtype=torch.int32, device=device)
            if work is None else work)


def check_state(done, hops, q: int, dev) -> None:
    """The previous hop's (Q,) bool done flags and (Q,) int32 hop counts
    (either None) as the kernels take them."""
    for name, t, dtype in (("done", done, torch.bool),
                           ("hops", hops, torch.int32)):
        if t is not None and (t.device != dev or t.dtype != dtype
                              or tuple(t.shape) != (q,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({q},) {dtype} "
                             f"tensor on {dev}")


def check_out(out, pool_d, pool_p, q: int, name: str) -> None:
    """``out`` is :func:`hop_buffers`' six tensors, apart from the
    pool."""
    if (len(out) != 6 or out[1].shape != pool_p.shape
            or out[2].shape != (q,) or out[4].shape != (q,)
            or out[0].data_ptr() == pool_d.data_ptr()
            or out[1].data_ptr() == pool_p.data_ptr()):
        raise ValueError(f"{name}'s out: (Q, ef) f32, (Q, ef) int32, (Q,) "
                         "bool, (1,) int32, (Q,) int32 and (2,) int32, "
                         "apart from the pool")


def gather_hop(pool_d: torch.Tensor, pool_p: torch.Tensor,
               nbr0: torch.Tensor, nbr_up: torch.Tensor,
               up_slot: torch.Tensor, level: int, rows: torch.Tensor,
               qs: torch.Tensor, ef: int, expand: int, metric: Metric,
               *, done=None, hops=None, out=None):
    """K6 wrapper: the pool (Q, ef) f32 distances and int32 packed ids
    (``id·2 | expanded``), the level-0 lists ``nbr0`` (cap, 2m), the
    upper lists ``nbr_up`` (slots, L, m) and ``up_slot`` (cap,) int32, the
    ``level``, the (N, D) f32, bf16 or f16 value table ``rows``, the (Q,
    D) f32, bf16 or f16 queries ``qs``, E = ``expand``, and the previous
    hop's ``done`` (Q,) bool and ``hops`` (Q,) int32 (None: none done, no
    hops).  Returns (pool_d, pool_p, done (Q,) bool, left (1,) int32,
    hops (Q,) int32), written into ``out`` where it is given
    (:func:`hop_buffers`: those five tensors, none of them the input pool,
    and the kernel's (2,) int32 scratch, zero before its first launch: the
    kernel's cross-block count and ticket; each launch leaves it at zero,
    and launches that share it run one after another).  CUDA tensors
    launch the kernel; CPU tensors take :func:`gather_hop_plain`.
    ``launches`` counts every launch."""
    if not pool_d.is_cuda:
        return gather_hop_plain(pool_d, pool_p, nbr0, nbr_up, up_slot, level,
                                rows, qs, ef, expand, metric, done=done,
                                hops=hops)
    dev = pool_d.device
    inputs = (pool_d, pool_p, nbr0, nbr_up, up_slot, rows, qs)
    for t, (name, dtype, ndim) in zip(inputs, _INPUTS):
        if (t.device != dev or t.dim() != ndim or not t.is_contiguous()
                or (t.dtype not in _DTYPES if dtype is None
                    else t.dtype != dtype)):
            _cuda.check_tensor(t, name, dtype or t.dtype, ndim)
            raise ValueError(f"gather_hop's {name} must be on {dev}, and "
                             f"rows and qs f32, bf16 or f16, got "
                             f"{t.device}, {t.dtype}")
    q, d = pool_d.shape[0], rows.shape[1]
    if (tuple(pool_p.shape) != (q, ef) or pool_d.shape[1] != ef
            or tuple(qs.shape) != (q, d) or rows.shape[0] == 0
            or up_slot.shape[0] != nbr0.shape[0] or expand < 1
            or not 0 <= level <= nbr_up.shape[1]):
        raise ValueError(
            f"gather_hop shapes: pool {tuple(pool_d.shape)}/"
            f"{tuple(pool_p.shape)}, nbr0 {tuple(nbr0.shape)}, nbr_up "
            f"{tuple(nbr_up.shape)}, up_slot {tuple(up_slot.shape)}, rows "
            f"{tuple(rows.shape)}, qs {tuple(qs.shape)}, ef={ef}, "
            f"expand={expand}, level={level}")
    check_state(done, hops, q, dev)
    if out is None:
        out = hop_buffers(q, ef, dev)
    check_out(out, pool_d, pool_p, q, "gather_hop")
    out_d, out_p, out_done, left, out_hops, work = out
    if q == 0:
        return out_d, out_p, out_done, left.zero_(), out_hops
    expand = min(expand, ef)
    width = hop_width(ef, expand, nbr0, nbr_up, level)
    if width > MAX_WIDTH:
        raise ValueError(f"gather_hop sorts at most {MAX_WIDTH} lanes per "
                         f"row; ef + W needs {width}")
    lib = _cuda.lib()

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        return lib.pgvt_gather_hop(
            pool_d.data_ptr(), pool_p.data_ptr(), nbr0.data_ptr(),
            nbr0.shape[0], nbr0.shape[1], nbr_up.data_ptr(), up_slot.data_ptr(),
            nbr_up.shape[0], nbr_up.shape[1], nbr_up.shape[2], level,
            rows.data_ptr(), rows.shape[0], qs.data_ptr(), q, ef, expand, d,
            _DTYPES[rows.dtype], _DTYPES[qs.dtype], _METRIC_CODE[metric],
            out_d.data_ptr(), out_p.data_ptr(), out_done.data_ptr(),
            _ptr(done), _ptr(hops), out_hops.data_ptr(), work.data_ptr(),
            left.data_ptr(), stream)

    if dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    _cuda.check(err, "pgvt_gather_hop")
    gather_hop.launches += 1
    return out_d, out_p, out_done, left, out_hops


def _ptr(t) -> int:
    """A tensor's device address, or 0 (null) for None."""
    return 0 if t is None else t.data_ptr()


gather_hop.launches = 0
