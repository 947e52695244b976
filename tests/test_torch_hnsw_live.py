"""HNSW as a live index through both packages, on the CPU: heap-TID
dedup, insert, incremental backlinks and the visited set (the vacuum and
slot reuse are in tests/test_torch_hnsw_vacuum.py).

Each case runs the same seeded inputs through the reference and the port.
Tolerance: distances within atol 1e-6 / rtol 1e-5, ids equal apart from
ties at equal distance (as tests/test_torch_hnsw.py); bookkeeping —
element rows, levels, slots, free slots, dedup keys — equal exactly;
where a build takes part, at least 95 % of the level-0 lists equal as
sets (the rest differ where the two stacks break distance ties apart)
and recall@10 at least 0.9 in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu_torch import FlatIndex, HNSWIndex, Metric  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.index.hnsw import HEAPTIDS  # noqa: E402
from torch_hnsw_pairs import (  # noqa: E402
    assert_same_books, insert_both, port_of, recall, same_lists, tables)
from torch_parity import assert_same_topk  # noqa: E402

K = 10
#: least share of equal level-0 lists where a build takes part
LISTS_SAME = 0.95


@pytest.fixture(scope="module")
def data():
    """tests/test_hnsw.py's data: 1,000 × 12 and 20 queries."""
    rng = np.random.default_rng(7)
    db = rng.normal(size=(1000, 12)).astype(np.float32)
    q = rng.normal(size=(20, 12)).astype(np.float32)
    return db, q


# ------------------------------------------------------------ dedup (a)
def test_dedup_bookkeeping_matches_reference():
    """test_duplicates_share_elements' data, then duplicates of existing
    elements (attached as TIDs), one element overflowing past HEAPTIDS,
    and a batch of 25 copies of a new vector (elements of 10, 10 and 5)."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(50, 8)).astype(np.float32)
    db = np.concatenate([base, base[:5], base[:5]])  # 10 duplicate rows
    jt, tt = tables(db)
    kw = dict(m=8, ef_construction=32, wave_size=64)
    ref, port = JHNSW(jt, JMetric.L2, **kw), HNSWIndex(tt, Metric.L2, **kw)
    assert port.dedup and port.live_elements == 50
    assert_same_books(ref, port)
    d0, r0 = ref.search(base[0][None, :], 3, ef_search=40)
    d1, r1 = port.search(base[0][None, :], 3, ef_search=40)
    assert set(r1[0].tolist()) == set(r0[0].tolist()) == {0, 50, 55}
    np.testing.assert_allclose(d1, d0, atol=1e-6, rtol=1e-5)

    new = np.concatenate([base[5:8], rng.normal(size=(2, 8)).astype(np.float32),
                          np.repeat(base[9:10], 12, axis=0),
                          np.repeat(rng.normal(size=(1, 8)).astype(np.float32),
                                    25, axis=0)])
    rows = insert_both(jt, tt, new)
    ref.insert(rows)
    port.insert(rows)
    assert_same_books(ref, port)
    e9 = port.row_to_elem[9]
    assert (port.elem_rows[e9] >= 0).sum() == HEAPTIDS  # filled to 10
    over = port.row_to_elem[int(rows[-26])]  # the last copy of base[9]
    assert over != e9 and (port.elem_rows[over] >= 0).sum() == 3
    counts = sorted((port.elem_rows[port.row_to_elem[int(r)]] >= 0).sum()
                    for r in rows[-25:])
    assert set(counts) == {5, 10}
    q = np.concatenate([base[:10], new[-1:]]) + 0.001
    d0, r0 = ref.search(q, K, ef_search=40)
    d1, r1 = port.search(q, K, ef_search=40)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ insert (b)
def test_insert_matches_reference(data):
    """test_insert_recall: 700 rows, then 300 more, in both packages."""
    db, q = data
    jt, tt = tables(db[:700])
    kw = dict(m=8, ef_construction=32, wave_size=128)
    ref, port = JHNSW(jt, JMetric.L2, **kw), HNSWIndex(tt, Metric.L2, **kw)
    rows = insert_both(jt, tt, db[700:])
    ref.insert(rows)
    port.insert(rows)
    assert_same_books(ref, port)
    n = ref.n_elems
    same = same_lists(port.nbr0[:n].numpy(), np.asarray(ref.nbr0[:n]))
    assert same >= LISTS_SAME, same
    _, gt = FlatIndex(tt, Metric.L2).search(q, K)
    _, r0 = ref.search(q, K, ef_search=80)
    _, r1 = port.search(q, K, ef_search=80)
    assert recall(r0, gt) >= 0.9 and recall(r1, gt) >= 0.9


def test_insert_into_loaded_reference_graph(data):
    """A reference graph loaded with its rng state: inserts draw the same
    levels and fill the same slots; the inserted elements' lists are
    the reference's."""
    db, q = data
    jt, tt = tables(db[:700])
    ref = JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=128)
    port = port_of(ref, tt)
    rows = insert_both(jt, tt, db[700:])
    ref.insert(rows)
    port.insert(rows)
    assert_same_books(ref, port)
    n = ref.n_elems
    same = same_lists(port.nbr0[:n].numpy(), np.asarray(ref.nbr0[:n]))
    assert same >= LISTS_SAME, same
    d0, r0 = ref.search(q, K, ef_search=80)
    d1, r1 = port.search(q, K, ef_search=80)
    _, gt = FlatIndex(tt, Metric.L2).search(q, K)
    assert recall(r1, gt) >= 0.9 and recall(r0, gt) >= 0.9


# ------------------------------------------------------ incremental (c)
def test_merge_backlinks_matches_reference():
    """The incremental fold over seeded lists: some full, some with room,
    sources already listed, padded targets, sticky incumbents."""
    rng = np.random.default_rng(21)
    n, d, t, lm, smax = 300, 8, 24, 8, 8
    vals = rng.normal(size=(n, d)).astype(np.float32)
    targets = rng.choice(n, size=t, replace=False).astype(np.int32)
    old = np.stack([rng.choice(np.setdiff1d(np.arange(n), [b]), size=lm,
                               replace=False) for b in targets]).astype(np.int32)
    old[::3, 5:] = -1                   # lists with room
    kept = (rng.random(old.shape) > 0.5) & (old >= 0)
    src = np.stack([rng.choice(np.setdiff1d(np.arange(n), [b]), size=smax,
                               replace=False) for b in targets]).astype(np.int32)
    src[:, 6:] = -1
    src[1, 0] = old[1, 2]               # already a neighbor
    targets[-2:] = -1                   # block padding
    m0 = JK.merge_backlinks("dense", JMetric.L2, (jnp.asarray(vals),),
                            jnp.asarray(old), jnp.asarray(kept),
                            jnp.asarray(src), jnp.asarray(targets), lm)
    m1 = TK.merge_backlinks("dense", Metric.L2, torch.from_numpy(vals),
                            torch.from_numpy(old), torch.from_numpy(kept),
                            torch.from_numpy(src), torch.from_numpy(targets),
                            lm)
    np.testing.assert_array_equal(m1[0].numpy(), np.asarray(m0[0]))
    np.testing.assert_array_equal(m1[1].numpy(), np.asarray(m0[1]))


def test_incremental_build_matches_reference(data):
    db, q = data
    jt, tt = tables(db[:600])
    kw = dict(m=8, ef_construction=32, wave_size=128,
              backlink_mode="incremental", dedup=False)
    ref, port = JHNSW(jt, JMetric.L2, **kw), HNSWIndex(tt, Metric.L2, **kw)
    n = ref.n_elems
    np.testing.assert_array_equal(port.levels[:n], ref.levels[:n])
    same = same_lists(port.nbr0[:n].numpy(), np.asarray(ref.nbr0[:n]))
    assert same >= LISTS_SAME, same
    _, gt = FlatIndex(tt, Metric.L2).search(q, K)
    _, r0 = ref.search(q, K, ef_search=80)
    _, r1 = port.search(q, K, ef_search=80)
    assert recall(r1, gt) >= 0.9 and recall(r1, gt) >= recall(r0, gt) - 0.02


# ----------------------------------------------------- visited set (d)
def _colliding_ids(cap, count, seed):
    """(count,) ids in groups sharing a first slot, so inserts race."""
    ids = np.arange(1, 60_000, dtype=np.uint64)
    shift = np.uint64(32 - (cap.bit_length() - 1))
    s1 = ((ids * np.uint64(0x9E3779B1)) & np.uint64(0xFFFFFFFF)) >> shift
    order = np.argsort(s1, kind="stable")
    s_sorted = s1[order]
    dup = np.flatnonzero(s_sorted[1:] == s_sorted[:-1])
    rng = np.random.default_rng(seed)
    pick = rng.choice(dup, size=count // 2, replace=False)
    out = np.concatenate([ids[order][pick], ids[order][pick + 1]])
    return rng.permutation(out).astype(np.int32)


@pytest.mark.parametrize("mode", ["hash1", "hash2"])
def test_visited_probe_matches_reference(mode):
    """Tables and ``seen`` equal after a run of probes: racing inserts
    into one slot, ids seen again, negative (masked) ids."""
    rng = np.random.default_rng(3)
    nq, ef = 4, 8
    j_tab = JK.visited_init(nq, ef, mode)
    t_tab = TK.visited_init(nq, ef, mode)
    cap = int(j_tab.shape[1])
    assert t_tab.shape == j_tab.shape
    pool = _colliding_ids(cap, 400, seed=4)
    for step in range(6):
        blk = rng.choice(pool, size=(nq, 48)).astype(np.int32)
        blk[rng.random(blk.shape) < 0.1] = -1
        j_tab, j_seen = JK.visited_probe(j_tab, jnp.asarray(blk), mode)
        t_tab, t_seen = TK.visited_probe(t_tab, torch.from_numpy(blk), mode)
        np.testing.assert_array_equal(t_seen.numpy(), np.asarray(j_seen))
        np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    assert np.asarray(j_seen).any()


def test_visited_hash2_insert_never_evicts():
    """The reference's collision triple: c fills slot1(b); a and b in one
    block, slot2(b) == slot1(a).  Pass 2 must see that pass 1 has just
    put a there, so a stays recorded."""
    table = TK.visited_init(1, 8)
    cap = table.shape[1]
    ids = np.arange(1, 200_000, dtype=np.uint64)
    shift = np.uint64(32 - (cap.bit_length() - 1))
    mask = np.uint64(0xFFFFFFFF)
    s1 = ((ids * np.uint64(0x9E3779B1)) & mask) >> shift
    s2 = ((ids * np.uint64(0x85EBCA77)) & mask) >> shift
    by_s1 = {}
    for i, x in zip(ids.tolist(), s1.tolist()):
        by_s1.setdefault(x, []).append(i)
    triple = None
    for grp in by_s1.values():
        if len(grp) < 2:
            continue
        c, b = grp[0], grp[1]
        for a in by_s1.get(int(s2[b - 1]), []):
            if a < b and a not in (b, c) and s1[a - 1] != s1[b - 1]:
                triple = (c, b, a)
                break
        if triple:
            break
    assert triple, "no collision triple in range"
    c, b, a = triple
    table, seen = TK.visited_probe(table, torch.tensor([[c]], dtype=torch.int32))
    assert not bool(seen[0, 0])
    table, seen = TK.visited_probe(table, torch.tensor([[a, b]], dtype=torch.int32))
    assert not seen.any()
    _, seen = TK.visited_probe(table, torch.tensor([[a, c]], dtype=torch.int32))
    assert bool(seen[0, 0]), "a was evicted by b's stale-occupancy insert"
    assert bool(seen[0, 1])
