"""HNSW through both packages, on the CPU.

- Search parity: the reference builds a graph (tests/test_pallas_hop.py's
  3,000 × 16 set, m=8, efc=32, wave 256, beam_expand=4, dedup=False);
  ``hnsw_from_numpy`` carries exactly the arrays and manifest fields that
  ``io.checkpoint.save_hnsw`` writes into the port, and both search it.
  Packed f32, bf16 and int8 scans (the reference with its Pallas tail in
  interpret mode, the port with K2's plain version) and the row-gather
  scan must return the same ids apart from ties at equal distance, with
  distances within rtol 1e-5, after the same number of layer-0 hops.
- Build: the port builds its own graph from the same data and seed.  It
  draws the same levels, at least 95 % of its level-0 lists equal the
  reference's, and its recall@10 is at least the reference's less 0.02,
  and at least the L2 floor of tests/test_recall_floors.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import DenseTable, HNSWIndex, Metric  # noqa: E402
from pgvector_tpu_torch.io.convert import (  # noqa: E402
    hnsw_from_numpy, table_from_numpy)
from torch_hnsw_pairs import reference_state  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

K, EF = 10, 48
#: ef_search of the build check, with room above the floor
EF_BUILD = 100
#: tests/test_recall_floors.py's L2 floor
RECALL_FLOOR = 0.97
#: least share of a port-built graph's level-0 lists equal to the
#: reference's on the same data and seed
LEVEL0_SAME = 0.95


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(55)
    db = rng.normal(size=(3000, 16)).astype(np.float32)
    db[100:110] = db[0:10]  # duplicates, as in test_pallas_hop
    q = np.concatenate([db[:20] + 0.01,
                        rng.normal(size=(20, 16)).astype(np.float32)])
    jt = JTable(16)
    jt.insert(db)
    ref = JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=256,
                beam_expand=4, dedup=False)
    tt = table_from_numpy(db, np.ones(len(db), bool), device="cpu")
    arrays, meta = reference_state(ref)
    port = hnsw_from_numpy(tt, arrays, meta)
    exact = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    gt = np.argsort(exact, axis=1, kind="stable")[:, :K]
    return dict(db=db, q=q, ref=ref, port=port, table=tt, gt=gt)


def _recall(r, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                    for a, b in zip(r, gt)])


@pytest.mark.parametrize("packed", ["f32", "bf16", "int8", "off"])
def test_search_on_reference_graph_matches(graphs, packed, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", packed)
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")
    monkeypatch.setenv("PGVECTOR_TPU_PALLAS_TAIL", "1")
    d0, r0 = graphs["ref"].search(graphs["q"], K, ef_search=EF)
    port = graphs["port"]
    assert port._packed_plan() == {"f32": torch.float32,
                                   "bf16": torch.bfloat16,
                                   "int8": torch.int8,
                                   "off": None}[packed]
    d1, r1 = port.search(graphs["q"], K, ef_search=EF)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6, rtol=1e-5)
    assert port._last_scan_steps == graphs["ref"]._last_scan_steps


def test_port_build_levels_and_recall(graphs, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "off")
    ref = graphs["ref"]
    built = HNSWIndex(graphs["table"], Metric.L2, m=8, ef_construction=32,
                      wave_size=256, beam_expand=4, dedup=False)
    n = ref.n_elems
    assert built.n_elems == n
    np.testing.assert_array_equal(built.levels[:n], ref.levels[:n])
    assert built.entry_level == ref.entry_level
    # every element's level-0 list is filled from real, distinct elements
    nbr0 = np.sort(built.nbr0[:n].numpy(), axis=1)
    assert ((nbr0 >= -1) & (nbr0 < n)).all()
    assert (nbr0[:, -1] >= 0).all()
    assert not ((nbr0[:, 1:] == nbr0[:, :-1]) & (nbr0[:, 1:] >= 0)).any()
    # most level-0 lists equal the reference's as sets (0.982 at this seed);
    # the rest differ where the two stacks break distance ties apart
    same = (nbr0 == np.sort(np.asarray(ref.nbr0[:n]), axis=1)).all(axis=1)
    assert same.mean() >= LEVEL0_SAME, same.mean()
    _, r_ref = ref.search(graphs["q"], K, ef_search=EF_BUILD)
    _, r_new = built.search(graphs["q"], K, ef_search=EF_BUILD)
    rec_ref = _recall(r_ref, graphs["gt"])
    rec_new = _recall(r_new, graphs["gt"])
    assert rec_new >= rec_ref - 0.02, (rec_new, rec_ref)
    assert rec_new >= RECALL_FLOOR, rec_new


# -- the build's pieces, one by one, on seeded pools ------------------------


def _pools(metric, seed, n=400, d=8, t=32, c=40):
    """A value table, base elements, and per-base candidate pools (ids with
    -1 padding, stored distances to the base).  A pool never holds its own
    base, as in a build: the base would tie with itself in every check."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, d)).astype(np.float32)
    base = rng.choice(n, size=t, replace=False).astype(np.int32)
    pool_i = np.stack([rng.choice(np.setdiff1d(np.arange(n), [b]), size=c,
                                  replace=False)
                       for b in base]).astype(np.int32)
    pool_i[:, -6:] = -1
    pool_i[5, 4:] = -1  # a nearly empty pool
    v = vals[np.maximum(pool_i, 0)]
    b = vals[base][:, None, :]
    pool_d = {"L2": ((b - v) ** 2).sum(-1), "IP": -(b * v).sum(-1),
              "L1": np.abs(b - v).sum(-1)}[metric].astype(np.float32)
    pool_d = np.where(pool_i >= 0, pool_d, np.inf).astype(np.float32)
    return vals, base, pool_d, pool_i


@pytest.mark.parametrize("metric", ["L2", "IP", "L1"])
def test_select_connections_matches_reference(metric):
    """SelectNeighbors (Algorithm 4) over seeded pools: the same neighbor
    ids and heuristic-kept flags."""
    import jax.numpy as jnp

    from pgvector_tpu.index import hnsw_kernels as JK
    from pgvector_tpu_torch.index import hnsw_kernels as TK

    vals, base, pool_d, pool_i = _pools(metric, seed=11)
    s0, k0 = JK.select_connections(
        "dense", JMetric[metric], (jnp.asarray(vals),), jnp.asarray(base),
        jnp.asarray(pool_d), jnp.asarray(pool_i), 16)
    s1, k1 = TK.select_connections(
        "dense", Metric[metric], torch.from_numpy(vals), torch.from_numpy(pool_d),
        torch.from_numpy(pool_i), 16)
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(k1.numpy(), np.asarray(k0))


def test_backlink_merge_and_grouping_match_reference():
    """Edge grouping by target, the wholesale backlink select with sticky
    kept flags, and the intra-wave candidates."""
    import jax.numpy as jnp

    from pgvector_tpu.index import hnsw_kernels as JK
    from pgvector_tpu_torch.index import hnsw_kernels as TK

    vals, base, pool_d, pool_i = _pools("L2", seed=12)
    rng = np.random.default_rng(13)
    jv, tv = (jnp.asarray(vals),), torch.from_numpy(vals)
    # grouping: edges (src → tgt) with distinct distances
    tgt = pool_i[:, :12].reshape(-1)
    src = np.repeat(base, 12).astype(np.int32)
    d_e = rng.permutation(len(tgt)).astype(np.float32)
    g0 = JK._group_edges(jnp.asarray(tgt), jnp.asarray(src),
                         jnp.asarray(d_e), 8)
    g1 = TK._group_edges(torch.from_numpy(tgt), torch.from_numpy(src),
                         torch.from_numpy(d_e), 8)
    u = int(g0[2])
    assert g1[2] == u
    np.testing.assert_array_equal(g1[0].numpy()[:u], np.asarray(g0[0])[:u])
    np.testing.assert_array_equal(g1[1].numpy()[:u], np.asarray(g0[1])[:u])
    # wholesale merge over old lists (some sticky) and new sources
    old = pool_i[:, :16].copy()
    old_kept = rng.random(old.shape) > 0.5
    new_src = pool_i[:, 16:24].copy()
    new_src[:, 0] = old[:, 1]  # a source already in the list
    m0 = JK.merge_backlinks_wholesale(
        "dense", JMetric.L2, jv, jnp.asarray(old), jnp.asarray(old_kept),
        jnp.asarray(new_src), jnp.asarray(base), 16)
    m1 = TK.merge_backlinks_wholesale(
        "dense", Metric.L2, tv, torch.from_numpy(old), torch.from_numpy(old_kept),
        torch.from_numpy(new_src), torch.from_numpy(base), 16)
    np.testing.assert_array_equal(m1[0].numpy(), np.asarray(m0[0]))
    np.testing.assert_array_equal(m1[1].numpy(), np.asarray(m0[1]))
    # intra-wave candidates among eligible wave-mates
    elig = rng.random(len(base)) > 0.3
    c0 = JK.intra_wave_candidates("dense", JMetric.L2, jv, jnp.asarray(base),
                                  jnp.asarray(elig), 6)
    c1 = TK.intra_wave_candidates("dense", Metric.L2, tv,
                                  torch.from_numpy(base),
                                  torch.from_numpy(elig), 6)
    np.testing.assert_array_equal(c1[1].numpy(), np.asarray(c0[1]))
    np.testing.assert_allclose(c1[0].numpy(), np.asarray(c0[0]),
                               rtol=1e-5, atol=1e-6)


def test_filtered_search_matches_reference(graphs, monkeypatch):
    """A filter mask drops rows after heap-TID expansion, as the
    reference's _expand_topk does (results capped at ef_search)."""
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "f32")
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")
    monkeypatch.setenv("PGVECTOR_TPU_PALLAS_TAIL", "1")
    keep = np.random.default_rng(14).random(len(graphs["db"])) > 0.5
    d0, r0 = graphs["ref"].search(graphs["q"], K, ef_search=EF,
                                  filter_mask=keep)
    d1, r1 = graphs["port"].search(graphs["q"], K, ef_search=EF,
                                   filter_mask=keep)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6, rtol=1e-5)
    assert keep[r1[r1 >= 0]].all()


@pytest.mark.parametrize("metric,floor", [("COSINE", 0.97), ("IP", 0.95)])
def test_port_build_recall_floor(metric, floor):
    """tests/test_recall_floors.py's data law and floors (5k × 3-d uniform,
    k=20, ef_search=40) for the metrics whose values or orderings differ
    from L2: cosine indexes normalized copies, IP orders by -ip."""
    from pgvector_tpu_torch import FlatIndex

    rng = np.random.default_rng(2024)
    db = rng.random((5000, 3)).astype(np.float32)
    q = rng.random((20, 3)).astype(np.float32)
    table = DenseTable(3, device="cpu")
    table.insert(db)
    _, exact = FlatIndex(table, Metric[metric]).search(q, 20)
    idx = HNSWIndex(table, Metric[metric], m=16, ef_construction=64,
                    wave_size=1024, dedup=False)
    _, r = idx.search(q, 20, ef_search=40)
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / 20
                      for a, b in zip(r, exact)])
    assert recall >= floor, recall


def test_port_build_skips_deleted_rows():
    """Rows deleted before the build are not indexed: elements map to the
    live rows (the index keeps its own value copy), and searches return
    live rows only."""
    rng = np.random.default_rng(15)
    db = rng.normal(size=(2000, 8)).astype(np.float32)
    valid = rng.random(2000) > 0.1
    table = table_from_numpy(db, valid, device="cpu")
    idx = HNSWIndex(table, Metric.L2, m=8, ef_construction=32,
                    wave_size=512, beam_expand=4, dedup=False)
    assert idx.n_elems == valid.sum()
    np.testing.assert_array_equal(idx.elem_rows[: idx.n_elems, 0],
                                  np.flatnonzero(valid))
    q = db[valid][:30] + 0.001
    _, r = idx.search(q, 5, ef_search=32)
    assert valid[r[r >= 0]].all()
    assert (r[:, 0] == np.flatnonzero(valid)[:30]).all()
