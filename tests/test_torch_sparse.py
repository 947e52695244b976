"""The ``sparsevec`` type through both packages, on the CPU.

- ``SparseVec``: the reference's constructor checks and messages, the
  dense conversions, the scalar distances, norms, ordering and text and
  binary I/O, equal to the reference's (tests/test_torch_types.py holds
  the golden cases).
- ``sparse_scores`` / ``sparse_scores_batch`` for all four metrics, the
  HNSW scorers (densified-query and merge join) and pairwise blocks
  (densified and merge join), against the reference within atol 1e-5.
- ``FlatIndex``'s three sparse routes, each forced through the reference's
  own thresholds (the same environment variables), against the
  reference's answers: the same ids apart from ties, distances within
  tests/torch_parity.py's tolerance.
- HNSW: the port searches a reference-built sparse graph (inner product
  and L2) loaded through ``hnsw_from_numpy``, and builds its own.

Every input comes from its own seeded ``np.random.default_rng``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu import SparseVec as JSparseVec  # noqa: E402
from pgvector_tpu import errors as jerrors  # noqa: E402
from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops import distance as JD  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import SparseTable as JSparseTable  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    DataException, FeatureNotSupported, FlatIndex, HNSWIndex, Metric,
    ProgramLimitExceeded, SparseTable, SparseVec, Vector)
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.io.convert import (  # noqa: E402
    hnsw_from_numpy, sparse_table_from_numpy)
from pgvector_tpu_torch.ops import distance as TD  # noqa: E402
from torch_hnsw_pairs import recall, reference_state  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

METRICS = ["L2", "IP", "COSINE", "L1"]
PAD = 2**30


def _rows(seed, n, dim, nnz):
    """n random sparse rows: (indices, values) pairs, 0 to nnz entries."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c = np.sort(rng.choice(dim, rng.integers(0, nnz + 1), replace=False))
        out.append((c.astype(np.int32),
                    rng.normal(size=len(c)).astype(np.float32)))
    return out


def _padded(rows, width):
    idx = np.full((len(rows), width), PAD, np.int32)
    val = np.zeros((len(rows), width), np.float32)
    for r, (i, v) in enumerate(rows):
        idx[r, : len(i)], val[r, : len(i)] = i, v
    return idx, val


def _tables(rows, dim, nnz_cap):
    jt = JSparseTable(dim, nnz_cap=nnz_cap)
    jt.insert([JSparseVec(dim, i, v) for i, v in rows])
    tt = SparseTable(dim, nnz_cap=nnz_cap, device="cpu")
    tt.insert([SparseVec(dim, i, v) for i, v in rows])
    return jt, tt


# ------------------------------------------------------------ the type
@pytest.mark.parametrize("args,exc,msg", [
    ((5, [0, 0], [1, 2]), DataException, "duplicates"),
    ((5, [3, 1], [1, 2]), DataException, "ascending order"),
    ((5, [5], [1]), DataException, "index out of bounds"),
    ((5, [1], [np.nan]), DataException, "NaN not allowed"),
    ((5, [1], [np.inf]), DataException, "infinite value"),
    ((0, [], []), DataException, "at least 1 dimension"),
    ((5, [1, 2], [1]), DataException, "same length"),
    ((2, [0, 1, 2], [1, 1, 1]), DataException, "more elements than"),
    ((100000, np.arange(16001), np.ones(16001)), ProgramLimitExceeded,
     "more than 16000 non-zero"),
])
def test_sparsevec_checks_match_reference(args, exc, msg):
    with pytest.raises(exc, match=msg) as e1:
        SparseVec(*args)
    with pytest.raises(Exception) as e0:
        JSparseVec(*args)
    assert str(e1.value) == str(e0.value)
    assert e1.value.sqlstate == e0.value.sqlstate


def test_sparsevec_values_match_reference():
    v = SparseVec(5, [1, 3, 4], [1.5, 0.0, -2.0])  # zeros are dropped
    assert v.nnz == 2 and v.indices.tolist() == [1, 4]
    d = np.array([0, 1.5, 0, -2, 0], np.float32)
    s = SparseVec.from_dense(Vector(d))
    assert s == SparseVec(5, [1, 3], [1.5, -2])
    np.testing.assert_array_equal(s.to_dense(), d)
    np.testing.assert_array_equal(s.to_vector().x, d)
    assert SparseVec(5, [0, 1], [3, 4]).norm() == 5.0
    n = SparseVec(5, [0, 1], [3, 4]).l2_normalize()
    np.testing.assert_array_equal(n.values, np.float32([0.6, 0.8]))
    assert SparseVec(5, [], []).l2_normalize().nnz == 0
    js = JSparseVec.from_dense(d)
    assert s.to_text() == js.to_text() == "{2:1.5,4:-2}/5"
    assert SparseVec.from_text("{1:1}/5") == SparseVec(5, [0], [1])
    assert s.to_binary() == js.to_binary()
    assert SparseVec.from_binary(js.to_binary()) == s
    with pytest.raises(DataException, match="dimensions 5 and 6"):
        s.l2_distance(SparseVec(6, [1], [1]))
    # ordering as if dense (test/sql/sparsevec.sql)
    a, b = SparseVec(5, [0], [1]), SparseVec(5, [0], [2])
    assert a < b and SparseVec(5, [1], [1]) < a
    assert SparseVec(5, [], []) < SparseVec(6, [], [])
    assert SparseVec(5, [0], [-1]) < SparseVec(5, [], [])
    assert hash(a) == hash(SparseVec(5, [0], [1]))


def test_sparsevec_distances_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.normal(size=20) * (rng.random(20) < 0.4)
        b = rng.normal(size=20) * (rng.random(20) < 0.4)
        sa, sb = SparseVec.from_dense(a), SparseVec.from_dense(b)
        ja, jb = JSparseVec.from_dense(a), JSparseVec.from_dense(b)
        for name in ("l2_distance", "l2_squared_distance", "inner_product",
                     "negative_inner_product", "l1_distance"):
            assert getattr(sa, name)(sb) == getattr(ja, name)(jb), name
        ca, cb = sa.cosine_distance(sb), ja.cosine_distance(jb)
        assert ca == cb or (np.isnan(ca) and np.isnan(cb))
        assert sa.norm() == ja.norm()
        assert sa.compare(sb) == ja.compare(jb)


# ------------------------------------------------------------ the ops
@pytest.mark.parametrize("metric", METRICS)
def test_sparse_scores_match_reference(metric):
    rows = _rows(1, 60, 40, 8)
    rows[3] = (np.zeros(0, np.int32), np.zeros(0, np.float32))  # empty row
    idx, val = _padded(rows, 10)
    qi, qv = _padded(_rows(2, 6, 40, 8), 12)
    m = JMetric[metric]
    want = np.asarray(JD.sparse_scores_batch(
        m, jnp.asarray(qi), jnp.asarray(qv), jnp.asarray(idx),
        jnp.asarray(val)))
    got = TD.sparse_scores_batch(
        Metric[metric], torch.from_numpy(qi), torch.from_numpy(qv),
        torch.from_numpy(idx), torch.from_numpy(val)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    one = TD.sparse_scores(Metric[metric], torch.from_numpy(qi[1]),
                           torch.from_numpy(qv[1]), torch.from_numpy(idx),
                           torch.from_numpy(val)).numpy()
    np.testing.assert_allclose(one, want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sdim", [0, 40])
@pytest.mark.parametrize("metric", METRICS)
def test_sparse_scorers_and_pairs_match_reference(metric, sdim):
    """make_scorer's densified-query (sdim > 0; L1 keeps the merge join)
    and merge-join scorers, and the pairwise select blocks."""
    rng = np.random.default_rng(3)
    idx, val = _padded(_rows(4, 120, 40, 8), 8)
    qi, qv = idx[:7], val[:7]
    rows = rng.integers(0, 120, size=(7, 15)).astype(np.int32)
    rows[:, ::4] = -1
    jv = (jnp.asarray(idx), jnp.asarray(val))
    tv = (torch.from_numpy(idx), torch.from_numpy(val))
    want = np.asarray(JK.make_scorer("sparse", JMetric[metric], jv, sdim)(
        (jnp.asarray(qi), jnp.asarray(qv)), jnp.asarray(rows)))
    got = TK.make_scorer("sparse", Metric[metric], tv, sdim)(
        (torch.from_numpy(qi), torch.from_numpy(qv)), torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    elems = np.stack([rng.choice(120, 12, replace=False)
                      for _ in range(4)]).astype(np.int32)
    elems[:, -3:] = -1
    want = np.asarray(JK._pairwise_dists("sparse", JMetric[metric], jv,
                                         jnp.asarray(elems), sdim))
    got = TK._pairwise_dists("sparse", Metric[metric], tv,
                             torch.from_numpy(elems), sdim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ exact search
@pytest.fixture(scope="module")
def flat_data():
    rows = _rows(5, 4096, 64, 6)
    jt, tt = _tables(rows, 64, 8)
    dead = np.arange(0, 4096, 13)
    jt.delete(dead)
    tt.delete(dead)
    q = _rows(6, 9, 64, 6)
    return jt, tt, q


# route → (environment, the reference's last_path, the port's)
ROUTES = {
    "densified": ({}, "grouped-densified", "densified-"),
    "densified-tile": ({"PGVECTOR_TPU_SPARSE_DENSIFY_GB": "0",
                        "PGVECTOR_TPU_SPARSE_TILE_BYTES": str(512 * 64 * 4)},
                       "densified-tile", "densified-tile"),
    "merge-join": ({"PGVECTOR_TPU_SPARSE_DENSIFY_GB": "0",
                    "PGVECTOR_TPU_SPARSE_TILE_BYTES": "1024",
                    "PGVECTOR_TPU_SPARSE_CHUNK": "4"},
                   "xla-sparse", "merge-join"),
}


@pytest.mark.parametrize("metric,route", [
    (m, r) for m in METRICS for r in ROUTES
    if m != "L1" or r == "merge-join"])  # L1 always takes the merge join
def test_flat_sparse_routes_match_reference(flat_data, metric, route,
                                            monkeypatch):
    env, ref_path, port_path = ROUTES[route]
    for k_, v in env.items():
        monkeypatch.setenv(k_, v)
    jt, tt, q = flat_data
    fmask = np.random.default_rng(7).random(4096) > 0.25
    ref, port = JFlat(jt, JMetric[metric]), FlatIndex(tt, Metric[metric])
    for f in (None, fmask):
        d0, r0 = ref.search([JSparseVec(64, i, v) for i, v in q], 10,
                            filter_mask=f)
        d1, r1 = port.search([SparseVec(64, i, v) for i, v in q], 10,
                             filter_mask=f)
        assert ref.last_path == ref_path
        assert port.last_path.startswith(port_path), port.last_path
        assert_same_topk(d0, r0, d1, r1)


def test_flat_sparse_cache_follows_inserts():
    rows = _rows(8, 4100, 30, 4)
    tt = SparseTable(30, nnz_cap=4, device="cpu")
    tt.insert([SparseVec(30, i, v) for i, v in rows[:4096]])
    flat = FlatIndex(tt, Metric.L2)
    q = [SparseVec(30, *rows[4097])]
    flat.search(q, 3)
    assert flat.last_path == "densified-fused"
    tt.insert([SparseVec(30, *rows[4097])])  # an exact copy of the query
    _, r = flat.search(q, 1)
    assert tt.get(int(r[0, 0])) == q[0]
    with pytest.raises(DataException, match="dimensions 31 and 30"):
        flat.search([SparseVec(31, [1], [1])], 1)


def test_sparse_table_from_arrays_checks():
    idx, val = _padded(_rows(9, 20, 30, 5), 5)
    t = sparse_table_from_numpy(idx, val, 30, np.ones(20, bool),
                                device="cpu")
    assert t.count == 20 and t.nnz_cap == 5
    bad = idx.copy()
    bad[0, :2] = [3, 3]
    val2 = val.copy()
    val2[0, :2] = 1.0
    with pytest.raises(DataException, match="ascending and distinct"):
        sparse_table_from_numpy(bad, val2, 30, np.ones(20, bool),
                                device="cpu")
    with pytest.raises(DataException, match="index out of bounds"):
        sparse_table_from_numpy(np.where(idx == PAD, PAD, idx + 30), val, 30,
                                np.ones(20, bool), device="cpu")


# ------------------------------------------------------------ HNSW
@pytest.fixture(scope="module")
def sparse_graphs():
    rows = _rows(10, 1200, 200, 12)
    q = _rows(11, 16, 200, 12)
    out = {"rows": rows, "q": q}
    for metric in ("IP", "L2"):
        jt, tt = _tables(rows, 200, 16)
        ref = JHNSW(jt, JMetric[metric], m=8, ef_construction=32,
                    wave_size=128, beam_expand=4)
        out[metric] = (ref, tt)
    return out


@pytest.mark.parametrize("metric", ["IP", "L2"])
def test_sparse_hnsw_search_on_reference_graph(sparse_graphs, metric,
                                               monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")
    ref, tt = sparse_graphs[metric]
    arrays, meta = reference_state(ref)
    arrays["values1"] = np.asarray(ref.values[1][: ref.n_elems])
    meta["kind"] = "sparse"
    port = hnsw_from_numpy(tt, arrays, meta)
    assert port._scorer_sdim() == ref._scorer_sdim() == 200
    assert port._pair_sdim() == ref._pair_sdim()
    jq = [JSparseVec(200, i, v) for i, v in sparse_graphs["q"]]
    tq = [SparseVec(200, i, v) for i, v in sparse_graphs["q"]]
    d0, r0 = ref.search(jq, 10, ef_search=40)
    d1, r1 = port.search(tq, 10, ef_search=40)
    assert_same_topk(d0, r0, d1, r1)
    assert port._last_scan_steps == int(ref._last_scan_steps)


def test_sparse_hnsw_build(sparse_graphs):
    ref, tt = sparse_graphs["IP"]
    port = HNSWIndex(tt, Metric.IP, m=8, ef_construction=32, wave_size=128,
                     beam_expand=4)
    n = ref.n_elems
    np.testing.assert_array_equal(port.levels[:n], ref.levels[:n])
    assert port._effective_wave_size() == ref._effective_wave_size()
    tq = [SparseVec(200, i, v) for i, v in sparse_graphs["q"]]
    jq = [JSparseVec(200, i, v) for i, v in sparse_graphs["q"]]
    _, gt = FlatIndex(tt, Metric.IP).search(tq, 10)
    _, r_ref = ref.search(jq, 10, ef_search=64)
    _, r = port.search(tq, 10, ef_search=64)
    assert recall(r, gt) >= recall(r_ref, gt) - 0.05


def test_sparse_hnsw_errors():
    with pytest.raises(DataException, match="1000 non-zero"):
        HNSWIndex(SparseTable(10, nnz_cap=1001, device="cpu"), Metric.IP,
                  build=False)
    with pytest.raises(FeatureNotSupported, match="for sparse vectors"):
        HNSWIndex(SparseTable(10, device="cpu"), Metric.HAMMING, build=False)
    with pytest.raises(jerrors.FeatureNotSupported,
                       match="for sparse vectors"):
        JHNSW(JSparseTable(10), JMetric.HAMMING, build=False)


def test_sparse_table_without_device_needs_a_card(monkeypatch):
    """As DenseTable: no named device means the card, and without one a
    DataException that names the way out."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DataException, match='device="cpu"'):
        SparseTable(8)
    idx, val = _padded(_rows(12, 4, 8, 3), 3)
    with pytest.raises(DataException, match='device="cpu"'):
        sparse_table_from_numpy(idx, val, 8, np.ones(4, bool))
    t = SparseTable(8, device="cpu")
    t.insert([SparseVec(8, [2], [1.0])])
    assert t.idx.device.type == "cpu" and t.get(0) == SparseVec(8, [2], [1])
