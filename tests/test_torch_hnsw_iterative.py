"""Iterative HNSW scans (``hnsw.iterative_scan``) through both packages,
on the CPU, on one graph: the reference builds it (tests/test_hnsw.py's
1,000 × 12 data, m=8, efc=32, wave 128, its defaults otherwise) and the
port loads its state.

For relaxed and strict order × 4 % and 5 % filters and none ×
``hnsw.max_scan_tuples`` 20, 200 and 20,000 × beam_expand 1 and 4, both
packages return the same ids apart from ties at equal distance, with
distances within atol 1e-6 / rtol 1e-5, after the same number of resume
rounds, having scored the same number of candidates per query.  The
test/t/043 count contract (tests/test_hnsw.py's
test_iterative_scan_resumption_contract) is asserted on both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu import config as jconfig  # noqa: E402
from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu_torch import DenseTable, config  # noqa: E402
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from torch_hnsw_pairs import port_of  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

K, EF = 20, 10


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(7)
    db = rng.normal(size=(1000, 12)).astype(np.float32)
    q = rng.normal(size=(20, 12)).astype(np.float32)
    jt = JTable(12)
    jt.insert(db)
    ref = JHNSW(jt, JMetric.L2, m=8, ef_construction=32, wave_size=128)
    tt = DenseTable(12, device="cpu")
    tt.insert(db)
    return dict(q=q[:4], ref=ref, port=port_of(ref, tt), cap=jt.capacity)


def _filters(cap):
    f25 = np.zeros(cap, bool)
    f25[::25] = True  # 4 %
    f20 = np.zeros(cap, bool)
    f20[::20] = True  # 5 %
    return {"4%": f25, "5%": f20, "none": None}


def _counting(module, monkeypatch):
    """Sum each query's scored candidates over the first search and every
    resume of the next scans."""
    tally = []

    def wrap(name):
        fn = getattr(module, name)

        def call(*a, **kw):
            out = fn(*a, **kw)
            tally.append(np.asarray(out[-1]).astype(np.int64))
            return out
        monkeypatch.setattr(module, name, call)

    wrap("query_search_first")
    wrap("query_search_resume")
    return tally


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("cap", [20, 200, 20000])
@pytest.mark.parametrize("filt", ["4%", "5%", "none"])
@pytest.mark.parametrize("mode", ["relaxed_order", "strict_order"])
def test_iterative_scan_matches_reference(graphs, mode, filt, cap, expand,
                                         monkeypatch):
    ref, port = graphs["ref"], graphs["port"]
    monkeypatch.setattr(ref, "beam_expand", expand)
    monkeypatch.setattr(port, "beam_expand", expand)
    fmask = _filters(graphs["cap"])[filt]
    gucs = {"hnsw.iterative_scan": mode, "hnsw.max_scan_tuples": cap}
    j_tally = _counting(JK, monkeypatch)
    t_tally = _counting(TK, monkeypatch)
    with jconfig.local(**gucs):
        d0, r0 = ref.search(graphs["q"], K, ef_search=EF, filter_mask=fmask)
    with config.local(**gucs):
        d1, r1 = port.search(graphs["q"], K, ef_search=EF, filter_mask=fmask)
    assert_same_topk(d0, r0, d1, r1, atol=1e-6, rtol=1e-5)
    assert port._last_scan_rounds == ref._last_scan_rounds
    assert len(t_tally) == len(j_tally) == ref._last_scan_rounds
    np.testing.assert_array_equal(sum(t_tally), sum(j_tally))
    if fmask is not None:
        assert fmask[r1[r1 >= 0]].all()
    if mode == "strict_order":
        for row in d1:
            fin = row[np.isfinite(row)]
            assert np.all(np.diff(fin) >= 0)


@pytest.mark.parametrize("which", ["ref", "port"])
def test_iterative_scan_resumption_contract(graphs, which):
    """test/t/043: as max_scan_tuples grows, a filtered iterative scan
    returns more matches; strict_order output is sorted and never larger
    than relaxed; every returned row passes the filter."""
    idx = graphs[which]
    cfg = jconfig if which == "ref" else config
    fmask = _filters(graphs["cap"])["4%"]
    qs = graphs["q"]
    counts = []
    for cap in (20, 200, 20000):
        with cfg.local(**{"hnsw.iterative_scan": "relaxed_order",
                          "hnsw.max_scan_tuples": cap}):
            _, r = idx.search(qs, K, ef_search=EF, filter_mask=fmask)
        counts.append(int((np.asarray(r) >= 0).sum()))
    assert counts[0] <= counts[1] <= counts[2]
    assert counts[2] > counts[0]
    with cfg.local(**{"hnsw.iterative_scan": "relaxed_order"}):
        _, r_rel = idx.search(qs, K, ef_search=EF, filter_mask=fmask)
    with cfg.local(**{"hnsw.iterative_scan": "strict_order"}):
        d_str, r_str = idx.search(qs, K, ef_search=EF, filter_mask=fmask)
    for row in np.asarray(d_str):
        fin = row[np.isfinite(row)]
        assert np.all(np.diff(fin) >= 0)
    assert (np.asarray(r_str) >= 0).sum() <= (np.asarray(r_rel) >= 0).sum()
    for r in (np.asarray(r_rel), np.asarray(r_str)):
        assert all(x % 25 == 0 for x in r[r >= 0].ravel())
    # the plain capped scan never finds more than the iterative one
    _, r_off = idx.search(qs, K, ef_search=EF, filter_mask=fmask)
    assert (np.asarray(r_off) >= 0).sum() <= (np.asarray(r_rel) >= 0).sum()


def test_merge_scan_batches_matches_reference():
    """The batch merge: repeats across batches, suppressed (-1) entries,
    ties at equal distance, fewer than k distinct rows."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    r = rng.integers(0, 40, size=(6, 30)).astype(np.int32)
    d = np.round(rng.random((6, 30)) * 4).astype(np.float32)  # many ties
    r[:, ::7] = -1
    d[:, ::7] = np.inf
    r[1, :] = 3  # one row only
    for k in (5, 20):
        m0 = JK.merge_scan_batches(jnp.asarray(d), jnp.asarray(r), k)
        m1 = TK.merge_scan_batches(torch.from_numpy(d), torch.from_numpy(r),
                                   k)
        np.testing.assert_array_equal(m1[1].numpy(), np.asarray(m0[1]))
        np.testing.assert_array_equal(m1[0].numpy(), np.asarray(m0[0]))
