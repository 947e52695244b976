"""The port's CUDA kernels on the card: K1 (fused top-k, 3xTF32, within its
derived error bound ``k1_error_bound``) and K2 (the fused packed hop, and
its hop tail alone) against their plain PyTorch versions; the HNSW and
IVFFlat scans on CUDA against the same scans on the CPU; HNSW built with
its defaults on the card, and its iterative scans and vacuum against the
CPU's on the same graph; checkpoints loaded onto the card; k-means's
generator on the table's device; K1 at 4,096 dims (the densified sparse
scans); K4 (bit_topk) and K5 (bit_point_scores) equal to their plain
versions, and the bit and sparse indexes on CUDA against the CPU; K2's
int8 slab equal to its plain version (L1 within ``int8_l1_bound``), and
the grouped exact engine on the card against the tiled scan; K3
(select_neighbors) equal to its plain version bit for bit, from C = 1 to
1,100, on the formed block and on the Gram form (L2, inner product and
cosine, NaN and ±inf among the products), and K6 (gather_hop, the whole
hop) against its plain version for every metric and value type, level 0
and above, done flags and the count of queries not done included, with
a build that runs every select through K3 and every hop through one K6
launch; K7 (greedy_walk, the upper levels' greedy descent) equal to its
plain version on exact-integer values, and a search that walks its upper
levels in one K7 launch with no host read, at the per-level descent's
recall; the
planner's calibrated pick against the timed paths; the mesh paths on four
shards of one card (the sharded exact search through K1 against
FlatIndex, the mesh build bit for bit, the fan-out against the 1-D
search) and on two cards where there are two.
Every test needs an NVIDIA Hopper GPU and ``nvcc`` (the kernels build at
first use) and skips elsewhere.

On the card (which has no JAX; ``--noconftest`` skips tests/conftest.py,
which configures JAX for the reference's tests):

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_cuda.py
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu_torch import (  # noqa: E402
    BinaryQuantizedIndex, BitTable, DenseTable, FlatIndex, HNSWIndex,
    IVFFlatIndex, Metric, SparseTable, SparseVec, config)
from pgvector_tpu_torch.ops import distance as TD  # noqa: E402
from pgvector_tpu_torch.ops.bit_scan import (  # noqa: E402
    bit_point_scores, bit_point_scores_plain, bit_topk, bit_topk_plain)
from pgvector_tpu_torch.index import ivf_kmeans  # noqa: E402
from pgvector_tpu_torch.index.hnsw_kernels import HOP_READ_EVERY  # noqa: E402
from pgvector_tpu_torch.io import checkpoint  # noqa: E402
from pgvector_tpu_torch.io.convert import (  # noqa: E402
    hnsw_from_numpy, ivfflat_from_numpy)
from pgvector_tpu_torch.ops.fused_topk import (  # noqa: E402
    fused_topk, fused_topk_plain, k1_error_bound, k1_l2_error_bound,
    l2_root_bound)
from pgvector_tpu_torch.ops.hop_tail import (  # noqa: E402
    MAX_WIDTH, hop_tail, hop_tail_plain)
from pgvector_tpu_torch.ops.packed_hop import (  # noqa: E402
    int8_l1_bound, packed_hop, packed_hop_plain)
from pgvector_tpu_torch.ops.gather_hop import (  # noqa: E402
    gather_hop, gather_hop_plain)
from pgvector_tpu_torch.ops.greedy_walk import (  # noqa: E402
    greedy_walk, greedy_walk_plain)
from pgvector_tpu_torch.ops.select_neighbors import (  # noqa: E402
    Gram, select_neighbors, select_neighbors_plain)
from torch_parity import (  # noqa: E402
    assert_same_pool, assert_same_topk, gather_hop_case, gram_case,
    int8_hop_case, packed_hop_case, select_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("nq,n,d,k", [(1, 100, 7, 1), (70, 5000, 128, 10),
                                      (130, 20000, 33, 64),
                                      (8, 70000, 128, 64)])
@pytest.mark.parametrize("ip", [False, True])
def test_fused_topk_kernel_matches_plain(dev, nq, n, d, k, ip):
    rng = np.random.default_rng(nq + n + k)
    q = torch.tensor(rng.normal(size=(nq, d)), dtype=torch.float32, device=dev)
    db = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                      device=dev)
    dbsq = torch.zeros(n, device=dev) if ip else (db * db).sum(1)
    dbsq[torch.tensor(rng.random(n) < 0.1, device=dev)] = torch.inf
    launches = fused_topk.launches
    d1, i1 = fused_topk(q, db, dbsq, k)
    torch.cuda.synchronize()
    assert fused_topk.launches == launches + 1
    d0, i0 = fused_topk_plain(q, db, dbsq, k)
    bound = k1_error_bound(q, db, dbsq, i0, i1).cpu().numpy()
    assert_same_topk(d0.cpu(), i0.cpu(), d1.cpu(), i1.cpu(), atol=bound,
                     rtol=0.0)
    assert i1.dtype == torch.int32


@pytest.mark.parametrize("d", [7, 128, 960])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_fused_topk_3xtf32_edge_cases(dev, d, k):
    """The tensor-core K1 at a ragged row and query count, dims that are
    not a multiple of the 32-dim chunk (7: nor of a 16-byte load), 10 %
    dead rows and duplicated rows whose scores tie exactly."""
    rng = np.random.default_rng(d * 100 + k)
    n, nq = 20037, 130
    db = rng.normal(size=(n, d)).astype(np.float32) * 1.5
    db[5000:5100] = db[:100]  # ties, broken by the lower id
    q = torch.tensor(db[rng.choice(n, nq)] + rng.normal(size=(nq, d)) * 0.1,
                     dtype=torch.float32, device=dev)
    db = torch.tensor(db, device=dev)
    dbsq = (db * db).sum(1)
    dbsq[torch.tensor(rng.random(n) < 0.1, device=dev)] = torch.inf
    d1, i1 = fused_topk(q, db, dbsq, k)
    d0, i0 = fused_topk_plain(q, db, dbsq, k)
    bound = k1_error_bound(q, db, dbsq, i0, i1).cpu().numpy()
    assert_same_topk(d0.cpu(), i0.cpu(), d1.cpu(), i1.cpu(), atol=bound,
                     rtol=0.0)
    assert not torch.isinf(d1).any()


def _k1_case(dev, rng, nq, n, d, ip, dead=0.1):
    q = torch.tensor(rng.normal(size=(nq, d)), dtype=torch.float32, device=dev)
    db = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                      device=dev)
    dbsq = torch.zeros(n, device=dev) if ip else (db * db).sum(1)
    dbsq[torch.tensor(rng.random(n) < dead, device=dev)] = torch.inf
    return q, db, dbsq


def _k1_agrees(q, db, dbsq, k):
    d1, i1 = fused_topk(q, db, dbsq, k)
    d0, i0 = fused_topk_plain(q, db, dbsq, k)
    bound = k1_error_bound(q, db, dbsq, i0, i1).cpu().numpy()
    assert_same_topk(d0.cpu(), i0.cpu(), d1.cpu(), i1.cpu(), atol=bound,
                     rtol=0.0)
    return d1, i1


@pytest.mark.parametrize("d", [128, 36])
@pytest.mark.parametrize("ip", [False, True])
def test_fused_topk_whole_tile_products(dev, d, ip):
    """N = 64 rows and k = 64: K1 returns every score, so each product of
    a 64-row wgmma tile (every query column of a 128-query block, every k8
    slice and k-half of the descriptors; D 36 ends in a 4-dim chunk) is
    held against the plain version, and every row comes back."""
    rng = np.random.default_rng(64 + d + ip)
    q, db, dbsq = _k1_case(dev, rng, 130, 64, d, ip, dead=0.0)
    d1, i1 = _k1_agrees(q, db, dbsq, 64)
    assert not torch.isinf(d1).any()
    assert torch.equal(torch.sort(i1, dim=1).values,
                       torch.arange(64, dtype=torch.int32,
                                    device=dev).expand(130, -1))


@pytest.mark.parametrize("nq", [1, 63, 65, 129, 257])
@pytest.mark.parametrize("k", [10, 64])
def test_fused_topk_query_counts(dev, nq, k):
    """Query counts around the 64-query halves and 128-query blocks: a
    block with one live query, a last block of 1 or 65 live queries (L2
    at k 10, inner product at k 64)."""
    rng = np.random.default_rng(nq * 7 + k)
    q, db, dbsq = _k1_case(dev, rng, nq, 3001, 128, k == 64)
    _k1_agrees(q, db, dbsq, k)


@pytest.mark.parametrize("d", [128, 40])
def test_fused_topk_unaligned_table_view(dev, d):
    """A table view whose base is 4 bytes past a 16-byte boundary: the
    wrapper copies it once, and the answer equals the aligned table's."""
    rng = np.random.default_rng(d)
    q, base, _ = _k1_case(dev, rng, 70, 4001, d, False)
    flat = base.reshape(-1)[1: 1 + 4000 * d]
    db = flat.view(4000, d)
    assert db.data_ptr() % 16 == 4 and db.is_contiguous()
    dbsq = (db * db).sum(1)
    d1, i1 = _k1_agrees(q, db, dbsq, 10)
    d2, i2 = fused_topk(q, db.clone(), dbsq, 10)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)


def test_fused_topk_kernel_rejects(dev):
    q = torch.zeros((4, 8), device=dev)
    db = torch.zeros((100, 8), device=dev)
    with pytest.raises(ValueError):
        fused_topk(q, db, torch.zeros(100, device=dev), 65)
    with pytest.raises(ValueError):
        fused_topk(q.double(), db, torch.zeros(100, device=dev), 10)
    with pytest.raises(ValueError):
        fused_topk(q.T, db, torch.zeros(100, device=dev), 10)


def _hop_inputs(dev, q, ef, w, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    pool_d = torch.sort(torch.rand((q, ef), generator=g), dim=1).values
    pool_i = torch.randint(0, 50_000, (q, ef), generator=g, dtype=torch.int32)
    pool_x = torch.rand((q, ef), generator=g) > 0.5
    pool_i[::7, ef // 2:] = -1          # unfilled pool tails
    pool_d[::7, ef // 2:] = torch.inf
    pool_x[::7, ef // 2:] = False
    cand_i = torch.randint(0, 50_000, (q, w), generator=g, dtype=torch.int32)
    cand_d = torch.rand((q, w), generator=g)
    cand_i[:, 3], cand_d[:, 3] = pool_i[:, 0], pool_d[:, 0]  # pool duplicate
    cand_i[:, 5], cand_d[:, 5] = cand_i[:, 4], cand_d[:, 4]  # candidate pair
    cand_i[:, 7], cand_d[:, 7] = -1, torch.inf               # masked lane
    cand_i[::5, w // 3:] = -1
    cand_d[::5, w // 3:] = torch.inf
    pool_p = pool_i * 2 + pool_x.to(torch.int32)
    return [t.to(dev).contiguous() for t in (pool_d, pool_p, cand_d, cand_i)]


@pytest.mark.parametrize("ef,w", [(8, 24), (24, 256), (40, 256),
                                  (100, 256), (200, 300), (1000, 256),
                                  (1000, 3000)])
def test_hop_tail_kernel_equals_plain(dev, ef, w):
    args = _hop_inputs(dev, 300, ef, w, seed=ef + w)
    d1, p1 = hop_tail(*args, ef, w)
    d0, p0 = hop_tail_plain(*args, ef, w)
    assert torch.equal(p1, p0)
    assert torch.equal(d1, d0)


def test_hop_tail_kernel_rejects_wide_rows(dev):
    args = _hop_inputs(dev, 4, 100, MAX_WIDTH, seed=1)
    with pytest.raises(ValueError):
        hop_tail(*args, 100, MAX_WIDTH)


def _assert_same_hop(out1, out0, atol=None):
    """Two whole hops agree: the pools as top-k lists (``atol`` a bound per
    entry, else the f32 tolerance), the done flags, the count of queries
    not done and the hop counts exactly."""
    d1, p1, done1, left1, hops1 = (t.cpu() for t in out1)
    d0, p0, done0, left0, hops0 = (t.cpu() for t in out0)
    if atol is None:
        assert_same_pool(d0, p0, d1, p1)
    else:
        assert_same_pool(d0, p0, d1, p1, atol=atol, rtol=0.0)
    assert torch.equal(done1, done0) and torch.equal(hops1, hops0)
    assert int(left1) == int(left0)


@pytest.mark.parametrize("d", [7, 33, 128, 960, 1001])
@pytest.mark.parametrize("slab", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["L2", "IP", "L1"])
@pytest.mark.parametrize("ef,e_sel", [(24, 8), (100, 1), (1000, 4)])
def test_packed_hop_kernel_matches_plain(dev, d, slab, metric, ef, e_sel):
    """K2, the whole hop, against its plain version on seeded pools:
    16-byte slab rows through the bulk-copy ring and the others read as
    single values (counted apart), slabs of a warp a query (D 7 to 128)
    and of several (D 960 and 1,001: more than 16 KB), every metric code,
    one to eight slabs a row, merges of 64 to 2,048 lanes; then a second
    hop from the first's done flags and hop counts."""
    case = packed_hop_case(d + ef, 37, ef, e_sel, d=d, cap=1200)
    args = [torch.from_numpy(a).to(dev) for a in case]
    args[3] = args[3].to(slab)
    path = "bulk" if d * args[3].element_size() % 16 == 0 else "scalar"
    launches = dict(packed_hop.launches_by_path)
    out1 = packed_hop(*args, ef, e_sel, Metric[metric])
    torch.cuda.synchronize()
    assert packed_hop.launches_by_path[path] == launches[path] + 1
    out0 = packed_hop_plain(*args, ef, e_sel, Metric[metric])
    _assert_same_hop(out1, out0)
    state = dict(done=out0[2], hops=out0[4])
    _assert_same_hop(
        packed_hop(out0[0], out0[1], *args[2:], ef, e_sel, Metric[metric],
                   **state),
        packed_hop_plain(out0[0], out0[1], *args[2:], ef, e_sel,
                         Metric[metric], **state))


def _assert_int8_hop(a, out1, out0):
    """K2-int8 against its plain version: L2, inner product and cosine
    bit for bit; L1 within int8_l1_bound."""
    metric = a[7]
    if metric is Metric.L1:
        atol = int8_l1_bound(out0[0], a[3].shape[2]).cpu().numpy()
        _assert_same_hop(out1, out0, atol=atol)
    else:
        for x, y in zip(out1, out0):
            assert torch.equal(x, y.to(x.device)), metric


@pytest.mark.parametrize("d,m2", [(33, 16), (128, 16), (960, 16),
                                  (960, 32)])
@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE", "L1"])
@pytest.mark.parametrize("ef,e_sel", [(24, 8), (100, 1), (100, 8)])
def test_packed_hop_int8_kernel_matches_plain(dev, d, m2, metric, ef, e_sel):
    """K2's int8 slab against its plain version on seeded pools with -1
    list slots: 16-byte rows through the ring (D 128 and 960) and
    unaligned ones read as single values (D 33), a warp a query and, at
    960 x 32 (30 KB slabs, the 960-d main path's), several; every metric,
    one to eight slabs a row."""
    case = int8_hop_case(d + ef + 1, 37, ef, e_sel, m2=m2, d=d, cap=1200)
    t = [torch.from_numpy(x).to(dev) for x in case]
    qc, sq, q2 = TD.int8_query(t[4], t[5])
    a = [*t[:5], ef, e_sel, Metric[metric], (qc, sq, q2, t[6], t[5])]
    launches = dict(packed_hop.launches_by_slab)
    out1 = packed_hop(*a)
    torch.cuda.synchronize()
    assert packed_hop.launches_by_slab["int8"] == launches["int8"] + 1
    assert packed_hop.launches_by_slab["bf16"] == launches["bf16"]
    _assert_int8_hop(a, out1, packed_hop_plain(*a))


def test_packed_hop_int8_refuses_mixed_inputs(dev):
    case = int8_hop_case(5, 8, 24, 2, d=32)
    t = [torch.from_numpy(x).to(dev) for x in case]
    qc, sq, q2 = TD.int8_query(t[4], t[5])
    with pytest.raises(ValueError, match="only an int8 slab"):
        packed_hop(*t[:5], 24, 2, Metric.L2)
    with pytest.raises(ValueError, match="only an int8 slab"):
        packed_hop(*t[:3], t[3].float(), t[4], 24, 2, Metric.L2,
                   (qc, sq, q2, t[6], t[5]))


def test_packed_hop_kernel_on_a_card_graph(dev, monkeypatch):
    """K2 against its plain version on every hop state of searches over a
    graph built on the card, f32, bf16 and int8 slabs (int8: equal bit for
    bit), and the launches against the searches' hops."""
    from pgvector_tpu_torch.index import hnsw_kernels

    rng = np.random.default_rng(9)
    db = rng.normal(size=(6000, 32)).astype(np.float32)
    q = db[:200] + rng.normal(size=(200, 32)).astype(np.float32) * 0.05
    table = DenseTable(32, device=dev)
    table.insert(db)
    idx = HNSWIndex(table, Metric.L2, m=8, ef_construction=32,
                    wave_size=512, beam_expand=4, dedup=False)
    states = []

    def keep(t):
        return t.clone() if torch.is_tensor(t) else t

    def record(*a, **kw):
        states.append(([keep(t) for t in a],
                       {k: keep(v) for k, v in kw.items() if k != "out"}))
        return packed_hop(*a, **kw)

    monkeypatch.setattr(hnsw_kernels, "packed_hop", record)
    for mode in ("f32", "bf16", "int8"):
        monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", mode)
        n = len(states)
        idx.search(q, 10, ef_search=40)
        steps, launched = idx._last_scan_steps, idx._last_scan_launches
        assert len(states) - n == launched
        assert steps <= launched < steps + hnsw_kernels.HOP_READ_EVERY
    assert len(states) >= 15
    assert {a[3].dtype for a, _ in states} == {torch.float32, torch.bfloat16,
                                               torch.int8}
    for a, kw in states:
        out1 = packed_hop(*a, **kw)
        out0 = packed_hop_plain(*a, **kw)
        if a[3].dtype == torch.int8:
            _assert_int8_hop(a, out1, out0)
        else:
            _assert_same_hop(out1, out0)


@pytest.mark.parametrize("t,c,lm", [(300, 1, 8), (300, 5, 8), (300, 8, 8),
                                    (1024, 80, 32), (4096, 64, 32),
                                    (300, 33, 16), (200, 110, 32),
                                    (200, 111, 32), (300, 400, 200),
                                    (64, 1100, 32)])
@pytest.mark.parametrize("forced", [False, True])
def test_select_neighbors_kernel_equals_plain(dev, t, c, lm, forced):
    """K3 against its plain version bit for bit on seeded pools with
    ties, invalid, +inf and forced candidates: C below, at and far above
    lm, the sorts in registers (C up to 512) and in shared memory (C =
    1,100); the formed block, then the Gram form of L2 and of the inner
    product with NaN and ±inf among the products."""
    args = [None if a is None else torch.from_numpy(a).to(dev)
            for a in select_case(c + lm + forced, t, c, forced)]
    launches = select_neighbors.launches
    p1, k1 = select_neighbors(*args[:3], lm, args[3])
    torch.cuda.synchronize()
    assert select_neighbors.launches == launches + 1
    p0, k0 = select_neighbors_plain(*args[:3], lm, args[3])
    assert p1.dtype == p0.dtype == torch.int32
    assert torch.equal(p1, p0) and torch.equal(k1, k0)
    for l2 in (True, False):
        base, ip, sq, valid, fc = (
            None if a is None else torch.from_numpy(a).to(dev)
            for a in gram_case(c + lm + forced + l2, t, c, l2, forced))
        g = Gram(ip, sq, l2)
        p1, k1 = select_neighbors(base, g, valid, lm, fc)
        torch.cuda.synchronize()
        p0, k0 = select_neighbors_plain(base, g, valid, lm, fc)
        assert torch.equal(p1, p0) and torch.equal(k1, k0)
    assert select_neighbors.launches == launches + 3


def test_select_neighbors_kernel_rejects(dev):
    base, pair, valid, fc = (torch.from_numpy(a).to(dev)
                             for a in select_case(1, 8, 16))
    with pytest.raises(ValueError):
        select_neighbors(base.double(), pair, valid, 8, fc)
    with pytest.raises(ValueError):
        select_neighbors(base, pair[:, :8], valid, 8, fc)
    with pytest.raises(ValueError):
        select_neighbors(base, pair, valid, 8, fc[:, :8].contiguous())
    with pytest.raises(ValueError):
        select_neighbors(base, pair, valid.int(), 8, fc)
    with pytest.raises(ValueError):
        select_neighbors(base, pair, valid, 0, fc)
    with pytest.raises(ValueError):  # L2's Gram form needs the norms
        select_neighbors(base, Gram(pair, None, True), valid, 8, fc)
    with pytest.raises(ValueError):  # norms of another shape
        select_neighbors(base, Gram(pair, base[:, :8].contiguous(), True),
                         valid, 8, fc)


def _hop_args(case, dev, level, dtype=torch.float32, q_dtype=None):
    """gather_hop's arguments from torch_parity.gather_hop_case."""
    a = [torch.from_numpy(x).to(dev) for x in case]
    rows = a[5].to(dtype)
    return (*a[:5], level, rows, a[6].to(q_dtype or dtype))


@pytest.mark.parametrize("d", [7, 33, 128, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("metric", ["L2", "IP", "L1"])
@pytest.mark.parametrize("ef,e_sel", [(24, 4), (64, 4), (100, 1), (40, 8),
                                      (1000, 4)])
def test_gather_hop_kernel_matches_plain(dev, d, dtype, metric, ef, e_sel):
    """K6, the whole hop, against its plain version on seeded pools:
    row-aligned and unaligned rows (16-byte loads or single values), every
    metric code and value type, queries in the table's type and in f32,
    one to eight lists a row (with E > 1 in Knuth-key order, repeats
    across lists), level 0 and level 2 (m-wide lists, elements without a
    slot), listed ids past the rows, NaN, +inf, tied, fully expanded and
    empty pools, the sorts in registers and (ef 1,000) in shared memory;
    the done flags, the count of queries not done and the hop counts
    equal, also for a second hop from the first's done flags and hop
    counts."""
    case = gather_hop_case(d + ef + e_sel, 37, ef, d=d, cap=1200, levels=2)
    for level in (0, 2):
        args = _hop_args(case, dev, level, dtype,
                         torch.float32 if d == 33 else dtype)
        launches = gather_hop.launches
        out1 = gather_hop(*args, ef, e_sel, Metric[metric])
        torch.cuda.synchronize()
        assert gather_hop.launches == launches + 1
        out0 = gather_hop_plain(*args, ef, e_sel, Metric[metric])
        _assert_same_hop(out1, out0)
        done1 = out1[2]
        assert bool(done1[3]) and bool(done1[7]) and not bool(done1[0])
        state = dict(done=out0[2], hops=out0[4])
        _assert_same_hop(
            gather_hop(out0[0], out0[1], *args[2:], ef, e_sel,
                       Metric[metric], **state),
            gather_hop_plain(out0[0], out0[1], *args[2:], ef, e_sel,
                             Metric[metric], **state))


def test_gather_hop_kernel_rejects(dev):
    args = _hop_args(gather_hop_case(2, 8, 24), dev, 0)
    with pytest.raises(ValueError):  # f64 rows
        gather_hop(*args[:6], args[6].double(), args[7], 24, 4, Metric.L2)
    with pytest.raises(ValueError):  # the queries' width
        gather_hop(*args[:7], args[7][:, :8].contiguous(), 24, 4, Metric.L2)
    with pytest.raises(ValueError):  # slots for another number of elements
        gather_hop(*args[:4], args[4][:8].contiguous(), *args[5:], 24, 4,
                   Metric.L2)
    with pytest.raises(ValueError):  # a level the tables do not hold
        gather_hop(*args[:5], 2, *args[6:], 24, 4, Metric.L2)
    with pytest.raises(ValueError):  # ef + W over the sort's 4,096 lanes
        wide = args[2].repeat(1, 80)
        gather_hop(*args[:2], wide, *args[3:], 24, 4, Metric.L2)


def _walk_case(dev, d, dtype, q_dtype, metric, seed, n=3000, levels=3,
               m=16, q=300):
    """Seeded inputs of one greedy walk with small-integer values and
    queries, so every f32 distance is exact whatever the order of its sum
    and the kernel and the plain walk must agree bit for bit, ties
    included: random upper lists (some -1, some ids past the rows, some
    elements without a slot), a NaN row, starts anywhere (some at an
    element with no slot, one at -1)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    vals[17] = np.nan
    qs = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
    nbr_up = rng.integers(0, n, size=(n, levels, m)).astype(np.int32)
    nbr_up[rng.random(nbr_up.shape) < 0.1] = -1
    past = rng.random(nbr_up.shape) < 0.02
    nbr_up[past] = n + rng.integers(0, 50, size=int(past.sum()))
    nbr_up[rng.integers(0, n, size=n // 20), :, 3] = 17  # the NaN row
    up_slot = np.arange(n, dtype=np.int32)
    up_slot[rng.random(n) < 0.1] = -1
    cur = rng.integers(0, n, size=q).astype(np.int32)
    cur[0] = -1
    tv = torch.from_numpy(vals).to(dev, dtype)
    tq = torch.from_numpy(qs).to(dev, q_dtype)
    tcur = torch.from_numpy(cur).to(dev)
    safe = torch.clamp(tcur, min=0).long()
    cur_d = TD.dense_point_scores(metric, tq, tv[safe][:, None],
                                  tcur[:, None])[:, 0]
    return (tv, torch.from_numpy(nbr_up).to(dev),
            torch.from_numpy(up_slot).to(dev), tq, tcur, cur_d)


@pytest.mark.parametrize("d", [7, 33, 128, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("metric", ["L2", "IP", "L1"])
def test_greedy_walk_kernel_matches_plain(dev, d, dtype, metric):
    """K7 against its plain version on the card, on exact-integer values
    (every distance exact, so the walks agree bit for bit and ties break
    alike: the first minimum in list order): row-aligned and unaligned
    rows, every metric code and value type, queries in the table's type
    and in f32, three levels, one level, and the step cap; one launch a
    call."""
    q_dtype = torch.float32 if d == 33 else dtype
    args = _walk_case(dev, d, dtype, q_dtype, Metric[metric],
                      seed=d + len(metric))
    moved = 0
    for hi, lo, steps in ((3, 1, 512), (2, 2, 512), (3, 1, 2)):
        launches = greedy_walk.launches
        cur1, d1 = greedy_walk(*args, hi, lo, Metric[metric], steps)
        torch.cuda.synchronize()
        assert greedy_walk.launches == launches + 1
        cur0, d0 = greedy_walk_plain(*args, hi, lo, Metric[metric], steps)
        np.testing.assert_array_equal(cur1.cpu().numpy(), cur0.cpu().numpy())
        np.testing.assert_array_equal(d1.cpu().numpy(), d0.cpu().numpy())
        moved += int((cur1 != args[4]).sum())
    assert moved > len(args[4])


def test_greedy_walk_kernel_rejects(dev):
    args = _walk_case(dev, 16, torch.float32, torch.float32, Metric.L2,
                      seed=1, q=8)
    with pytest.raises(ValueError):  # f64 values
        greedy_walk(args[0].double(), *args[1:], 3, 1, Metric.L2)
    with pytest.raises(ValueError):  # the queries' width
        greedy_walk(*args[:3], args[3][:, :8].contiguous(), *args[4:], 3, 1,
                    Metric.L2)
    with pytest.raises(ValueError):  # a level the tables do not hold
        greedy_walk(*args, 4, 1, Metric.L2)
    with pytest.raises(ValueError):  # level 0 is the beam's
        greedy_walk(*args, 1, 0, Metric.L2)
    with pytest.raises(ValueError):  # int64 starts
        greedy_walk(*args[:4], args[4].long(), args[5], 3, 1, Metric.L2)


def _per_level_descend(kind, metric, values, nbr_up, up_slot, score, nbrs,
                       qs, cur, cur_d, level_hi, level_lo):
    """The descent before K7: ``greedy_descent`` a level at a time, a host
    read a step."""
    from pgvector_tpu_torch.index import hnsw_kernels

    for lc in range(level_hi, level_lo - 1, -1):
        cur, cur_d = hnsw_kernels.greedy_descent(score, nbrs, qs, cur, cur_d,
                                                 lc, max_steps=512)
    return cur, cur_d


def test_hnsw_search_descends_in_one_greedy_walk(dev, monkeypatch):
    """A dense search walks every upper level in one K7 launch, with no
    ``descent.moved`` read; its recall@10 at ef 40 is the per-level
    descent's within 0.002."""
    from pgvector_tpu_torch.index import hnsw_kernels
    from pgvector_tpu_torch.utils import telemetry

    rng = np.random.default_rng(23)
    db = rng.normal(size=(30000, 32)).astype(np.float32)
    q = rng.normal(size=(2000, 32)).astype(np.float32)
    table = DenseTable(32, device=dev)
    table.insert(db)
    idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64)
    assert idx.entry_level >= 2
    _, gt = FlatIndex(table, Metric.L2).search(q, 10)
    idx.search(q, 10, ef_search=40)  # the slab, built
    sites = {}
    real = telemetry.timers.host_read

    def count(site):
        sites[site] = sites.get(site, 0) + 1
        real(site)

    monkeypatch.setattr(telemetry.timers, "host_read", count)
    launches = greedy_walk.launches
    _, r1 = idx.search(q, 10, ef_search=40)
    assert greedy_walk.launches == launches + 1
    assert "descent.moved" not in sites and sites.get("beam.left", 0) >= 1
    monkeypatch.setattr(hnsw_kernels, "descend", _per_level_descend)
    _, r0 = idx.search(q, 10, ef_search=40)
    assert greedy_walk.launches == launches + 1
    assert sites["descent.moved"] >= idx.entry_level

    def recall(r):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r, gt)])

    assert recall(r1) >= 0.8  # 32-d gaussian rows: a hard set at ef 40
    assert abs(recall(r1) - recall(r0)) <= 0.002, (recall(r1), recall(r0))


def test_build_runs_select_and_hops_on_kernels(dev, monkeypatch):
    """A dense build, VACUUM and INSERT on the card: every select runs K3
    and every beam hop K6 (launches equal calls), and the graph matches
    the one built with the plain versions in recall."""
    from pgvector_tpu_torch.index import hnsw_kernels

    rng = np.random.default_rng(31)
    db = rng.normal(size=(4000, 32)).astype(np.float32)
    q = db[:200] + rng.normal(size=(200, 32)).astype(np.float32) * 0.05
    calls = {"select": 0, "hop": 0}
    orig_sel, orig_hop = hnsw_kernels.select_neighbors, \
        hnsw_kernels.gather_hop

    def count(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(hnsw_kernels, "select_neighbors",
                        count("select", orig_sel))
    monkeypatch.setattr(hnsw_kernels, "gather_hop", count("hop", orig_hop))
    recall = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            monkeypatch.setattr(hnsw_kernels, "select_neighbors",
                                select_neighbors_plain)
            monkeypatch.setattr(hnsw_kernels, "gather_hop", gather_hop_plain)
        table = DenseTable(32, device=dev)
        table.insert(db)
        s0, h0 = select_neighbors.launches, gather_hop.launches
        idx = HNSWIndex(table, Metric.L2, m=8, ef_construction=32,
                        wave_size=512, beam_expand=4, dedup=False)
        table.delete(np.arange(100, 400))
        idx.vacuum()
        idx.insert(table.insert(db[100:400] + 0.01))
        if route == "kernels":
            assert calls["select"] > 0 and calls["hop"] > 0
            assert select_neighbors.launches - s0 == calls["select"]
            assert gather_hop.launches - h0 == calls["hop"]
        else:
            assert select_neighbors.launches == s0
            assert gather_hop.launches == h0
        live = table.data[: table.count].cpu().numpy()
        exact = ((q[:, None, :] - live[None, :, :]) ** 2).sum(-1)
        exact[:, ~table.valid[: table.count].cpu().numpy()] = np.inf
        gt = np.argsort(exact, axis=1, kind="stable")[:, :10]
        _, r = idx.search(q, 10, ef_search=64)
        recall[route] = np.mean([len(set(a) & set(b)) / 10
                                 for a, b in zip(r, gt)])
    assert recall["kernels"] >= 0.9
    assert abs(recall["kernels"] - recall["plain"]) <= 0.02, recall


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric,k", [("L2", 100), ("IP", 100),
                                      ("COSINE", 10), ("COSINE", 100)])
def test_grouped_exact_on_card_matches_tiled(dev, dtype, metric, k,
                                             monkeypatch):
    """The grouped engine on the card (a filter, deletes) against the
    tiled scan on the card: the same ids apart from ties."""
    rng = np.random.default_rng(12)
    db = rng.normal(size=(30000, 96)).astype(np.float32)
    q = rng.normal(size=(300, 96)).astype(np.float32)
    t = DenseTable(96, dtype=dtype, device=dev)
    t.insert(db)
    t.delete(np.arange(0, 30000, 7))
    fmask = rng.random(30000) > 0.2
    monkeypatch.setenv("PGVECTOR_TPU_EXACT", "xla")
    d0, i0 = FlatIndex(t, Metric[metric]).search(q, k, filter_mask=fmask)
    monkeypatch.setenv("PGVECTOR_TPU_EXACT", "grouped")
    flat = FlatIndex(t, Metric[metric])
    d1, i1 = flat.search(q, k, filter_mask=fmask)
    assert flat.last_path == "grouped"
    assert_same_topk(d0, i0, d1, i1)


def test_table_defaults_to_the_card(dev):
    t = DenseTable(8)
    assert t.device.type == "cuda" and t.data.is_cuda and t.valid.is_cuda
    idx = HNSWIndex(t, Metric.L2, m=4, ef_construction=8, build=False,
                    dedup=False)
    assert idx.device.type == "cuda" and idx.nbr0.is_cuda


def test_flat_and_hnsw_on_cuda_match_cpu(dev, monkeypatch):
    """Exact search launches K1 on CUDA; a CPU-built graph carried to the
    card answers packed scans (K2) with the CPU's ids apart from ties."""
    rng = np.random.default_rng(8)
    db = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    cpu_t, gpu_t = DenseTable(32, device="cpu"), DenseTable(32, device=dev)
    cpu_t.insert(db)
    gpu_t.insert(db)
    launches = fused_topk.launches
    d0, i0 = FlatIndex(cpu_t, Metric.L2).search(q, 10)
    flat = FlatIndex(gpu_t, Metric.L2)
    d1, i1 = flat.search(q, 10)
    assert flat.last_path == "fused" and fused_topk.launches == launches + 1
    assert_same_topk(d0, i0, d1, i1)

    cpu_idx = HNSWIndex(cpu_t, Metric.L2, m=8, ef_construction=32,
                        wave_size=512, beam_expand=4, dedup=False)
    n, nu = cpu_idx.n_elems, cpu_idx.n_upper
    arrays = {"nbr0": cpu_idx.nbr0[:n].numpy(),
              "nbr_up": cpu_idx.nbr_up[:nu].numpy(),
              "kept0": cpu_idx.kept0[:n].numpy(),
              "kept_up": cpu_idx.kept_up[:nu].numpy(),
              "up_slot": cpu_idx.up_slot[:n], "levels": cpu_idx.levels[:n],
              "elem_rows": cpu_idx.elem_rows[:n],
              "values0": cpu_idx.values[:n].numpy()}
    meta = {"metric": "L2", "m": 8, "ef_construction": 32, "n_elems": n,
            "n_upper": nu, "nbr_up_width": cpu_idx.nbr_up.shape[1],
            "entry": cpu_idx.entry, "entry_level": cpu_idx.entry_level,
            "seed": 0, "wave_size": 512, "beam_expand": 4,
            "backlink_mode": "wholesale"}
    gpu_idx = hnsw_from_numpy(gpu_t, arrays, meta)
    for mode in ("f32", "bf16"):
        monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", mode)
        h0, r0 = cpu_idx.search(q, 10, ef_search=64)
        launches = packed_hop.launches
        h1, r1 = gpu_idx.search(q, 10, ef_search=64)
        assert packed_hop.launches == gpu_idx._last_scan_launches + launches
        assert (gpu_idx._last_scan_steps <= gpu_idx._last_scan_launches
                < gpu_idx._last_scan_steps + HOP_READ_EVERY)
        assert_same_topk(h0, r0, h1, r1)
    # a graph built on the card draws the same levels and finds the exact
    # neighbours as well as the CPU-built one
    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "auto")
    built = HNSWIndex(gpu_t, Metric.L2, m=8, ef_construction=32,
                      wave_size=512, beam_expand=4, dedup=False)
    assert built._packed_plan() == torch.float32
    np.testing.assert_array_equal(built.levels, cpu_idx.levels)

    def recall(r):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r, i0)])

    monkeypatch.setenv("PGVECTOR_TPU_PACKED_SCAN", "off")
    _, r_cpu = cpu_idx.search(q, 10, ef_search=64)
    _, r_gpu = built.search(q, 10, ef_search=64)
    assert recall(r_gpu) >= recall(r_cpu) - 0.02, (recall(r_gpu),
                                                    recall(r_cpu))


def _ivf_state(idx):
    return ({"centroids_f32": idx.centroids.cpu().numpy(),
             "list_lens": idx.list_lens, "assignments": idx.assignments},
            {"metric": idx.metric.name, "lists": idx.lists, "seed": idx.seed,
             "is_bit": False})


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_ivfflat_on_cuda_matches_cpu(dev, metric, monkeypatch):
    """A CPU-trained index carried to the card answers both probe routes,
    with deletes, a filter and an iterative scan, with the CPU's ids apart
    from ties; one built on the card finds the neighbours as well."""
    rng = np.random.default_rng(10)
    db = rng.normal(size=(20000, 32)).astype(np.float32)
    q = rng.normal(size=(300, 32)).astype(np.float32)
    cpu_t, gpu_t = DenseTable(32, device="cpu"), DenseTable(32, device=dev)
    cpu_t.insert(db)
    gpu_t.insert(db)
    cpu_t.delete(np.arange(0, 20000, 11))
    gpu_t.delete(np.arange(0, 20000, 11))
    cpu_idx = IVFFlatIndex(cpu_t, Metric[metric], lists=64, seed=1)
    gpu_idx = ivfflat_from_numpy(gpu_t, *_ivf_state(cpu_idx))
    assert gpu_idx.post_values.is_cuda and gpu_idx.centroids.is_cuda
    fmask = np.ones(20000, bool)
    fmask[::3] = False
    gucs = {"ivfflat.iterative_scan": "relaxed_order",
            "ivfflat.max_probes": 16}
    for cov, path in ((10**9, "inverted"), (0, "blocks")):
        monkeypatch.setattr(IVFFlatIndex, "INVERT_COVERAGE", cov)
        for probes, f in ((1, None), (8, None), (8, fmask)):
            with config.local(**gucs):
                d0, r0 = cpu_idx.search(q, 10, probes=probes, filter_mask=f)
                d1, r1 = gpu_idx.search(q, 10, probes=probes, filter_mask=f)
            assert gpu_idx.last_path == path
            assert_same_topk(d0, r0, d1, r1)
    monkeypatch.setattr(IVFFlatIndex, "INVERT_COVERAGE", 32)
    built = IVFFlatIndex(gpu_t, Metric[metric], lists=64, seed=1)
    assert built.centroids.is_cuda and 1 < built.kmeans_iters <= 500
    _, gt = FlatIndex(cpu_t, Metric[metric]).search(q, 10)

    def recall(r):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r, gt)])

    r_cpu = recall(cpu_idx.search(q, 10, probes=8)[1])
    r_gpu = recall(built.search(q, 10, probes=8)[1])
    assert r_gpu >= r_cpu - 0.03, (r_gpu, r_cpu)


def test_checkpoint_round_trip_on_cuda(dev, tmp_path):
    """Checkpoints written from CPU indexes load onto the card (the
    default device) and answer as the CPU indexes do."""
    rng = np.random.default_rng(12)
    db = rng.normal(size=(6000, 16)).astype(np.float32)
    q = rng.normal(size=(50, 16)).astype(np.float32)
    cpu_t = DenseTable(16, device="cpu")
    cpu_t.insert(db)
    ivf = IVFFlatIndex(cpu_t, Metric.L2, lists=16, seed=1)
    hnsw = HNSWIndex(cpu_t, Metric.L2, m=8, ef_construction=32,
                     wave_size=512, beam_expand=4, dedup=False)
    checkpoint.save_table(cpu_t, str(tmp_path / "t"))
    checkpoint.save_ivfflat(ivf, str(tmp_path / "i"))
    checkpoint.save_hnsw(hnsw, str(tmp_path / "h"))
    gpu_t = checkpoint.load_table(str(tmp_path / "t"))
    assert gpu_t.data.is_cuda
    gpu_ivf = checkpoint.load_ivfflat(gpu_t, str(tmp_path / "i"))
    assert gpu_ivf.post_values.is_cuda
    d0, r0 = ivf.search(q, 10, probes=4)
    d1, r1 = gpu_ivf.search(q, 10, probes=4)
    assert_same_topk(d0, r0, d1, r1)
    gpu_hnsw = checkpoint.load_hnsw(gpu_t, str(tmp_path / "h"))
    assert gpu_hnsw.nbr0.is_cuda
    h0, g0 = hnsw.search(q, 10, ef_search=64)
    h1, g1 = gpu_hnsw.search(q, 10, ef_search=64)
    assert_same_topk(h0, g0, h1, g1)
    # the card's index saves as well as loads
    checkpoint.save_ivfflat(gpu_ivf, str(tmp_path / "i2"))
    again = checkpoint.load_ivfflat(cpu_t, str(tmp_path / "i2"))
    np.testing.assert_array_equal(again.postings, ivf.postings)


def test_kmeans_generator_on_the_table_device(dev):
    """k-means draws from a generator on the data's device: the card's
    k-means++ seeding repeats exactly for one seed, and the trained
    centers stay on the card."""
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.normal(size=(5000, 16)), dtype=torch.float32,
                     device=dev)
    g = ivf_kmeans.make_generator(3, dev)
    assert g.device.type == "cuda"
    a = ivf_kmeans._kmeanspp_init(x, ivf_kmeans.make_generator(3, dev), 32,
                                  False)
    b = ivf_kmeans._kmeanspp_init(x, ivf_kmeans.make_generator(3, dev), 32,
                                  False)
    assert a.is_cuda and torch.equal(a, b)
    centers, iters = ivf_kmeans.train_centers(x, 32, seed=3)
    assert centers.is_cuda and iters >= 1
    assert torch.isfinite(centers).all()


def test_hnsw_defaults_build_on_the_card(dev):
    """``HNSWIndex(table, Metric.L2)`` with no other argument — heap-TID
    dedup on, wholesale backlinks — builds on the card and finds the
    neighbours; duplicate rows share one element."""
    rng = np.random.default_rng(14)
    db = rng.normal(size=(4000, 16)).astype(np.float32)
    db[3000:3100] = db[:100]
    q = rng.normal(size=(100, 16)).astype(np.float32)
    t = DenseTable(16)
    t.insert(db)
    idx = HNSWIndex(t, Metric.L2)
    assert idx.dedup and idx.nbr0.is_cuda and idx.live_elements == 3900
    assert idx.row_to_elem[3000] == idx.row_to_elem[0]
    _, gt = FlatIndex(t, Metric.L2).search(q, 10)
    _, r = idx.search(q, 10, ef_search=64)
    assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r, gt)]) >= 0.95


def test_hnsw_live_on_cuda_matches_cpu(dev, tmp_path):
    """A graph built on the card, and the same graph carried to the CPU:
    iterative scans answer alike (same ids apart from ties, same rounds),
    and a vacuum after the same deletes frees the same slots, leaves no
    freed id in any list and repairs the lists alike."""
    rng = np.random.default_rng(15)
    db = rng.normal(size=(5000, 16)).astype(np.float32)
    q = rng.normal(size=(64, 16)).astype(np.float32)
    gpu_t, cpu_t = DenseTable(16, device=dev), DenseTable(16, device="cpu")
    gpu_t.insert(db)
    cpu_t.insert(db)
    gpu_idx = HNSWIndex(gpu_t, Metric.L2, m=8, ef_construction=32,
                        wave_size=512)
    checkpoint.save_hnsw(gpu_idx, str(tmp_path))
    cpu_idx = checkpoint.load_hnsw(cpu_t, str(tmp_path))
    fmask = np.zeros(gpu_t.capacity, bool)
    fmask[::25] = True
    for mode in ("relaxed_order", "strict_order"):
        with config.local(**{"hnsw.iterative_scan": mode}):
            d0, r0 = cpu_idx.search(q, 10, ef_search=20, filter_mask=fmask)
            d1, r1 = gpu_idx.search(q, 10, ef_search=20, filter_mask=fmask)
        assert_same_topk(d0, r0, d1, r1)
        assert gpu_idx._last_scan_rounds == cpu_idx._last_scan_rounds
        assert fmask[r1[r1 >= 0]].all()
    dead = np.arange(0, 5000, 7)
    for t, idx in ((gpu_t, gpu_idx), (cpu_t, cpu_idx)):
        t.delete(dead)
        idx.vacuum()
    n = gpu_idx.n_elems
    assert gpu_idx.free_slots == cpu_idx.free_slots
    assert len(gpu_idx.free_slots) == len(dead)
    assert (gpu_idx.entry, gpu_idx.entry_level) == (cpu_idx.entry,
                                                    cpu_idx.entry_level)
    np.testing.assert_array_equal(gpu_idx.elem_rows[:n], cpu_idx.elem_rows[:n])
    assert gpu_idx.last_vacuum == cpu_idx.last_vacuum
    g0, c0 = gpu_idx.nbr0[:n].cpu().numpy(), cpu_idx.nbr0[:n].numpy()
    assert not np.isin(g0, gpu_idx.free_slots).any()
    live = np.flatnonzero(gpu_idx.levels[:n] >= 0)
    shared = [len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
              for a, b in zip(g0[live], c0[live])]
    assert np.mean(shared) >= 0.95
    _, gt = FlatIndex(cpu_t, Metric.L2).search(q, 10)
    _, r0 = cpu_idx.search(q, 10, ef_search=64)
    _, r1 = gpu_idx.search(q, 10, ef_search=64)
    assert not np.isin(r1, dead).any()

    def recall(r):
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r, gt)])

    assert recall(r1) >= recall(r0) - 0.02 and recall(r1) >= 0.9


def test_fused_topk_at_4096_dims(dev):
    """K1 at the densified sparse scans' width: (Q, 4,096) queries against
    (tile, 4,096) rows of a few non-zeros each, within its bound."""
    rng = np.random.default_rng(4096)
    n, nq, d = 9000, 300, 4096
    db = np.zeros((n, d), np.float32)
    cols = rng.integers(0, d, size=(n, 32))
    db[np.arange(n)[:, None], cols] = rng.random((n, 32))
    q = np.zeros((nq, d), np.float32)
    q[np.arange(nq)[:, None], rng.integers(0, d, size=(nq, 32))] = \
        rng.random((nq, 32))
    db, q = torch.tensor(db, device=dev), torch.tensor(q, device=dev)
    for ip in (False, True):
        dbsq = torch.zeros(n, device=dev) if ip else (db * db).sum(1)
        for k in (10, 64):
            d1, i1 = fused_topk(q, db, dbsq, k)
            d0, i0 = fused_topk_plain(q, db, dbsq, k)
            bound = k1_error_bound(q, db, dbsq, i0, i1).cpu().numpy()
            assert_same_topk(d0.cpu(), i0.cpu(), d1.cpu(), i1.cpu(),
                             atol=bound, rtol=0.0)


def _words(rng, n, bits, dev, p=0.5):
    return TD.pack_bits(rng.random((n, bits)) < p).to(dev)


@pytest.mark.parametrize("bits", [20, 100, 128, 3200, 3210, 64000])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", ["HAMMING", "JACCARD"])
def test_bit_topk_kernel_equals_plain(dev, metric, k, bits):
    """K4 against its plain version: the same ids and bitwise-equal
    distances (integer popcounts; Jaccard's division rounds the same),
    ties (everywhere at 20 and 128 bits) to the lower row.  Widths of 1,
    4, 100 and 101 words (16-word chunks: ragged ones, 16-byte and 4-byte
    loads) up to 64,000 bits (BITVEC_MAX_DIM); a ragged query tile (131)
    and a ragged last row tile; all-zero rows and queries (Jaccard's empty
    ∩ empty → 1); dead rows; several row splits; and a filter that leaves
    fewer than k rows (none at k = 1)."""
    rng = np.random.default_rng(bits + k)
    n, nq = (30011, 131) if bits <= 3210 else (2311, 131)
    db = _words(rng, n, bits, dev)
    db[100:200] = db[:100]
    db[7] = 0
    db[n - 1] = 0
    qs = _words(rng, nq, bits, dev)
    qs[0] = 0
    qs[nq - 1] = db[5]
    valid = torch.tensor(rng.random(n) > 0.1, device=dev)
    valid[7] = valid[n - 1] = True
    few = torch.zeros(n, dtype=torch.bool, device=dev)
    few[torch.tensor(rng.choice(n, k // 2, replace=False), device=dev)] = True
    for mask in (valid, few):
        launches = bit_topk.launches
        d1, i1 = bit_topk(Metric[metric], qs, db, k, mask)
        torch.cuda.synchronize()
        assert bit_topk.launches == launches + 1
        d0, i0 = bit_topk_plain(Metric[metric], qs, db, k, mask)
        assert torch.equal(i1, i0) and torch.equal(d1, d0)
    assert (i1 < 0).sum() == nq * (k - k // 2)  # the filter's short lists


@pytest.mark.parametrize("bits", [20, 128, 224, 3200])
@pytest.mark.parametrize("metric", ["HAMMING", "JACCARD"])
def test_bit_point_scores_kernel_equals_plain(dev, metric, bits):
    """K5 against its plain version, bitwise, with -1 ids; 224 bits (7
    words) takes the word-by-word loads."""
    rng = np.random.default_rng(bits)
    table = _words(rng, 5000, bits, dev)
    qs = _words(rng, 700, bits, dev)
    rows = torch.tensor(rng.integers(0, 5000, size=(700, 256)),
                        dtype=torch.int32, device=dev)
    rows[:, ::5] = -1
    launches = bit_point_scores.launches
    d1 = bit_point_scores(Metric[metric], qs, table, rows)
    torch.cuda.synchronize()
    assert bit_point_scores.launches == launches + 1
    d0 = bit_point_scores_plain(Metric[metric], qs, table, rows)
    assert torch.equal(d1, d0)


def test_bit_kernels_reject(dev):
    qs = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    db = torch.zeros((10, 2), dtype=torch.int32, device=dev)
    ok = torch.ones(10, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        bit_topk(Metric.HAMMING, qs, db, 65, ok)
    with pytest.raises(ValueError):  # popcounts of another table
        bit_topk(Metric.JACCARD, qs, db, 5, ok,
                 torch.zeros(9, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        bit_point_scores(Metric.L2, qs, db, torch.zeros((4, 3),
                                                        dtype=torch.int32,
                                                        device=dev))


def _graph_state(idx):
    n, nu = idx.n_elems, idx.n_upper
    arrays = {"nbr0": idx.nbr0[:n].numpy(), "nbr_up": idx.nbr_up[:nu].numpy(),
              "kept0": idx.kept0[:n].numpy(),
              "kept_up": idx.kept_up[:nu].numpy(),
              "up_slot": idx.up_slot[:n], "levels": idx.levels[:n],
              "elem_rows": idx.elem_rows[:n]}
    for j, v in enumerate(idx._value_arrays()):
        arrays[f"values{j}"] = v[:n].numpy()
    meta = {"metric": idx.metric.name, "m": idx.m, "kind": idx.kind,
            "ef_construction": idx.ef_construction, "n_elems": n,
            "n_upper": nu, "nbr_up_width": idx.nbr_up.shape[1],
            "entry": idx.entry, "entry_level": idx.entry_level, "seed": 0,
            "wave_size": idx.wave_size, "beam_expand": idx.beam_expand,
            "backlink_mode": "wholesale", "dedup": idx.dedup}
    return arrays, meta


def test_bit_indexes_on_cuda_match_cpu(dev):
    """Bit exact search (K4), a CPU-built Hamming graph carried to the card
    (K5 hops), bit IVFFlat and a binary-quantized index, against the CPU."""
    rng = np.random.default_rng(12)
    bits = rng.random((8000, 256)) < 0.4
    q = rng.random((50, 256)) < 0.4
    cpu_t, gpu_t = BitTable(256, device="cpu"), BitTable(256, device=dev)
    cpu_t.insert(bits)
    gpu_t.insert(bits)
    for metric in ("HAMMING", "JACCARD"):
        launches = bit_topk.launches
        d0, i0 = FlatIndex(cpu_t, Metric[metric]).search(q, 10)
        d1, i1 = FlatIndex(gpu_t, Metric[metric]).search(q, 10)
        assert bit_topk.launches == launches + 1
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(i1, i0)
        cpu_idx = HNSWIndex(cpu_t, Metric[metric], m=8, ef_construction=32,
                            wave_size=512, beam_expand=4)
        gpu_idx = hnsw_from_numpy(gpu_t, *_graph_state(cpu_idx))
        launches = bit_point_scores.launches
        h0, r0 = cpu_idx.search(q, 10, ef_search=40)
        h1, r1 = gpu_idx.search(q, 10, ef_search=40)
        assert bit_point_scores.launches > launches
        assert_same_topk(h0, r0, h1, r1, atol=0.0, rtol=0.0)
        built = HNSWIndex(gpu_t, Metric[metric], m=8, ef_construction=32,
                          wave_size=512, beam_expand=4)
        np.testing.assert_array_equal(built.levels, cpu_idx.levels)
        _, rb = built.search(q, 10, ef_search=40)
        hit = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(rb, i0)])
        hit0 = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r0, i0)])
        assert hit >= hit0 - 0.03, (hit, hit0)
    cpu_ivf = IVFFlatIndex(cpu_t, Metric.HAMMING, lists=16, seed=1)
    state = ({"centroids_f32": cpu_ivf.centroids.numpy(),
              "list_lens": cpu_ivf.list_lens,
              "assignments": cpu_ivf.assignments},
             {"metric": "HAMMING", "lists": 16, "seed": 1, "is_bit": True})
    gpu_ivf = ivfflat_from_numpy(gpu_t, *state)
    for probes in (1, 16):
        d0, r0 = cpu_ivf.search(q, 10, probes=probes)
        d1, r1 = gpu_ivf.search(q, 10, probes=probes)
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(r1, r0)
    dense = rng.normal(size=(6000, 64)).astype(np.float32)
    dq = rng.normal(size=(20, 64)).astype(np.float32)
    bq = {}
    for where in ("cpu", dev):
        t = DenseTable(64, device=where)
        t.insert(dense)
        bq[str(where)] = BinaryQuantizedIndex(
            t, m=8, ef_construction=32, wave_size=512,
            beam_expand=4).search(dq, 10, ef_search=80)
    assert_same_topk(*bq["cpu"], *bq[str(dev)])


def _densify(vecs, dim):
    out = np.zeros((len(vecs), dim), np.float32)
    for r, sv in enumerate(vecs):
        out[r, sv.indices] = sv.values
    return out


def _f32_l2_bound(qs, db, width, *ids):
    """2e of ops/fused_topk's derivation with sums over ``width`` terms:
    two f32 evaluations of |q|² + |x|² - 2 q·x, one on each device."""
    u = 2.0 ** -24
    qsq = (qs * qs).sum(1, keepdim=True)
    out = torch.zeros(ids[0].shape)
    for t in ids:
        t = torch.as_tensor(np.asarray(t)).long()
        rows = db[t.clamp(min=0)]
        s_abs = torch.einsum("qd,qkd->qk", qs.abs(), rows.abs())
        e = 2 * u * ((width + 2) * (qsq + (rows * rows).sum(-1))
                     + (2 * width + 4) * s_abs)
        out = torch.maximum(out, torch.where(t >= 0, e, 0.0))
    return out


@pytest.mark.parametrize("dim", [64, 128])
def test_flat_self_match_on_cuda_matches_cpu(dev, dim):
    """FlatIndex on the K1 route with queries that are stored rows (the
    near-duplicate lookup), the card against the CPU within the bounds
    derived from K1's: L2 roots within l2_root_bound over
    k1_l2_error_bound, inner products within k1_error_bound / 2.  Ten rows
    are stored twice, so some self-matches tie at zero."""
    rng = np.random.default_rng(31 + dim)
    n = 6000
    db = (rng.normal(size=(n, dim)) * 2).astype(np.float32)
    db[10:20] = db[:10]
    pick = np.concatenate([np.arange(0, 20, 2),
                           rng.choice(np.arange(20, n), 30, replace=False)])
    q = db[pick]
    cpu_t, gpu_t = DenseTable(dim, device="cpu"), DenseTable(dim, device=dev)
    cpu_t.insert(db)
    gpu_t.insert(db)
    qt, dbt = torch.as_tensor(q), torch.as_tensor(db)
    for metric in ("L2", "IP"):
        d0, i0 = FlatIndex(cpu_t, Metric[metric]).search(q, 10)
        flat = FlatIndex(gpu_t, Metric[metric])
        launches = fused_topk.launches
        d1, i1 = flat.search(q, 10)
        assert flat.last_path == "fused"
        assert fused_topk.launches == launches + 1
        if metric == "L2":
            atol = l2_root_bound(k1_l2_error_bound(qt, dbt, i0, i1), d0)
            # each query's own row (or the row stored twice) comes first
            first = i1[:, 0]
            assert (np.where(pick < 20, first % 10, first)
                    == np.where(pick < 20, pick % 10, pick)).all()
        else:
            atol = k1_error_bound(qt, dbt, torch.zeros(n), i0, i1) / 2
        assert_same_topk(d0, i0, d1, i1, atol=atol.numpy(), rtol=0.0)


def test_sparse_indexes_on_cuda_match_cpu(dev, monkeypatch):
    """Sparse exact search on its three routes, and a CPU-built sparse
    inner-product graph carried to the card, against the CPU."""
    rng = np.random.default_rng(13)
    dim, n = 512, 6000
    rows = []
    for _ in range(n + 20):
        c = np.sort(rng.choice(dim, rng.integers(1, 17), replace=False))
        rows.append(SparseVec(dim, c, rng.random(len(c)) + 0.1))
    # queries apart from the rows, and ten equal to stored rows (L2 near
    # zero: held by the root bound below)
    rows, q = rows[:n], (rows[n:] + rows[:10]
                         + [SparseVec(dim, [1, 5, 9], [1.0, 2.0, 3.0])])
    dense_q, dense_x = (torch.tensor(_densify(v, dim)) for v in (q, rows))
    cpu_t = SparseTable(dim, nnz_cap=16, device="cpu")
    gpu_t = SparseTable(dim, nnz_cap=16, device=dev)
    cpu_t.insert(rows)
    gpu_t.insert(rows)
    routes = {"densified": {},
              "densified-tile": {"PGVECTOR_TPU_SPARSE_DENSIFY_GB": "0"},
              "merge-join": {"PGVECTOR_TPU_SPARSE_DENSIFY_GB": "0",
                             "PGVECTOR_TPU_SPARSE_TILE_BYTES": "1024"}}
    for route, env in routes.items():
        for k_, v in env.items():
            monkeypatch.setenv(k_, v)
        for metric in ("L2", "IP", "COSINE"):
            d0, i0 = FlatIndex(cpu_t, Metric[metric]).search(q, 10)
            flat = FlatIndex(gpu_t, Metric[metric])
            d1, i1 = flat.search(q, 10)
            assert flat.last_path.startswith(route), flat.last_path
            if metric != "L2":
                assert_same_topk(d0, i0, d1, i1)
                continue
            # K1 on the densified routes; the merge join evaluates
            # |q|² + |x|² - 2 q·x in f32 over the 16 stored entries
            e = (_f32_l2_bound(dense_q, dense_x, 16, i0, i1)
                 if route == "merge-join"
                 else k1_l2_error_bound(dense_q, dense_x, i0, i1))
            assert_same_topk(d0, i0, d1, i1,
                             atol=l2_root_bound(e, d0).numpy(), rtol=0.0)
    cpu_idx = HNSWIndex(cpu_t, Metric.IP, m=8, ef_construction=32,
                        wave_size=256, beam_expand=4)
    gpu_idx = hnsw_from_numpy(gpu_t, *_graph_state(cpu_idx))
    h0, r0 = cpu_idx.search(q, 10, ef_search=40)
    h1, r1 = gpu_idx.search(q, 10, ef_search=40)
    assert_same_topk(h0, r0, h1, r1)
    built = HNSWIndex(gpu_t, Metric.IP, m=8, ef_construction=32,
                      wave_size=256, beam_expand=4)
    np.testing.assert_array_equal(built.levels, cpu_idx.levels)


def test_calibrated_pick_is_fastest_on_card(dev):
    """On the card the calibrated pick is within the timed runs' spread
    of the fastest path (the smoke's phase 10 does this at 1M rows)."""
    from pgvector_tpu_torch import planner as TPL

    rng = np.random.default_rng(19)
    db = rng.normal(size=(48_000, 24)).astype(np.float32)
    t = DenseTable(24, device=dev)
    t.insert(db)
    h = HNSWIndex(t, Metric.L2, m=8, ef_construction=32, wave_size=1024,
                  beam_expand=4)
    q = db[:512] + 0.01
    cal = TPL.calibrate(t, [h], Metric.L2, q, k=10, sizes=(32, 256),
                        ef_search=40)
    pick = TPL.choose_path(t, [h], Metric.L2, calibration=cal, q_count=512)
    flat = FlatIndex(t, Metric.L2)
    runs = {"exact": lambda: flat.search(q, 10),
            "hnsw": lambda: h.search(q, 10, ef_search=40)}
    times = {}
    for kind, fn in runs.items():
        fn()
        times[kind] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
    spread = max(max(v) / min(v) for v in times.values())
    best = min(min(v) for v in times.values())
    assert min(times[pick.kind]) <= best * spread, (pick.kind, times)


# ---------------------------------------------------------------------------
# the mesh paths on the card: four shards of cuda:0, and two cards
# ---------------------------------------------------------------------------


def _graphs_equal(a, b):
    for name in ("nbr0", "nbr_up", "kept0", "kept_up"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.levels, b.levels)
    assert (a.entry, a.entry_level) == (b.entry, b.entry_level)


def test_sharded_exact_on_card_matches_flat(dev):
    """Four shards of 5,000 rows on one card, each through K1 (one launch
    a shard), answer as FlatIndex does over the whole table."""
    from pgvector_tpu_torch import parallel as TP

    rng = np.random.default_rng(20)
    db = rng.normal(size=(20_000, 64)).astype(np.float32)
    q = rng.normal(size=(100, 64)).astype(np.float32)
    t = DenseTable(64, device=dev)
    t.insert(db)
    t.delete([5, 7001])
    mesh = TP.make_mesh(4, devices=[dev] * 4)
    for metric in (Metric.L2, Metric.IP):
        e_d, e_i = FlatIndex(t, metric).search(q, 10)
        launches = fused_topk.launches
        d, i = TP.ShardedFlatIndex(mesh, t, metric).search(q, 10)
        assert fused_topk.launches == launches + 4
        assert_same_topk(e_d, e_i, d, i)
        assert not np.isin(i, [5, 7001]).any()


def test_mesh_build_on_card_bit_identical(dev):
    """The mesh build on [cuda:0] * 4 (waves of 1,024: 256 queries a
    device) gives the single-device graph bit for bit, dense and bit; the
    2 × 2 fan-out of a device-sharded index equals its 1-D search."""
    from pgvector_tpu_torch import parallel as TP

    rng = np.random.default_rng(21)
    mesh = TP.make_mesh(4, devices=[dev] * 4)
    dense = DenseTable(32, device=dev)
    dense.insert(rng.normal(size=(3000, 32)).astype(np.float32))
    bits = BitTable(256, device=dev)
    bits.insert(rng.random((3000, 256)) > 0.5)
    for table, metric in ((dense, Metric.L2), (bits, Metric.HAMMING)):
        kw = dict(m=16, ef_construction=64, wave_size=1024, dedup=False,
                  seed=3)
        one = HNSWIndex(table, metric, **kw)
        par = HNSWIndex(table, metric, build_mesh=mesh, **kw)
        _graphs_equal(one, par)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    kw = dict(m=8, ef_construction=32, wave_size=256, seed=4)
    base = TP.DeviceShardedHNSWIndex(TP.make_mesh(2, devices=[dev] * 2),
                                     dense, Metric.L2, **kw)
    fan = TP.DeviceShardedHNSWIndex(TP.make_mesh2(2, 2, devices=[dev] * 4),
                                    dense, Metric.L2, qaxis="qp", **kw)
    d1, r1 = base.search(q, 10, ef_search=40)
    d2, r2 = fan.search(q, 10, ef_search=40)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(d1, d2)


def test_two_card_mesh(dev):
    """A mesh over two cards answers as two shards of one card (the
    sharded exact search, the device-sharded HNSW and IVFFlat indexes),
    and its mesh build gives the single-device graph."""
    from pgvector_tpu_torch import parallel as TP

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(22)
    db = rng.normal(size=(12_000, 32)).astype(np.float32)
    q = rng.normal(size=(50, 32)).astype(np.float32)
    t = DenseTable(32, device=dev)
    t.insert(db)
    two = TP.make_mesh(2)
    one = TP.make_mesh(2, devices=[dev] * 2)
    d1, i1 = TP.sharded_exact_search(one, Metric.L2, t.data[: t.count], q, 10)
    d2, i2 = TP.sharded_exact_search(two, Metric.L2, t.data[: t.count], q, 10)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    kw = dict(m=8, ef_construction=32, wave_size=512, dedup=False, seed=5)
    _graphs_equal(HNSWIndex(t, Metric.L2, **kw),
                  HNSWIndex(t, Metric.L2, build_mesh=two, **kw))
    for cls, opts, search in (
            (TP.DeviceShardedHNSWIndex,
             dict(m=8, ef_construction=32, wave_size=512, seed=6),
             dict(ef_search=40)),
            (TP.DeviceShardedIVFFlatIndex, dict(lists=16, seed=6),
             dict(probes=4))):
        a = cls(one, t, Metric.L2, **opts)
        b = cls(two, t, Metric.L2, **opts)
        assert b.subs[1].device == torch.device("cuda", 1)
        d1, r1 = a.search(q, 10, **search)
        d2, r2 = b.search(q, 10, **search)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)
