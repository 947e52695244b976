"""The port's CUDA kernels on the card: K1 (fused top-k) and K2 (hop tail)
against their plain PyTorch versions, and the HNSW scan on CUDA against
the same scan on the CPU.  Every test needs an NVIDIA Hopper GPU and
``nvcc`` (the kernels build at first use) and skips elsewhere.

On the card (which has no JAX; ``--noconftest`` skips tests/conftest.py,
which configures JAX for the reference's tests):

    python -m pytest --noconftest -p no:cacheprovider -m cuda -q \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu_torch import DenseTable, FlatIndex, HNSWIndex, Metric  # noqa: E402
from pgvector_tpu_torch.io.convert import hnsw_from_numpy  # noqa: E402
from pgvector_tpu_torch.ops.fused_topk import (  # noqa: E402
    fused_topk, fused_topk_plain)
from pgvector_tpu_torch.ops.hop_tail import (  # noqa: E402
    MAX_WIDTH, hop_tail, hop_tail_plain)
from torch_parity import assert_same_topk  # noqa: E402

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
    assert_same_topk(d0.cpu(), i0.cpu(), d1.cpu(), i1.cpu())
    assert i1.dtype == torch.int32


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


@pytest.mark.parametrize("ef,w", [(8, 24), (40, 256), (100, 256),
                                  (1000, 256), (1000, 3000)])
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


def test_flat_and_hnsw_on_cuda_match_cpu(dev, monkeypatch):
    """Exact search launches K1 on CUDA; a CPU-built graph carried to the
    card answers packed scans (K2) with the CPU's ids apart from ties."""
    rng = np.random.default_rng(8)
    db = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    cpu_t, gpu_t = DenseTable(32), DenseTable(32, device=dev)
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
        launches = hop_tail.launches
        h1, r1 = gpu_idx.search(q, 10, ef_search=64)
        assert hop_tail.launches > launches
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
