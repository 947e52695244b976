"""The traffic pools and tables repeat exactly from a seed."""

import numpy as np
import torch

from vecbench import data, searches
from vecbench.session import Context


def test_make_data_repeats_from_a_seed():
    for seed in (0, 2**31 + 11, -5, 2**40):
        a = data.make_data(500, 64, 16, seed, "cpu")
        b = data.make_data(500, 64, 16, seed, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = data.make_data(500, 64, 16, 1, "cpu")
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])


def test_queries_do_not_depend_on_the_table_size():
    _, q1 = data.make_data(500, 64, 16, 3, "cpu")
    _, q2 = data.make_data(900, 64, 16, 3, "cpu")
    assert torch.equal(q1, q2)


def test_column_type_rounds_once():
    r32, q32 = data.make_data(300, 8, 24, 9, "cpu")
    r16, q16 = data.make_data(300, 8, 24, 9, "cpu", torch.float16)
    assert r16.dtype == torch.float16
    assert torch.equal(r32.to(torch.float16), r16)
    assert torch.equal(q32.to(torch.float16), q16)


def test_pool_of_a_cell_repeats(tiny):
    cell = tiny("sift1m.hnsw.ef40")
    pools = [searches.pool(Context(cell, 2**31 + 3, "cpu", 0.0))
             for _ in range(2)]
    (r1, b1, h1), (r2, b2, h2) = pools
    assert torch.equal(r1, r2)
    assert len(b1) == cell.workload["pool_batches"]
    assert all(b.shape == (64, cell.config["dim"]) for b in b1)
    assert all(np.array_equal(x, y) for x, y in zip(h1, h2))
    assert all(np.array_equal(b.numpy(), h) for b, h in zip(b1, h1))


def test_fp16_pool_is_handed_over_as_fp16(tiny):
    cell = tiny("gist960.hnsw.ef40")
    rows, batches, host = searches.pool(Context(cell, 7, "cpu", 0.0))
    assert rows.dtype == torch.float16 and host[0].dtype == np.float16


def test_judged_sample_repeats_from_a_seed(tiny):
    cell = tiny("sift1m.exact")
    cell.workload.update(judge_rate=0.3, judge_max=50)
    picks = []
    for _ in range(2):
        take = Context(cell, 12345, "cpu", 0.0).sampler()
        picks.append([take() for _ in range(100)])
    assert picks[0] == picks[1] and 0 < sum(picks[0]) <= 50
