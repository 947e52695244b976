"""The plain reference against brute force in numpy, and the judge's
numbers on answers made wrong on purpose."""

import numpy as np
import pytest
import torch

from vecbench import peaks, reference
from vecbench.judge import Answer, bad_entries, judge


def brute(rows, qs, k):
    d = np.sqrt(((qs[:, None, :].astype(np.float64)
                  - rows[None, :, :].astype(np.float64)) ** 2).sum(-1))
    order = np.lexsort((np.broadcast_to(np.arange(len(rows)), d.shape), d),
                       axis=1)[:, :k]
    return np.take_along_axis(d, order, 1), order


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_topk_against_brute_force(dtype):
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(3000, 12, generator=g).to(dtype)
    qs = torch.randn(50, 12, generator=g).to(dtype)
    d, i = reference.topk(rows, qs, 10, r_block=700, q_block=16)
    bd, bi = brute(rows.float().numpy(), qs.float().numpy(), 10)
    assert np.array_equal(i.numpy(), bi)
    assert np.allclose(d.numpy(), bd, rtol=1e-6, atol=1e-6)


def test_topk_ties_go_to_the_lower_row():
    g = torch.Generator().manual_seed(1)
    base = torch.randn(40, 8, generator=g)
    rows = torch.cat([base, base, base])  # each row three times
    qs = base[:5] + 0.01
    d, i = reference.topk(rows, qs, 6, r_block=50)
    bd, bi = brute(rows.numpy(), qs.numpy(), 6)
    assert np.array_equal(i.numpy(), bi)
    assert (i[:, 0] < 40).all() and (i[:, 1] == i[:, 0] + 40).all()


def test_dist_of_marks_ids_out_of_range():
    rows = torch.arange(12.0).reshape(6, 2)
    qs = torch.zeros(2, 2)
    ids = torch.tensor([[0, 5, -1], [6, 1, 2]])
    d = reference.dist_of(rows, qs, ids)
    assert torch.isnan(d[0, 2]) and torch.isnan(d[1, 0])
    assert d[0, 1] == pytest.approx(float(np.hypot(10, 11)))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 1.0 + 2**-12,
                      -3.0 - 2**-9])
    r = reference.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]


@pytest.mark.parametrize("precision", ["tf32", "bf16", "int8"])
def test_lower_precision_moves_the_distances(precision):
    g = torch.Generator().manual_seed(2)
    rows = torch.randn(2000, 32, generator=g)
    qs = torch.randn(20, 32, generator=g)
    d0, _ = reference.topk(rows, qs, 10)
    d1, _ = reference.topk(rows, qs, 10, precision=precision)
    gap = ((d1 - d0).abs() / d0[:, -1:]).max()
    assert 1e-5 < gap < 0.1


def test_bad_entries():
    d = np.array([[1.0, 2.0, 3.0], [1.0, 0.5, 2.0], [1.0, np.inf, 2.0]])
    i = np.array([[0, 1, 1], [2, 3, 4], [5, 6, 9]])
    bad = bad_entries(d, i, n=9)
    assert bad.tolist() == [[False, False, True], [False, True, False],
                            [False, True, True]]


def _answers(rows, qs, k):
    d, i = reference.topk(rows, qs, k)
    return d.numpy().copy(), i.numpy().copy()


def test_judge_numbers():
    g = torch.Generator().manual_seed(3)
    rows = torch.randn(1500, 16, generator=g)
    qs = torch.randn(30, 16, generator=g)
    limits = {"dist_err": 1e-5, "rank_gap": 1e-5}
    d, i = _answers(rows, qs, 10)
    v = judge([Answer(0, d, i)], [qs], rows, 1500, 10, limits, exact=True,
              recall_floor=0.9)
    assert v.correct and v.recall == 1.0 and v.numbers["bad_ids"] == 0
    # an id altered where it is produced: its distance no longer matches
    d2, i2 = d.copy(), i.copy()
    i2[3, 4] = (i2[3, 4] + 1) % 1500
    v = judge([Answer(0, d2, i2)], [qs], rows, 1500, 10, limits, exact=True)
    assert not v.correct and v.numbers["dist_err"] > 1e-3
    assert v.failed_answers == 1
    # the second half of the batch left out
    d3, i3 = d.copy(), i.copy()
    d3[15:], i3[15:] = np.inf, -1
    v = judge([Answer(0, d3, i3)], [qs], rows, 1500, 10, limits,
              exact=False, recall_floor=0.9)
    assert not v.correct and v.numbers["bad_ids"] == 150
    assert v.numbers["recall"] == pytest.approx(0.5)
    # the 11th nearest in place of the 10th, its own distance given
    d11, i11 = _answers(rows, qs, 11)
    d4, i4 = d.copy(), i.copy()
    d4[:, 9], i4[:, 9] = d11[:, 10], i11[:, 10]
    v = judge([Answer(0, d4, i4)], [qs], rows, 1500, 10, limits, exact=True)
    assert v.numbers["dist_err"] < 1e-6 and v.numbers["rank_gap"] > 1e-5
    assert not v.correct


def test_k1_work_count():
    flops, nbytes = peaks.exact_scan_work(1000, 1_000_000, 128, 10)
    assert flops == 2 * 1000 * 1_000_000 * 128
    assert nbytes == 4 * (1000 * 128 + 1_000_000 * 129) + 8 * 1000 * 10
    t, by = peaks.bound_s(nbytes, flops)
    assert by == "operations" and t == pytest.approx(1.5515e-3, rel=1e-4)
