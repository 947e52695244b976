"""The comparison that decides ``correct``.

Each judged answer is one request's (distances, ids) for one batch of the
query pool.  The reference gives the exact top-k of that batch over the
rows the system held, and the f32 distance of every id the answer names.
The numbers compared:

- ``bad_ids``: entries that name no row the system held, name a row twice
  in one answer, carry a distance that is not finite, or stand out of
  distance order; exact, limit 0.
- ``dist_err``: the largest gap between a returned distance and the
  reference's distance of the same id, over the query's reference k-th
  distance.  A wrong id, or a distance computed in a lower precision,
  shows here.
- ``rank_gap`` (exact search): the largest gap between the j-th returned
  row's reference distance and the reference's j-th distance, over the
  k-th: rows that are not the nearest, beyond ties.
- ``recall``: the share of the reference's top-k that the first answer to
  each batch holds, over the pool; held to the floor the configuration
  states for an approximate index.
- ``missing_rows`` (index builds): rows acknowledged as inserted that the
  index does not hold; exact, limit 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import reference


@dataclass
class Answer:
    batch: int
    dist: np.ndarray  # (q, k) float
    ids: np.ndarray   # (q, k) int


@dataclass
class Verdict:
    numbers: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, tuple] = field(default_factory=dict)  # name -> (op, x)
    failed_answers: int = 0
    recall: Optional[float] = None

    def hold(self, name: str, value: float, op: str, limit: float) -> None:
        self.numbers[name] = float(value)
        self.limits[name] = (op, float(limit))

    def passed(self, name: str) -> bool:
        op, limit = self.limits[name]
        v = self.numbers[name]
        return v <= limit if op == "<=" else v >= limit

    @property
    def correct(self) -> bool:
        return bool(self.numbers) and all(self.passed(n) for n in self.numbers)

    def checks(self) -> Dict[str, dict]:
        return {n: {"value": self.numbers[n],
                    "limit": self.limits[n][1],
                    "pass_if": "value " + self.limits[n][0] + " limit"}
                for n in self.numbers}

    def lines(self) -> List[str]:
        return [f"check {n}: {self.numbers[n]!r} (limit {self.limits[n][0]} "
                f"{self.limits[n][1]!r}) "
                f"{'ok' if self.passed(n) else 'FAILED'}"
                for n in self.numbers]


def bad_entries(dist: np.ndarray, ids: np.ndarray, n: int) -> np.ndarray:
    """(q, k) mask of entries the answer gets wrong on its own."""
    bad = (ids < 0) | (ids >= n) | ~np.isfinite(dist)
    pos = np.argsort(ids, axis=1, kind="stable")
    srt = np.take_along_axis(ids, pos, axis=1)
    again = np.zeros_like(bad)  # the second and later entries of an id
    again[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = np.zeros_like(bad)
    np.put_along_axis(dup, pos, again, axis=1)
    bad |= dup
    order = np.zeros_like(bad)
    with np.errstate(invalid="ignore"):
        order[:, 1:] = dist[:, 1:] < dist[:, :-1]
    return bad | order


def judge(answers: List[Answer], batches: List[torch.Tensor],
          rows: torch.Tensor, n: int, k: int, limits: dict,
          exact: bool, recall_floor: Optional[float] = None) -> Verdict:
    """Judge ``answers`` of pool ``batches`` (device tensors of the queries
    as the system received them) over the first ``n`` of ``rows``.
    ``limits`` holds ``dist_err`` and, for an exact search, ``rank_gap``."""
    v = Verdict()
    held = rows[:n]
    ops = reference.Operands(held)
    truth: Dict[int, tuple] = {}
    bad_total, dist_err, rank_gap = 0, 0.0, 0.0
    hits, slots, seen = 0, 0, set()
    for a in answers:
        q = batches[a.batch]
        if a.batch not in truth:
            truth[a.batch] = reference.topk(held, q, k, ops=ops)
        ref_d, ref_i = truth[a.batch]
        ids = torch.as_tensor(np.asarray(a.ids, np.int64), device=q.device)
        d_ref = reference.dist_of(held, q, ids)
        kth = torch.clamp(ref_d[:, -1:], min=1e-30)
        dist = np.asarray(a.dist, np.float64)
        bad = bad_entries(dist, np.asarray(a.ids), n)
        bad_n = int(bad.sum())
        d_ret = torch.as_tensor(dist, device=q.device, dtype=torch.float64)
        ok = torch.as_tensor(~bad, device=q.device)
        gap = torch.where(ok, (d_ret - d_ref.double()).abs() / kth.double(), 0)
        err = float(gap.max()) if gap.numel() else 0.0
        rg = 0.0
        if exact:
            srt, _ = torch.sort(torch.where(ok, d_ref, torch.inf), dim=1)
            diff = torch.where(torch.isfinite(srt), (srt - ref_d) / kth, 0)
            rg = float(diff.max()) if diff.numel() else 0.0
        bad_total += bad_n
        dist_err = max(dist_err, err)
        rank_gap = max(rank_gap, rg)
        if (bad_n or err > limits["dist_err"]
                or (exact and rg > limits["rank_gap"])):
            v.failed_answers += 1
        if a.batch not in seen:  # recall over the first answer to a batch
            seen.add(a.batch)
            ri = ref_i.cpu().numpy()
            got = np.asarray(a.ids)
            hits += int((ri[:, :, None] == got[:, None, :]).any(axis=2).sum())
            slots += ri.size
    v.recall = hits / slots if slots else None
    v.hold("bad_ids", bad_total, "<=", 0)
    v.hold("dist_err", dist_err, "<=", limits["dist_err"])
    if exact:
        v.hold("rank_gap", rank_gap, "<=", limits["rank_gap"])
    if recall_floor is not None and v.recall is not None:
        v.hold("recall", v.recall, ">=", recall_floor)
    return v


def worst(verdicts: List[Verdict]) -> Verdict:
    """One verdict over several judged sets of answers: each number at its
    worst (the largest under a ceiling, the smallest over a floor), the
    failed answers summed."""
    out = Verdict()
    for v in verdicts:
        out.failed_answers += v.failed_answers
        for name, value in v.numbers.items():
            op, limit = v.limits[name]
            if name in out.numbers:
                pick = max if op == "<=" else min
                value = pick(value, out.numbers[name])
            out.hold(name, value, op, limit)
    recalls = [v.recall for v in verdicts if v.recall is not None]
    out.recall = min(recalls) if recalls else None
    return out
