"""The plain reference: exact L2 top-k in plain PyTorch, in blocks.

It imports nothing of the program.  It reads the rows and queries the
benchmark made (in the column's type, upcast to f32 here) and works in
f32 with TF32 off: candidates by the expanded form ``|q|² + |x|² − 2·q·x``
a block at a time, then the best ``cand`` of them scored again in the
direct form ``Σ (q − x)²`` and sorted by (distance, row), so ties go to
the lower row.  Distances are L2 (the square root), as the program
returns them.

``precision`` gives the control of the correctness check: the same
search computed in the precision one step below the column's, put in the
program's place.  ``tf32`` rounds every operand to TF32 (10 mantissa
bits, nearest, ties away from zero, as the tensor cores take f32 input);
``bf16`` rounds every operand to bfloat16 (7 mantissa bits, the port's
packed slab type); ``int8`` quantizes the rows symmetrically per dimension and each query
per row, as an int8 tier would, and computes from the dequantized
values.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch

PRECISIONS = ("f32", "tf32", "bf16", "int8")


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Full f32 products inside the block, whatever the process set."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Operands:
    """The rows and queries as one precision sees them (f32 tensors)."""

    def __init__(self, rows: torch.Tensor, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.rows, self.precision = rows, precision
        self.scale: Optional[torch.Tensor] = None
        if precision == "int8":
            amax = torch.zeros(rows.shape[1], device=rows.device)
            for s in range(0, rows.shape[0], 1 << 18):
                amax = torch.maximum(
                    amax, rows[s: s + (1 << 18)].float().abs().amax(dim=0))
            self.scale = torch.clamp(amax, min=1e-30) / 127.0

    def _seen(self, x: torch.Tensor) -> torch.Tensor:
        """Rows, or queries in a rounding precision, as it sees them."""
        x = x.float()
        if self.precision == "tf32":
            return round_tf32(x)
        if self.precision == "bf16":
            return x.bfloat16().float()
        if self.precision == "int8":
            return torch.clamp(torch.round(x / self.scale), -127, 127) \
                * self.scale
        return x

    def row_block(self, start: int, end: int) -> torch.Tensor:
        return self._seen(self.rows[start:end])

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows by id (ids clamped into range), as this precision sees them."""
        return self._seen(self.rows[ids.clamp(0, self.rows.shape[0] - 1)
                                    .long()])

    def queries(self, qs: torch.Tensor) -> torch.Tensor:
        """Queries as this precision sees them (int8: a scale a query)."""
        if self.precision != "int8":
            return self._seen(qs)
        q = qs.float()
        sq = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-30) / 127.0
        return torch.clamp(torch.round(q / sq), -127, 127) * sq


def direct_dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, C) L2 distances of (Q, D) queries to their (Q, C, D) rows."""
    return torch.sqrt(torch.sum((q[:, None, :] - x) ** 2, dim=-1))


def topk(rows: torch.Tensor, qs: torch.Tensor, k: int, n: Optional[int] = None,
         precision: str = "f32", cand: int = 64, q_block: int = 1024,
         r_block: int = 1 << 18, ops: Optional[Operands] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``k`` of ``qs`` over the first ``n`` rows: ((Q, k) L2
    distances, (Q, k) int64 row ids), sorted by (distance, row)."""
    ops = ops or Operands(rows, precision)
    n = rows.shape[0] if n is None else n
    cand = min(max(cand, k), n)
    out_d, out_i = [], []
    with exact_f32():
        for qs_ in range(0, qs.shape[0], q_block):
            q = ops.queries(qs[qs_: qs_ + q_block])
            q2 = torch.sum(q * q, dim=1, keepdim=True)
            best_d = torch.full((q.shape[0], 0), torch.inf, device=q.device)
            best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                                 device=q.device)
            for rs in range(0, n, r_block):
                x = ops.row_block(rs, min(rs + r_block, n))
                s = q2 + torch.sum(x * x, dim=1)[None, :] - 2.0 * (q @ x.T)
                ids = torch.arange(rs, rs + x.shape[0], device=q.device)
                d_all = torch.cat([best_d, s], dim=1)
                i_all = torch.cat([best_i, ids.expand(q.shape[0], -1)], dim=1)
                best_d, pos = torch.topk(d_all, min(cand, d_all.shape[1]),
                                         dim=1, largest=False)
                best_i = torch.gather(i_all, 1, pos)
            # the candidates again in the direct form, ordered by (d, row)
            best_i, _ = torch.sort(best_i, dim=1)
            d = direct_dist(q, ops.take(best_i))
            d, order = torch.sort(d, dim=1, stable=True)
            out_d.append(d[:, :k])
            out_i.append(torch.gather(best_i, 1, order)[:, :k])
    return torch.cat(out_d), torch.cat(out_i)


def dist_of(rows: torch.Tensor, qs: torch.Tensor, ids: torch.Tensor,
            q_block: int = 1024) -> torch.Tensor:
    """(Q, k) f32 L2 distances of each query to the rows ``ids`` names, in
    the direct form; NaN where an id is out of range."""
    n = rows.shape[0]
    out = []
    with exact_f32():
        for s in range(0, qs.shape[0], q_block):
            q = qs[s: s + q_block].float()
            i = ids[s: s + q_block]
            ok = (i >= 0) & (i < n)
            x = rows[i.clamp(0, n - 1).long()].float()
            out.append(torch.where(ok, direct_dist(q, x), torch.nan))
    return torch.cat(out)
