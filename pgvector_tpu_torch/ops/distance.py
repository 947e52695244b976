"""Batched distances — counterpart of ``pgvector_tpu.ops.distance``.

Every function computes a full (Q, N) block: dense L2² / IP / cosine ride
one ``q @ db.T`` product plus row norms, L1 is an elementwise reduction;
Hamming / Jaccard are XOR / AND plus a popcount over packed 32-bit words;
sparse metrics are the overlap inner product plus norm corrections, by a
searchsorted merge join of sorted index rows.
Distances are the *stored* forms used by index ordering (L2 → squared,
IP → negative, cosine → 1 - cos); ``metric.stored_to_user`` converts.
Accumulation is f32, like the reference kernels (src/vector.c:560-735).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import config
from .metric import Metric

#: compute.matmul_precision → torch.set_float32_matmul_precision.  JAX's
#: DEFAULT is one bf16 pass, HIGH three (about TF32), HIGHEST full f32.
_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


def dot_precision() -> str:
    """Apply ``compute.matmul_precision`` (config.py, default ``highest``)
    to torch's f32 matmuls and return the torch name.  pgvector accumulates
    in f32 (src/vector.c:560-574); a reduced-precision pairwise product
    cost the reference build recall in its first round (BASELINE.md)."""
    name = _PRECISION[config.get("compute.matmul_precision")]
    if torch.get_float32_matmul_precision() != name:
        torch.set_float32_matmul_precision(name)
    return name


@contextlib.contextmanager
def highest_precision() -> Iterator[None]:
    """Full f32 matmuls inside the block whatever ``compute.matmul_precision``
    says, as the reference's ``Precision.HIGHEST`` products (k-means
    assignment: a reduced-precision product scrambles near-tie
    assignments)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def sq_norms(db: torch.Tensor) -> torch.Tensor:
    """Row squared norms, f32 accumulation."""
    dbf = db.float()
    return torch.sum(dbf * dbf, dim=-1)


def dense_scores(
    metric: Metric,
    q: torch.Tensor,  # (Q, D)
    db: torch.Tensor,  # (N, D)
    db_sq: Optional[torch.Tensor] = None,  # (N,) precomputed squared norms
) -> torch.Tensor:
    """(Q, N) stored distances for a dense block.

    One matmul serves L2²/IP/cosine; L1 is an elementwise reduction
    (callers tile N to bound the (Q, N, D) intermediate)."""
    qf = q.float()
    dbf = db.float()
    if metric in (Metric.L2, Metric.IP, Metric.COSINE):
        dot_precision()
        ip = qf @ dbf.T  # (Q, N)
        if metric is Metric.IP:
            return -ip
        if metric is Metric.L2:
            q_sq = torch.sum(qf * qf, dim=-1, keepdim=True)
            d_sq = sq_norms(dbf)[None, :] if db_sq is None else db_sq[None, :]
            return torch.clamp(q_sq - 2.0 * ip + d_sq, min=0.0)
        # cosine: zero-norm rows get +inf distance so they sort last (the
        # reference refuses to index zero vectors for cosine,
        # hnswutils.c:417-423)
        q_n = torch.sqrt(torch.sum(qf * qf, dim=-1, keepdim=True))
        d_sq = sq_norms(dbf)[None, :] if db_sq is None else db_sq[None, :]
        denom = q_n * torch.sqrt(d_sq)
        cos = torch.where(denom > 0,
                          ip / torch.where(denom > 0, denom, 1.0), -torch.inf)
        return 1.0 - cos
    if metric is Metric.L1:
        return torch.sum(torch.abs(qf[:, None, :] - dbf[None, :, :]), dim=-1)
    raise ValueError(f"metric {metric} is not a dense metric")


def dense_point_scores(metric: Metric, qs: torch.Tensor, vf: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """(Q, W, D) candidate values vs (Q, D) queries → (Q, W) f32 stored
    distances; negative ids give +inf.  Elementwise f32 math, as the
    reference's scorer (no expanded-norm form)."""
    qf = qs.float()[:, None, :]
    vf = vf.float()
    if metric is Metric.L2:
        d = torch.sum((qf - vf) ** 2, dim=-1)
    elif metric is Metric.IP or metric is Metric.COSINE:
        # cosine opclasses store normalized values and order by -ip
        # (sql/vector.sql:437-441)
        d = -torch.sum(qf * vf, dim=-1)
    elif metric is Metric.L1:
        d = torch.sum(torch.abs(qf - vf), dim=-1)
    else:
        raise ValueError(metric)
    return torch.where(rows >= 0, d, torch.inf)


def int8_query(qs: torch.Tensor, scale: torch.Tensor):
    """The query side of the int8 slab scorer (hnsw_kernels.py:216-225):
    the scale-folded query ``qf = q ⊙ scale`` re-quantized per row, ``qc
    = clip(round(qf / sq), -127, 127)`` (round half to even) with the step
    ``sq = max(max|qf|, 1e-30) / 127``, and ``q2 = Σ q²``.  Returns (qc
    int8, sq, q2)."""
    qf = qs.float() * scale
    sq = torch.clamp(torch.amax(torch.abs(qf), dim=1), min=1e-30) / 127.0
    qc = torch.clamp(torch.round(qf / sq[:, None]), -127, 127)
    return qc.to(torch.int8), sq, torch.sum(torch.square(qs.float()), dim=1)


#: dims per f32 product of the int8 cross term: 1024 × 127² < 2^24, so
#: every partial sum is an exact integer in f32 whatever its order
_INT8_CHUNK = 1024


def int8_point_scores(metric: Metric, qs: torch.Tensor, scale: torch.Tensor,
                      pnorm2: torch.Tensor, v: torch.Tensor,
                      rows: torch.Tensor, query=None) -> torch.Tensor:
    """(Q, W, D) int8 candidate rows of a per-dim ``scale``d slab vs (Q, D)
    f32 queries → (Q, W) f32 stored distances; negative ids give +inf.
    The plain version of the reference's ``_int8_point_scores``
    (hnsw_kernels.py:202-231) and of K2's int8 slab: the cross term
    ``qc · x`` is an exact integer (the reference's int8 × int8 → int32
    dot), then ``t = float(cross) · sq`` and L2 ``(q2 - 2t) + pnorm2[id]``
    with ``pnorm2`` each element's dequantized squared norm, inner product
    and cosine ``-t``.  L1 has no dot form: ``Σ |q - float(x) · scale|``.
    ``query`` = :func:`int8_query`'s (qc, sq, q2), made here if None."""
    if metric is Metric.L1:
        d = torch.sum(torch.abs(qs.float()[:, None, :] - v.float() * scale),
                      dim=-1)
        return torch.where(rows >= 0, d, torch.inf)
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
        raise ValueError(metric)
    qc, sq, q2 = int8_query(qs, scale) if query is None else query
    cross = 0
    for s in range(0, v.shape[-1], _INT8_CHUNK):
        part = torch.bmm(v[..., s: s + _INT8_CHUNK].float(),
                         qc[:, s: s + _INT8_CHUNK].float()[:, :, None])
        cross = cross + part[..., 0].to(torch.int64)
    t = cross.to(torch.float32) * sq[:, None]
    if metric is Metric.L2:
        d = (q2[:, None] - 2.0 * t) + pnorm2[torch.clamp(rows, min=0).long()]
    else:
        d = -t
    return torch.where(rows >= 0, d, torch.inf)


def dense_pair(metric: Metric, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise stored distance for aligned batches (B, D) x (B, D) → (B,)."""
    af = a.float()
    bf = b.float()
    if metric is Metric.L2:
        d = af - bf
        return torch.sum(d * d, dim=-1)
    if metric is Metric.IP:
        return -torch.sum(af * bf, dim=-1)
    if metric is Metric.COSINE:
        ip = torch.sum(af * bf, dim=-1)
        denom = torch.sqrt(torch.sum(af * af, dim=-1) * torch.sum(bf * bf, dim=-1))
        cos = torch.where(denom > 0,
                          ip / torch.where(denom > 0, denom, 1.0), -torch.inf)
        return 1.0 - cos
    if metric is Metric.L1:
        return torch.sum(torch.abs(af - bf), dim=-1)
    raise ValueError(f"metric {metric} is not a dense metric")


# ---------------------------------------------------------------------------
# binary: packed 32-bit words, MSB first within each word
# ---------------------------------------------------------------------------
#
# The reference packs bits into uint32 words; torch covers uint32 thinly on
# CUDA, so the port stores int32 words with the same bit patterns (bit 31
# set makes a word negative) and never shifts one arithmetically.

#: popcount of every byte value: the plain versions' popcount (torch has
#: no popcount operator)
_POP8 = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int32)


def pack_bits(bits) -> torch.Tensor:
    """(…, D) bools → (…, ceil(D/32)) int32 words: bit i → word i//32, bit
    31-(i%32) (the reference's ``pack_bits``; the MSB-first byte layout of
    VARBITS / binary_quantize, src/vector.c:952-978, read big-endian).  A
    numpy array is packed on the host and comes back as a CPU tensor; a
    tensor is packed on its own device."""
    if not torch.is_tensor(bits):
        arr = np.asarray(bits, dtype=bool)
        d = arr.shape[-1]
        pad = (-d) % 32
        if pad:
            arr = np.concatenate(
                [arr, np.zeros(arr.shape[:-1] + (pad,), bool)], axis=-1)
        by = np.packbits(arr, axis=-1)  # MSB-first bytes
        words = np.ascontiguousarray(by).view(">u4").astype(np.uint32)
        return torch.from_numpy(words.view(np.int32).copy())
    d = bits.shape[-1]
    pad = (-d) % 32
    b = bits.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + ((d + pad) // 32, 32))
    shifts = torch.arange(31, -1, -1, device=b.device)
    w = torch.sum(b << shifts, dim=-1)  # in [0, 2^32)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(words: torch.Tensor, dim: int) -> torch.Tensor:
    """(…, W) int32 words → (…, dim) f32 in {0, 1}, MSB first (the
    reference's ``ivfflat._unpack_words``)."""
    shifts = torch.arange(31, -1, -1, device=words.device)
    bits = (words.to(torch.int64)[..., :, None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :dim].to(torch.float32)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """Row popcounts of packed words (…, W) → (…,) int32."""
    by = words.contiguous().view(torch.uint8).to(torch.int32)
    pc = _POP8.to(words.device)[by]
    return torch.sum(pc, dim=-1, dtype=torch.int32)


def jaccard_from_counts(ab: torch.Tensor, aa: torch.Tensor,
                        bb: torch.Tensor) -> torch.Tensor:
    """1 - ab / (aa + bb - ab) in f32, 1 where ab == 0, in the reference's
    order of operations (``distance.bit_scores``, src/bitutils.c:98-131)."""
    ab, aa, bb = ab.float(), aa.float(), bb.float()
    denom = aa + bb - ab
    return torch.where(ab == 0, 1.0,
                       1.0 - ab / torch.where(denom > 0, denom, 1.0))


def bit_scores(metric: Metric, q: torch.Tensor, db: torch.Tensor,
               db_pop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, N) Hamming or Jaccard distances of packed words (Q, W) against
    (N, W): popcount(a XOR b) (src/bitutils.c:49-73), or 1 - |a∩b| / |a∪b|
    with empty ∩ empty → 1 (src/bitutils.c:98-131)."""
    if metric is Metric.HAMMING:
        return popcount_rows(q[:, None, :] ^ db[None, :, :]).float()
    if metric is Metric.JACCARD:
        ab = popcount_rows(q[:, None, :] & db[None, :, :])
        aa = popcount_rows(q)[:, None]
        bb = (popcount_rows(db) if db_pop is None else db_pop)[None, :]
        return jaccard_from_counts(ab, aa, bb)
    raise ValueError(f"metric {metric} is not a bit metric")


# ---------------------------------------------------------------------------
# sparse: padded CSR rows {indices int32 (N, P) sorted, padded with
# SPARSE_PAD; values f32 (N, P), 0 at pads} against sparse queries
# ---------------------------------------------------------------------------

#: index padding sentinel, above any valid index (dims < 2^30)
SPARSE_PAD = 2**30


def scatter_dense(idx: torch.Tensor, val: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """Padded CSR rows (R, P) → dense (R, dim + 1) f32: pads (SPARSE_PAD,
    value 0) land in the overflow column ``dim``, which holds 0; indices
    are distinct per row, so a scatter-add sets them."""
    out = torch.zeros((idx.shape[0], dim + 1), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_add_(1, torch.clamp(idx, max=dim).long(), val.float())


def _overlap_gather(q_idx: torch.Tensor, q_val: torch.Tensor,
                    idx: torch.Tensor):
    """For each stored entry's index, the matching query value (0 when
    absent) and whether it matched: the vectorized merge join of
    src/sparsevec.c:822-932.  ``q_idx`` is sorted, padded with
    SPARSE_PAD: one query (Pq,) against rows (N, P), or a batch (Q, Pq)
    against shared rows (N, P) or per-query rows (Q, R, P)."""
    last = q_idx.shape[-1] - 1
    if q_idx.ndim == 1:
        pos = torch.searchsorted(q_idx.contiguous(), idx.reshape(-1))
        pos = torch.clamp(pos, max=last).reshape(idx.shape)
        match = q_idx[pos] == idx
        return torch.where(match, q_val[pos], 0.0), match
    nq = q_idx.shape[0]
    if idx.ndim == 3:
        flat = idx.reshape(nq, -1)
    else:
        flat = idx.reshape(1, -1).expand(nq, -1)
    pos = torch.searchsorted(q_idx.contiguous(), flat.contiguous())
    pos = torch.clamp(pos, max=last)
    match = torch.gather(q_idx, 1, pos) == flat
    qv = torch.where(match, torch.gather(q_val, 1, pos), 0.0)
    shape = (nq,) + tuple(idx.shape[-2:])
    return qv.reshape(shape), match.reshape(shape)


def _sparse_from_overlap(metric: Metric, qv_at, match, q_val, val,
                         row_sq=None, row_abs=None) -> torch.Tensor:
    """The stored distances from the overlap: L2² = |q|² + |r|² - 2·ip,
    -IP, cosine 1 - ip/(|q||r|), L1 = Σ|q| + Σ|r| + Σ_overlap(|qv-rv| -
    |qv| - |rv|) (src/sparsevec.c:822-1056).  ``q_val`` (…, Pq) carries
    the leading dims of ``val`` (…, R, P) minus R."""
    if metric is Metric.L1:
        overlap = torch.sum(torch.where(
            match, torch.abs(qv_at - val) - torch.abs(qv_at) - torch.abs(val),
            0.0), dim=-1)
        q_abs = torch.sum(torch.abs(q_val), dim=-1, keepdim=True)
        r_abs = torch.sum(torch.abs(val), dim=-1) if row_abs is None else row_abs
        return q_abs + r_abs + overlap
    ip = torch.sum(qv_at * val, dim=-1)
    if metric is Metric.IP:
        return -ip
    q_sq = torch.sum(q_val * q_val, dim=-1, keepdim=True)
    r_sq = torch.sum(val * val, dim=-1) if row_sq is None else row_sq
    if metric is Metric.L2:
        return torch.clamp(q_sq + r_sq - 2.0 * ip, min=0.0)
    if metric is Metric.COSINE:
        denom = torch.sqrt(q_sq * r_sq)
        cos = torch.where(denom > 0,
                          ip / torch.where(denom > 0, denom, 1.0), -torch.inf)
        return 1.0 - cos
    raise ValueError(f"metric {metric} is not a sparse metric")


def sparse_scores(metric: Metric, q_idx: torch.Tensor, q_val: torch.Tensor,
                  idx: torch.Tensor, val: torch.Tensor,
                  row_sq: Optional[torch.Tensor] = None,
                  row_abs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,) stored distances from one sparse query (q_idx, q_val: (Pq,),
    sorted, padded with SPARSE_PAD) to every row of (idx, val)."""
    qv_at, match = _overlap_gather(q_idx, q_val, idx)
    return _sparse_from_overlap(metric, qv_at, match, q_val, val, row_sq,
                                row_abs)


def sparse_scores_batch(metric: Metric, q_idx: torch.Tensor,
                        q_val: torch.Tensor, idx: torch.Tensor,
                        val: torch.Tensor,
                        row_sq: Optional[torch.Tensor] = None,
                        row_abs: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(Q, N) stored distances for a batch of sparse queries (Q, Pq)
    against rows (N, P), or against per-query rows (Q, R, P) → (Q, R)."""
    qv_at, match = _overlap_gather(q_idx, q_val, idx)
    return _sparse_from_overlap(metric, qv_at, match, q_val, val, row_sq,
                                row_abs)
