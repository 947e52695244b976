"""The ``bit`` type through both packages, on the CPU.

- ``Bit``: the reference's golden cases (tests/test_bit_type.py) and its
  scalar distances on random strings.
- ``pack_bits`` gives the reference's words bit for bit; ``bit_scores``,
  K4's plain version (``bit_topk_plain``) and K5's
  (``bit_point_scores_plain``) give the reference's distances exactly and,
  Hamming distances tying everywhere at 64 bits, the same ids: the lower
  row first among equals, as ``tiled_topk`` keeps them.
- ``FlatIndex`` over a BitTable: both routes, with deletes and a filter.
- HNSW: the reference builds Hamming and Jaccard graphs over 256-bit rows
  (where ties are few); the port searches them, loaded through
  ``hnsw_from_numpy``, with the same ids apart from ties and equal
  distances, after the same layer-0 hops.  The port's own build draws the
  same levels and at least 95 % of its level-0 lists equal the
  reference's.
- IVFFlat with ``bit_hamming_ops`` over the reference's trained centers:
  the same postings and the same answers; the port's own build.

Every input comes from its own seeded ``np.random.default_rng``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from pgvector_tpu import Bit as JBit  # noqa: E402
from pgvector_tpu.index import hnsw_kernels as JK  # noqa: E402
from pgvector_tpu.index.flat import FlatIndex as JFlat  # noqa: E402
from pgvector_tpu.index.hnsw import HNSWIndex as JHNSW  # noqa: E402
from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF  # noqa: E402
from pgvector_tpu.ops import distance as JD  # noqa: E402
from pgvector_tpu.ops.metric import Metric as JMetric  # noqa: E402
from pgvector_tpu.ops.topk import tiled_topk as j_tiled_topk  # noqa: E402
from pgvector_tpu.store.table import BitTable as JBitTable  # noqa: E402
from pgvector_tpu_torch import (  # noqa: E402
    Bit, BitTable, DataException, FeatureNotSupported, FlatIndex, HNSWIndex,
    IVFFlatIndex, InvalidTextRepresentation, Metric)
from pgvector_tpu_torch.index import hnsw_kernels as TK  # noqa: E402
from pgvector_tpu_torch.io.convert import (  # noqa: E402
    bit_table_from_numpy, hnsw_from_numpy, ivfflat_from_numpy)
from pgvector_tpu_torch.ops import distance as TD  # noqa: E402
from pgvector_tpu_torch.ops.bit_scan import (  # noqa: E402
    bit_point_scores, bit_point_scores_plain, bit_topk, bit_topk_plain)
from torch_hnsw_pairs import reference_state  # noqa: E402
from torch_ivf_pairs import reference_state as ivf_state  # noqa: E402
from torch_parity import assert_same_topk  # noqa: E402

BIT_METRICS = ["HAMMING", "JACCARD"]


def _bits(seed, n, d, p=0.5):
    return np.random.default_rng(seed).random((n, d)) < p


def _tables(bits):
    jt = JBitTable(bits.shape[1])
    jt.insert(bits)
    tt = BitTable(bits.shape[1], device="cpu")
    tt.insert(bits)
    return jt, tt


# ------------------------------------------------------------ the type
def test_bit_golden_cases():
    assert Bit("10110").to_text() == "10110"
    assert Bit.from_text("0").to_text() == "0"
    assert Bit("1100").hamming_distance(Bit("1001")) == 2.0
    assert Bit("1111").hamming_distance(Bit("1111")) == 0.0
    assert Bit("1100").jaccard_distance(Bit("1001")) == pytest.approx(1 - 1 / 3)
    assert Bit("0000").jaccard_distance(Bit("0000")) == 1.0
    assert Bit("1111").jaccard_distance(Bit("1111")) == 0.0
    with pytest.raises(DataException, match="different bit lengths 4 and 5"):
        Bit("1100").hamming_distance(Bit("10011"))
    with pytest.raises(InvalidTextRepresentation, match='"2" is not a valid'):
        Bit("1021")
    b = Bit([1, 0, 1, 0, 1, 0, 1, 1, 1])
    assert b.to_bytes() == bytes([0b10101011, 0b10000000])
    assert Bit.from_bytes(b.to_bytes(), 9) == b
    assert hash(b) == hash(Bit("101010111")) and b != Bit("101010110")


def test_bit_distances_match_reference():
    rng = np.random.default_rng(7)
    for d in (1, 31, 64, 1000):
        for _ in range(5):
            a, b = rng.random(d) < 0.5, rng.random(d) < 0.3
            for name in ("hamming_distance", "jaccard_distance"):
                assert getattr(Bit(a), name)(Bit(b)) == \
                    getattr(JBit(a), name)(JBit(b))
            assert Bit(a).to_bytes() == JBit(a).to_bytes()
            assert Bit(a).to_text() == JBit(a).to_text()


# ------------------------------------------------------------ the ops
@pytest.mark.parametrize("d", [1, 32, 70, 256])
def test_pack_bits_matches_reference(d):
    bits = _bits(1, 40, d)
    want = np.asarray(JD.pack_bits(jnp.asarray(bits))).view(np.int32)
    got = TD.pack_bits(bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TD.pack_bits(torch.from_numpy(bits)).numpy(),
                                  want)
    np.testing.assert_array_equal(TD.unpack_bits(got, d).numpy(),
                                  bits.astype(np.float32))
    np.testing.assert_array_equal(
        TD.popcount_rows(got).numpy(),
        np.asarray(JD.popcount_rows(jnp.asarray(want.view(np.uint32)))))


def _exact_reference(metric, qw, words, valid, k):
    """The reference's bit ground truth: tiled_topk over bit_scores."""
    jq, jw = jnp.asarray(qw.view(np.uint32)), jnp.asarray(words.view(np.uint32))

    def score(tile):
        return JD.bit_scores(JMetric[metric], jq, tile)

    d, i = j_tiled_topk(score, (jw,), len(words), k, tile=128,
                        valid=jnp.asarray(valid))
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", BIT_METRICS)
def test_bit_topk_plain_equals_reference(metric, k):
    """K4's plain version against the reference's tiled scan: equal
    distances and ids, ties (everywhere at 64 bits) to the lower row."""
    words = TD.pack_bits(_bits(2, 700, 64)).numpy()
    words[5] = 0  # an empty row: Jaccard's ab == 0 → 1
    qw = TD.pack_bits(_bits(3, 9, 64)).numpy()
    qw[0] = 0  # an empty query
    valid = np.random.default_rng(4).random(700) > 0.2
    d0, i0 = _exact_reference(metric, qw, words, valid, k)
    tw = torch.from_numpy(words)
    pop = TD.popcount_rows(tw) if metric == "JACCARD" else None
    d1, i1 = bit_topk_plain(Metric[metric], torch.from_numpy(qw), tw, k,
                            torch.from_numpy(valid), pop)
    np.testing.assert_array_equal(d1.numpy(), d0)
    np.testing.assert_array_equal(i1.numpy(), i0)
    # the CPU wrapper takes the plain version
    d2, i2 = bit_topk(Metric[metric], torch.from_numpy(qw), tw, k,
                      torch.from_numpy(valid), pop)
    assert torch.equal(d2, d1) and torch.equal(i2, i1)


def _word_bits(words):
    """(…, W) uint32 words → (…, W * 32) int32 bits, bit p of word c at
    32c + p (the order inside a word does not matter to a dot product)."""
    w = np.asarray(words, dtype=np.uint32)
    bits = (w[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (-1,)).astype(np.int32)


@pytest.mark.parametrize("bits", [20, 128, 3200])
@pytest.mark.parametrize("metric", BIT_METRICS)
def test_k4_tensor_core_arithmetic_equals_reference(metric, bits):
    """The arithmetic of K4's int8 tensor-core path, bitwise against the
    reference's bit_scores: ab = unpack(q) · unpack(x) as an int32
    product, Hamming = |q| + |x| - 2 ab and Jaccard from the same ab; then
    the kernel's own operand bytes (csrc/bit_scan.cu: a row fragment holds
    each even bit as 0/1 and each odd bit as 0/2, the query's bytes weigh
    2 and 1 the other way round, signed for Hamming), whose product is 2
    (2 ab - |x|) (Hamming) or 2 ab (Jaccard).  Tail bits past the width
    are zero, an empty query and an empty row are included."""
    qw = TD.pack_bits(_bits(40 + bits, 33, bits)).numpy().view(np.uint32)
    xw = TD.pack_bits(_bits(41 + bits, 257, bits, 0.3)).numpy() \
        .view(np.uint32).copy()
    qw[0] = 0
    xw[3] = 0
    want = np.asarray(JD.bit_scores(JMetric[metric], jnp.asarray(qw),
                                    jnp.asarray(xw)))
    q, x = _word_bits(qw), _word_bits(xw)
    ab = q @ x.T  # int32
    aa, bb = q.sum(1)[:, None], x.sum(1)[None, :]

    def dist(ab2):
        if metric == "HAMMING":
            return (aa + bb - 2 * ab2).astype(np.float32)
        return TD.jaccard_from_counts(torch.from_numpy(ab2),
                                      torch.from_numpy(aa),
                                      torch.from_numpy(bb)).numpy()

    np.testing.assert_array_equal(dist(ab), want)
    even = (np.arange(q.shape[1]) % 2 == 0)
    b_bytes = np.where(even, x, 2 * x).astype(np.int8)
    a_weight = np.where(even, 2, 1)
    a_bytes = (a_weight * (2 * q - 1) if metric == "HAMMING"
               else a_weight * q).astype(np.int8)
    acc = a_bytes.astype(np.int32) @ b_bytes.astype(np.int32).T
    if metric == "HAMMING":
        np.testing.assert_array_equal(acc, 2 * (2 * ab - bb))
        np.testing.assert_array_equal(
            (aa - acc // 2).astype(np.float32), want)
    else:
        np.testing.assert_array_equal(dist(acc // 2), want)


@pytest.mark.parametrize("metric", BIT_METRICS)
def test_bit_point_scores_plain_equals_reference(metric):
    """K5's plain version against the reference's bit scorer."""
    rng = np.random.default_rng(5)
    words = TD.pack_bits(_bits(6, 300, 100)).numpy()
    qw = TD.pack_bits(_bits(7, 12, 100)).numpy()
    rows = rng.integers(0, 300, size=(12, 40)).astype(np.int32)
    rows[:, ::7] = -1
    score = JK.make_scorer("bit", JMetric[metric],
                           (jnp.asarray(words.view(np.uint32)),))
    want = np.asarray(score(jnp.asarray(qw.view(np.uint32)),
                            jnp.asarray(rows)))
    got = bit_point_scores_plain(Metric[metric], torch.from_numpy(qw),
                                 torch.from_numpy(words),
                                 torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(bit_point_scores(
        Metric[metric], torch.from_numpy(qw), torch.from_numpy(words),
        torch.from_numpy(rows)), got)


@pytest.mark.parametrize("metric", BIT_METRICS)
def test_bit_pairwise_block_equals_reference(metric):
    """The select block: K5 with the candidates' own words as queries."""
    rng = np.random.default_rng(8)
    words = TD.pack_bits(_bits(9, 200, 96)).numpy()
    elems = np.stack([rng.choice(200, 24, replace=False)
                      for _ in range(6)]).astype(np.int32)
    elems[:, -4:] = -1
    want = np.asarray(JK._pairwise_dists(
        "bit", JMetric[metric], (jnp.asarray(words.view(np.uint32)),),
        jnp.asarray(elems)))
    got = TK._pairwise_dists("bit", Metric[metric], torch.from_numpy(words),
                             torch.from_numpy(elems))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ exact search
@pytest.mark.parametrize("k", [5, 100])
@pytest.mark.parametrize("metric", BIT_METRICS)
def test_flat_bit_matches_reference(metric, k):
    bits = _bits(10, 600, 70)
    jt, tt = _tables(bits)
    jt.delete(np.arange(0, 600, 9))
    tt.delete(np.arange(0, 600, 9))
    q = _bits(11, 8, 70)
    fmask = np.random.default_rng(12).random(600) > 0.3
    for f in (None, fmask):
        d0, i0 = JFlat(jt, JMetric[metric]).search(q, k, filter_mask=f)
        flat = FlatIndex(tt, Metric[metric])
        d1, i1 = flat.search([Bit(b) for b in q], k, filter_mask=f)
        assert flat.last_path == ("bit-kernel" if k <= 64 else "tiled")
        np.testing.assert_array_equal(d1, d0)
        np.testing.assert_array_equal(i1, i0)


def test_flat_bit_errors():
    tt = BitTable(8, device="cpu")
    with pytest.raises(DataException, match="does not apply to bit"):
        FlatIndex(tt, Metric.L2)
    with pytest.raises(DataException, match="different bit lengths 9 and 8"):
        FlatIndex(tt, Metric.HAMMING).search(np.zeros((1, 9), bool), 1)


# ------------------------------------------------------------ HNSW
@pytest.fixture(scope="module")
def bit_graphs():
    """Reference Hamming and Jaccard graphs over 1,500 × 256-bit rows."""
    bits = _bits(13, 1500, 256, p=0.4)
    q = np.concatenate([bits[:10] ^ (_bits(14, 10, 256, p=0.02)),
                        _bits(15, 10, 256, p=0.4)])
    out = {"bits": bits, "q": q}
    for metric in BIT_METRICS:
        jt, tt = _tables(bits)
        ref = JHNSW(jt, JMetric[metric], m=8, ef_construction=32,
                    wave_size=256, beam_expand=4)
        out[metric] = (ref, tt)
    return out


@pytest.mark.parametrize("metric", BIT_METRICS)
def test_bit_hnsw_search_on_reference_graph(bit_graphs, metric, monkeypatch):
    monkeypatch.setenv("PGVECTOR_TPU_VISITED", "off")
    ref, tt = bit_graphs[metric]
    arrays, meta = reference_state(ref)
    meta["kind"] = "bit"
    port = hnsw_from_numpy(tt, arrays, meta)
    assert port.kind == "bit" and port._packed_plan() is None
    for ef in (16, 48):
        d0, r0 = ref.search(bit_graphs["q"], 10, ef_search=ef)
        d1, r1 = port.search(bit_graphs["q"], 10, ef_search=ef)
        assert_same_topk(d0, r0, d1, r1, atol=0.0, rtol=0.0)
        assert port._last_scan_steps == int(ref._last_scan_steps)


@pytest.mark.parametrize("metric", BIT_METRICS)
def test_bit_hnsw_build_matches_reference(bit_graphs, metric):
    ref, tt = bit_graphs[metric]
    port = HNSWIndex(tt, Metric[metric], m=8, ef_construction=32,
                     wave_size=256, beam_expand=4)
    n = ref.n_elems
    assert port.n_elems == n
    np.testing.assert_array_equal(port.levels[:n], ref.levels[:n])
    same = (np.sort(port.nbr0[:n].numpy(), axis=1)
            == np.sort(np.asarray(ref.nbr0[:n]), axis=1)).all(axis=1)
    assert same.mean() >= 0.95, same.mean()
    _, r_ref = ref.search(bit_graphs["q"], 10, ef_search=64)
    _, r_new = port.search(bit_graphs["q"], 10, ef_search=64)
    _, gt = FlatIndex(tt, Metric[metric]).search(bit_graphs["q"], 10)
    hits = [len(set(a.tolist()) & set(b.tolist())) for a, b in zip(r_new, gt)]
    hits_ref = [len(set(np.asarray(a).tolist()) & set(b.tolist()))
                for a, b in zip(r_ref, gt)]
    assert sum(hits) >= sum(hits_ref) - 4, (sum(hits), sum(hits_ref))


def test_bit_hnsw_errors():
    tt = BitTable(8, device="cpu")
    with pytest.raises(FeatureNotSupported, match="for bit vectors"):
        HNSWIndex(tt, Metric.L2, build=False)
    with pytest.raises(DataException, match="64000 dimensions"):
        HNSWIndex(BitTable(64001, device="cpu"), Metric.HAMMING, build=False)


# ------------------------------------------------------------ IVFFlat
@pytest.fixture(scope="module")
def bit_ivf():
    bits = _bits(16, 2500, 64, p=0.5)
    jt, tt = _tables(bits)
    ref = JIVF(jt, JMetric.HAMMING, lists=12, seed=1)
    port = ivfflat_from_numpy(tt, *ivf_state(ref))
    return bits, jt, tt, ref, port


@pytest.mark.parametrize("probes", [1, 3, 12])
def test_bit_ivfflat_on_reference_centers(bit_ivf, probes):
    bits, _, _, ref, port = bit_ivf
    np.testing.assert_array_equal(port.postings, ref.postings)
    q = _bits(17, 10, 64)
    d0, r0 = ref.search(q, 10, probes=probes)
    d1, r1 = port.search(q, 10, probes=probes)
    assert port.last_path == "blocks"
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(r1, r0)


def test_bit_ivfflat_build_insert_vacuum(bit_ivf):
    bits = bit_ivf[0]
    tt = bit_table_from_numpy(TD.pack_bits(bits).numpy().view(np.uint32),
                              64, np.ones(len(bits), bool), device="cpu")
    port = IVFFlatIndex(tt, Metric.HAMMING, lists=12, seed=1)
    q = _bits(18, 10, 64)
    _, gt = FlatIndex(tt, Metric.HAMMING).search(q, 10)
    d, r = port.search(q, 10, probes=12)  # every list: exact
    d_gt, _ = FlatIndex(tt, Metric.HAMMING).search(q, 10)
    np.testing.assert_array_equal(d, d_gt)
    rows = tt.insert(bits[:50] ^ _bits(19, 50, 64, p=0.05))
    port.insert(rows)
    tt.delete(rows[:10])
    port.vacuum()
    assert port.list_lens.sum() == len(bits) + 40
    _, r = port.search(q, 10, probes=12)
    assert not np.isin(r, rows[:10]).any()
    with pytest.raises(FeatureNotSupported, match="bit_jaccard_ops"):
        IVFFlatIndex(tt, Metric.JACCARD, build=False)


def test_bit_table_without_device_needs_a_card(monkeypatch):
    """As DenseTable: no named device means the card, and without one a
    DataException that names the way out."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DataException, match='device="cpu"'):
        BitTable(8)
    with pytest.raises(DataException, match='device="cpu"'):
        bit_table_from_numpy(np.zeros((4, 1), np.uint32), 8, np.ones(4, bool))
    t = BitTable(8, device="cpu")
    t.insert(np.ones((3, 8), bool))
    assert t.data.device.type == "cpu" and t.count == 3
    assert t.get(1) == Bit("11111111")
