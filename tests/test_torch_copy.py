"""COPY and the native codec through both packages (test/sql/copy.sql,
tests/test_copy.py, tests/test_native_codec.py).

Text and binary COPY of every type, each way round: a dump by one
package loads into the other with the same rows, and the port's
``copy_out_binary`` bytes equal the reference's for the same table (the
wire format), dead rows skipped.  The codec's native and pure-Python
routes give the same literals, bytes and errors in the port, and the same
as the reference's; errors carry the reference's class and message."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pgvector_tpu import native as jnative  # noqa: E402
from pgvector_tpu.io import copy as jcopy  # noqa: E402
from pgvector_tpu.store.table import BitTable as JBitTable  # noqa: E402
from pgvector_tpu.store.table import DenseTable as JTable  # noqa: E402
from pgvector_tpu.store.table import SparseTable as JSparseTable  # noqa: E402
from pgvector_tpu_torch import (BitTable, DenseTable, HNSWIndex, Metric,  # noqa: E402
                                Relation, SparseTable, Vector)
from pgvector_tpu_torch import native  # noqa: E402
from pgvector_tpu_torch.io import copy as tcopy  # noqa: E402


def _outcome(fn):
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return ("raise", type(exc).__name__, str(exc))
    if isinstance(out, np.ndarray):
        return ("ok", str(out.dtype), out.tolist())
    return ("ok", out)


def _same(fj, ft):
    a, b = _outcome(fj), _outcome(ft)
    assert b == a, (a[:2], b[:2]) if a != b else None
    return a


@pytest.fixture
def python_route(monkeypatch):
    """The port's codec without its native library (as without g++)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()


def _dense_pair(d, dtype="float32"):
    return (JTable(d, dtype=jnp.dtype(dtype)),
            DenseTable(d, dtype=getattr(torch, dtype), device="cpu"))


def _table_rows(t):
    return t.data[: t.count].float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_dense_binary_bytes_equal_both_ways(dtype):
    rng = np.random.default_rng(21)
    data = rng.normal(size=(40, 8)).astype(np.float32)
    data[3, :2] = [-0.0, 0.0]
    jt, tt = _dense_pair(8, dtype)
    jt.insert(data)
    tt.insert(data)
    for t in (jt, tt):
        t.delete([2, 17])
    blob_j, blob_t = jcopy.copy_out_binary(jt), tcopy.copy_out_binary(tt)
    assert blob_t == blob_j
    # each package loads the other's dump
    jt2, tt2 = _dense_pair(8, dtype)
    np.testing.assert_array_equal(tcopy.copy_in_binary(tt2, blob_j),
                                  jcopy.copy_in_binary(jt2, blob_t))
    assert tt2.count == 38
    np.testing.assert_array_equal(
        _table_rows(tt2), np.asarray(jt2.data[:38]).astype(np.float32))
    assert tcopy.copy_out_binary(tt2) == blob_j


def test_dense_text_equal_both_ways():
    lines = ["[1,2,3,4,5]", "[0.5,-0.25,1e10,0,-0]", " [1e-7,3.25,-8,2,1] ",
             "", "[100000,0.0001,-1.5e38,1.5e-38,7]"]
    jt, tt = _dense_pair(5)
    _same(lambda: jcopy.copy_in_text(jt, lines),
          lambda: tcopy.copy_in_text(tt, lines))
    out = _same(lambda: jcopy.copy_out_text(jt),
                lambda: tcopy.copy_out_text(tt))
    assert out[1][1] == "[0.5,-0.25,1e+10,0,-0]"
    jt2, tt2 = _dense_pair(5)
    tcopy.copy_in_text(tt2, jcopy.copy_out_text(jt))
    jcopy.copy_in_text(jt2, tcopy.copy_out_text(tt))
    assert tcopy.copy_out_text(tt2) == jcopy.copy_out_text(jt2) == out[1]


def test_sparse_text_and_binary_equal():
    lines = ["{1:1.5,3:-2}/10", "{}/10", "{10:3e-5}/10", "{2:1,4:2,9:-0.5}/10"]
    jt = JSparseTable(10, nnz_cap=8)
    tt = SparseTable(10, nnz_cap=8, device="cpu")
    jcopy.copy_in_text(jt, lines)
    tcopy.copy_in_text(tt, lines)
    jt.delete([2])
    tt.delete([2])
    _same(lambda: jcopy.copy_out_text(jt), lambda: tcopy.copy_out_text(tt))
    blob = tcopy.copy_out_binary(tt)
    assert blob == jcopy.copy_out_binary(jt)
    jt2 = JSparseTable(10, nnz_cap=8)
    tt2 = SparseTable(10, nnz_cap=8, device="cpu")
    jcopy.copy_in_binary(jt2, blob)
    tcopy.copy_in_binary(tt2, jcopy.copy_out_binary(jt))
    assert tcopy.copy_out_text(tt2) == jcopy.copy_out_text(jt2) == [
        "{1:1.5,3:-2}/10", "{}/10", "{2:1,4:2,9:-0.5}/10"]


def test_bit_text_and_binary_equal():
    rng = np.random.default_rng(22)
    lines = ["101010111", "000000001"] + [
        "".join("1" if b else "0" for b in row)
        for row in rng.random((20, 9)) < 0.5]
    jt, tt = JBitTable(9), BitTable(9, device="cpu")
    jcopy.copy_in_text(jt, lines)
    tcopy.copy_in_text(tt, lines)
    jt.delete([0, 5])
    tt.delete([0, 5])
    _same(lambda: jcopy.copy_out_text(jt), lambda: tcopy.copy_out_text(tt))
    blob = tcopy.copy_out_binary(tt)
    assert blob == jcopy.copy_out_binary(jt)
    jt2, tt2 = JBitTable(9), BitTable(9, device="cpu")
    jcopy.copy_in_binary(jt2, blob)
    tcopy.copy_in_binary(tt2, jcopy.copy_out_binary(jt))
    assert tcopy.copy_out_text(tt2) == jcopy.copy_out_text(jt2) == \
        lines[1:5] + lines[6:]


def test_empty_dumps_equal():
    for jt, tt in (_dense_pair(3), (JBitTable(5), BitTable(5, device="cpu")),
                   (JSparseTable(4), SparseTable(4, device="cpu"))):
        assert tcopy.copy_out_binary(tt) == jcopy.copy_out_binary(jt)
        assert tcopy.copy_out_text(tt) == jcopy.copy_out_text(jt) == []
    jt, tt = _dense_pair(3)
    _same(lambda: jcopy.copy_in_binary(jt, jcopy.copy_out_binary(jt)),
          lambda: tcopy.copy_in_binary(tt, tcopy.copy_out_binary(tt)))


ERROR_LOADS = {
    "bad_magic": lambda C, t: C.copy_in_binary(t, b"NOTACOPY" + b"V" * 20),
    "unknown_kind": lambda C, t: C.copy_in_binary(
        t, b"PGVTCOPY" + b"Z" + b"\0" * 8),
    "dims": lambda C, t: C.copy_in_binary(t, bytes.fromhex(
        "5047565443 4f5059 56 0000000000000001 0002 0000 3f800000 40000000"
        .replace(" ", ""))),
    "truncated": lambda C, t: C.copy_in_binary(t, bytes.fromhex(
        "5047565443 4f5059 56 0000000000000002 0003 0000 3f800000"
        .replace(" ", ""))),
    "text_syntax": lambda C, t: C.copy_in_text(t, ["[1,2", "[1,2,3]"]),
    "text_nan": lambda C, t: C.copy_in_text(t, ["[NaN,1,2]"]),
    "text_inf": lambda C, t: C.copy_in_text(t, ["[Infinity,1,2]"]),
    "text_range": lambda C, t: C.copy_in_text(t, ["[4e38,1,2]"]),
    "text_dims": lambda C, t: C.copy_in_text(t, ["[1,2,3]", "[1,2]"]),
    "text_table_dims": lambda C, t: C.copy_in_text(t, ["[1,2]"]),
}


@pytest.mark.parametrize("case", list(ERROR_LOADS.values()),
                         ids=list(ERROR_LOADS))
def test_load_errors_equal(case):
    jt, tt = _dense_pair(3)
    out = _same(lambda: case(jcopy, jt), lambda: case(tcopy, tt))
    assert out[0] == "raise"


def test_kind_mismatch_errors_equal():
    jt, tt = _dense_pair(3)
    jb, tb = JBitTable(9), BitTable(9, device="cpu")
    jcopy.copy_in_text(jb, ["101010111"])
    blob = jcopy.copy_out_binary(jb)
    jcopy.copy_in_text(jt, ["[1,2,3]"])
    out = _same(lambda: jcopy.copy_in_binary(jb, jcopy.copy_out_binary(jt)),
                lambda: tcopy.copy_in_binary(tb, jcopy.copy_out_binary(jt)))
    assert out[0] == "raise"
    assert _same(lambda: jcopy.copy_in_text(object(), ["[1]"]),
                 lambda: tcopy.copy_in_text(object(), ["[1]"]))[0] == "raise"
    assert tcopy.copy_in_binary(tb, blob).tolist() == [0]


@pytest.mark.parametrize("dtype,lit", [("float16", "[70000,1]"),
                                       ("bfloat16", "[70000,1]"),
                                       ("bfloat16", "[3.4e38,1]"),
                                       ("float16", "[65504,-65504]"),
                                       ("float16", "[65520,1]")])
def test_half_range_equal(dtype, lit):
    jt, tt = _dense_pair(2, dtype)
    _same(lambda: jcopy.copy_in_text(jt, [lit]),
          lambda: tcopy.copy_in_text(tt, [lit]))
    _same(lambda: jcopy.copy_out_text(jt), lambda: tcopy.copy_out_text(tt))


CODEC = {
    "parse": lambda N, a: N.parse_vectors(
        [Vector(r, _checked=True).to_text() for r in a]),
    "parse_dim": lambda N, a: N.parse_vectors(
        [Vector(r, _checked=True).to_text() for r in a], expected_dim=7),
    "format": lambda N, a: N.format_vectors(a * np.float32(1e-6)),
    "format_special": lambda N, a: N.format_vectors(np.array(
        [[0.0, -0.0, 1.5e38, 1.5e-38, 123456.0, 1e-45, 3.4028235e38]],
        np.float32)),
    "encode": lambda N, a: N.encode_binary(a),
    "decode": lambda N, a: N.decode_binary(N.encode_binary(a), len(a)),
    "roundtrip": lambda N, a: N.parse_vectors(N.format_vectors(a)),
    "empty": lambda N, a: (N.parse_vectors([]).shape,
                           N.parse_vectors([], expected_dim=5).shape),
    "hex": lambda N, a: N.parse_vectors(["[0x1p+1,0xA]"]),
}


def _codec_data():
    rng = np.random.default_rng(23)
    return (rng.normal(size=(60, 7)) * np.power(
        10.0, rng.integers(-8, 8, size=(60, 7)))).astype(np.float32)


@pytest.mark.parametrize("case", list(CODEC.values()), ids=list(CODEC))
def test_codec_routes_agree(case, monkeypatch):
    """Native against the reference's native, then the port's Python route
    against the port's native."""
    a = _codec_data()
    assert native.available()
    nat = _same(lambda: case(jnative, a), lambda: case(native, a))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    py = _outcome(lambda: case(native, a))
    assert py == nat


CODEC_ERRORS = {
    "syntax": lambda N: N.parse_vectors(["[1,2", "[1,2]"]),
    "nan": lambda N: N.parse_vectors(["[NaN,1]"]),
    "inf": lambda N: N.parse_vectors(["[Infinity]"]),
    "range": lambda N: N.parse_vectors(["[4e38]"]),
    "dims": lambda N: N.parse_vectors(["[1,2]", "[1,2,3]"]),
    "expected_dims": lambda N: N.parse_vectors(["[1,2]"], expected_dim=3),
    "empty_vector": lambda N: N.parse_vectors(["[]"]),
    "short": lambda N: N.decode_binary(b"\x00", 1),
    "truncated": lambda N: N.decode_binary(
        N.encode_binary(np.ones((2, 3), np.float32))[:-1], 2),
    "count": lambda N: N.decode_binary(
        N.encode_binary(np.ones((2, 3), np.float32)), 1000),
}


@pytest.mark.parametrize("case", list(CODEC_ERRORS.values()),
                         ids=list(CODEC_ERRORS))
def test_codec_errors_equal(case, monkeypatch):
    """The same class and message from both packages' native codecs, and
    from both packages' Python routes."""
    assert _same(lambda: case(jnative), lambda: case(native))[0] == "raise"
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert _same(lambda: case(jnative), lambda: case(native))[0] == "raise"


def test_python_route_copy(python_route):
    """COPY in and out of a dense table on the Python route: the same
    bytes and literals as the reference's native route."""
    rng = np.random.default_rng(24)
    data = rng.normal(size=(25, 6)).astype(np.float32)
    jt, tt = _dense_pair(6)
    jt.insert(data)
    tcopy.copy_in_text(tt, jcopy.copy_out_text(jt))
    assert tcopy.copy_out_binary(tt) == jcopy.copy_out_binary(jt)
    assert tcopy.copy_out_text(tt) == jcopy.copy_out_text(jt)


def test_native_library_in_build_dir():
    """The codec builds into the port's _build directory, hash-checked."""
    assert native.load() is not None
    assert native.LIB_PATH.parent.name == "_build"
    assert native.LIB_PATH.parent.parent.name == "pgvector_tpu_torch"
    stamp = native.BUILD_DIR / "libpgvt_codec.sha256"
    assert stamp.read_text() == native._digest()


def test_copy_into_relation_maintains_indexes():
    """A Relation as COPY target: the rows go through every index (and
    would go to its replication log)."""
    rng = np.random.default_rng(25)
    db = rng.normal(size=(600, 8)).astype(np.float32)
    rel = Relation(DenseTable(8, device="cpu"))
    rel.insert(db[:500])
    h = rel.create_index("hnsw", Metric.L2, m=8, ef_construction=32,
                         wave_size=256)
    bt = rel.create_index("btree")
    src = DenseTable(8, device="cpu")
    src.insert(db[500:])
    rows = tcopy.copy_in_binary(rel, tcopy.copy_out_binary(src))
    np.testing.assert_array_equal(rows, np.arange(500, 600))
    assert isinstance(h, HNSWIndex) and h.live_elements == 600
    assert bt.search_eq(db[550]).tolist() == [550]
    _, r = rel.knn(db[500:505], 1, ef_search=40)
    np.testing.assert_array_equal(r[:, 0], np.arange(500, 505))
    assert tcopy.copy_out_text(rel) == tcopy.copy_out_text(rel.table)
