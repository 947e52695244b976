"""The value types through both packages: the golden cases of
tests/test_vector_type.py, test_halfvec_type.py, test_sparsevec_type.py
and test_bit_type.py, each run on ``pgvector_tpu`` and on
``pgvector_tpu_torch``.  A case returns the same text, the same bytes and
the same numbers (exactly: the scalar code is the same numpy arithmetic),
or raises the same exception class with the same message."""

import math
import struct

import numpy as np
import pytest

import pgvector_tpu as J
import pgvector_tpu_torch as P


def _norm(v):
    """A comparable form of a case's result, whichever package made it."""
    if isinstance(v, (J.Vector, J.HalfVec, J.SparseVec, J.Bit,
                      P.Vector, P.HalfVec, P.SparseVec, P.Bit)):
        return (type(v).__name__, v.to_text())
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.tolist())
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return v


def _outcome(case, pkg):
    try:
        return ("ok", _norm(case(pkg)))
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return ("raise", type(exc).__name__, str(exc))


def _same(case):
    ref, port = _outcome(case, J), _outcome(case, P)
    assert port == ref, (ref, port)
    return ref


def _cases(table):
    return pytest.mark.parametrize("case", list(table.values()),
                                   ids=list(table))


# -- vector (test/sql/vector_type.sql, src/vector.c) -------------------------
_VEC_LITERALS = [
    "[1,2,3]", "[-1,-2,-3]", "[1.,2.,3.]", " [ 1,  2 ,    3  ] ",
    "[1.23456]", "[1.5e38,-1.5e38]", "[1.5e+38,-1.5e+38]",
    "[1.5e-38,-1.5e-38]", "[1e-46,1]", "[-1e-46,1]", "[0.5, 0.25]",
    "[100000,0.0001]", "[hello,1]", "[NaN,1]", "[Infinity,1]",
    "[-Infinity,1]", "[4e38,1]", "[-4e38,1]", "[1,2,3", "[1,2,3]9",
    "1,2,3", "", "[", "[ ", "[,", "[]", "[ ]", "[1,]", "[1a]", "[1,,3]",
    "[1, ,3]", "[0x1p+1,2]",
]


def _vec(pkg, *a):
    return pkg.Vector(list(a))


VECTOR_CASES = {
    **{f"text{n}": (lambda P_, lit=lit: P_.Vector.from_text(lit).to_text())
       for n, lit in enumerate(_VEC_LITERALS)},
    "typmod_ok": lambda P_: P_.Vector.from_text("[1,2,3]", typmod=3).dim,
    "typmod_bad": lambda P_: P_.Vector.from_text("[1,2,3]", typmod=4),
    "max_dim_text": lambda P_: P_.Vector.from_text(
        "[" + ",".join(["1"] * 16001) + "]"),
    "max_dim_ok": lambda P_: P_.Vector(np.ones(16000, np.float32)).dim,
    "max_dim_ctor": lambda P_: P_.Vector(np.ones(16001, np.float32)),
    "ctor_nan": lambda P_: _vec(P_, 1.0, float("nan")),
    "ctor_inf": lambda P_: _vec(P_, 1.0, float("inf")),
    "ctor_2d": lambda P_: P_.Vector(np.ones((2, 2))),
    "binary": lambda P_: P_.Vector.from_text("[1.5,-2.25,3e7]").to_binary(),
    "binary_roundtrip": lambda P_: P_.Vector.from_binary(
        P_.Vector.from_text("[1.5,-2.25,3e7]").to_binary()),
    "binary_unused": lambda P_: P_.Vector.from_binary(
        b"\x00\x01\x00\x01" + b"\x3f\x80\x00\x00"),
    "binary_typmod": lambda P_: P_.Vector.from_binary(
        P_.Vector([1, 2]).to_binary(), typmod=3),
    "binary_short": lambda P_: P_.Vector.from_binary(b"\x00"),
    "binary_truncated": lambda P_: P_.Vector.from_binary(
        struct.pack(">hh", 5, 0) + b"\x00" * 8),
    "l2": lambda P_: (_vec(P_, 0, 0).l2_distance(_vec(P_, 3, 4)),
                      _vec(P_, 0, 0).l2_squared_distance(_vec(P_, 3, 4))),
    "ip": lambda P_: (_vec(P_, 1, 2).inner_product(_vec(P_, 3, 4)),
                      _vec(P_, 1, 2).negative_inner_product(_vec(P_, 3, 4))),
    "cosine": lambda P_: (_vec(P_, 1, 2).cosine_distance(_vec(P_, 2, 4)),
                          _vec(P_, 1, 0).cosine_distance(_vec(P_, 0, 1)),
                          _vec(P_, 1, 1).cosine_distance(_vec(P_, -1, -1)),
                          _vec(P_, 0, 0).cosine_distance(_vec(P_, 1, 1))),
    "l1": lambda P_: _vec(P_, 0, 0).l1_distance(_vec(P_, 3, 4)),
    "spherical": lambda P_: (_vec(P_, 1, 0).spherical_distance(_vec(P_, 0, 1)),
                             _vec(P_, 1, 0).spherical_distance(_vec(P_, 1, 0))),
    "dim_mismatch": lambda P_: _vec(P_, 1, 2).l2_distance(_vec(P_, 1, 2, 3)),
    "seeded_distances": lambda P_: [
        (a.l2_distance(b), a.inner_product(b), a.cosine_distance(b),
         a.l1_distance(b), a.spherical_distance(b.l2_normalize()))
        for a, b in [(P_.Vector(x), P_.Vector(y)) for x, y in
                     np.random.default_rng(3).normal(size=(5, 2, 33))]],
    "norm": lambda P_: _vec(P_, 3, 4).norm(),
    "l2_normalize": lambda P_: (_vec(P_, 3, 4).l2_normalize(),
                                _vec(P_, 0, 0).l2_normalize()),
    "add_sub_mul": lambda P_: (_vec(P_, 1, 2, 3) + _vec(P_, 4, 5, 6),
                               _vec(P_, 4, 5, 6) - _vec(P_, 1, 2, 3),
                               _vec(P_, 1, 2, 3) * _vec(P_, 4, 5, 6)),
    "add_overflow": lambda P_: _vec(P_, 3e38) + _vec(P_, 3e38),
    "sub_overflow": lambda P_: _vec(P_, -3e38) - _vec(P_, 3e38),
    "mul_overflow": lambda P_: _vec(P_, 1e20) * _vec(P_, 1e20),
    "mul_underflow": lambda P_: _vec(P_, 1e-37) * _vec(P_, 1e-37),
    "concat": lambda P_: _vec(P_, 1, 2).concat(_vec(P_, 3)),
    "concat_too_long": lambda P_: P_.Vector(np.ones(9000)).concat(
        P_.Vector(np.ones(9000))),
    "binary_quantize": lambda P_: _vec(P_, 1, -1, 0, 2).binary_quantize(),
    **{f"subvector{s}_{c}": (lambda P_, s=s, c=c:
                             _vec(P_, 1, 2, 3, 4, 5).subvector(s, c))
       for s, c in [(1, 3), (3, 2), (-1, 3), (3, 9), (1, 0), (9, 1)]},
    "compare": lambda P_: (
        _vec(P_, 1, 2, 3) < _vec(P_, 1, 2, 4),
        _vec(P_, 1, 2, 3) == P_.Vector.from_text("[1,2,3]"),
        _vec(P_, 1, 2) < _vec(P_, 1, 2, 0), _vec(P_, 2) > _vec(P_, 1, 9, 9),
        _vec(P_, 1, 2) <= _vec(P_, 1, 2), _vec(P_, 1, 2) >= _vec(P_, 1, 3),
        _vec(P_, 1, 2).compare(_vec(P_, 1, 2)),
        _vec(P_, 1) == P_.HalfVec([1])),
    "avg_sum": lambda P_: (
        P_.avg([_vec(P_, 1, 2), _vec(P_, 3, 4), _vec(P_, 5, 9)]),
        P_.vec_sum([_vec(P_, 1, 2), _vec(P_, 3, 4), _vec(P_, 5, 9)]),
        P_.avg([]), P_.vec_sum([])),
    "avg_dims": lambda P_: P_.avg([_vec(P_, 1, 2), _vec(P_, 1, 2, 3)]),
    "sum_overflow": lambda P_: P_.vec_sum([_vec(P_, 3e38), _vec(P_, 3e38)]),
    "agg_combine": lambda P_: (
        P_.VectorAggState().accum(_vec(P_, 1, 2)).accum(_vec(P_, 3, 4))
        .combine(P_.VectorAggState().accum(_vec(P_, 5, 9))).avg()),
    "agg_combine_empty": lambda P_: (
        P_.VectorAggState().combine(
            P_.VectorAggState().accum(_vec(P_, 5, 9))).sum_result(),
        P_.VectorAggState().accum(_vec(P_, 5, 9))
        .combine(P_.VectorAggState()).sum_result()),
    "agg_combine_dims": lambda P_: P_.VectorAggState().accum(
        _vec(P_, 1)).combine(P_.VectorAggState().accum(_vec(P_, 1, 2))),
    "hash_negative_zero": lambda P_: (
        _vec(P_, 0.0, 1.0) == _vec(P_, -0.0, 1.0),
        hash(_vec(P_, 0.0, 1.0)) == hash(_vec(P_, -0.0, 1.0)),
        len({_vec(P_, 0.0, 1.0), _vec(P_, -0.0, 1.0)})),
    "repr_tolist": lambda P_: (repr(_vec(P_, 1.5, -2)),
                               _vec(P_, 1.5, -2).tolist(), len(_vec(P_, 1, 2))),
}


@_cases(VECTOR_CASES)
def test_vector_goldens(case):
    _same(case)


# -- halfvec (test/sql/halfvec.sql, src/halfvec.c) ---------------------------
_HALF_LITERALS = [
    "[1,2,3]", "[-1,-2,-3]", " [ 1,  2 ,    3  ] ", "[1.5,0.25]",
    "[65504,-65504]", "[1e-8,1]", "[65520,1]", "[NaN,1]", "[Infinity,1]",
    "[]", "1,2,3", "[1.23456]", "[1,2,3]x",
]


def _half(pkg, *a):
    return pkg.HalfVec(list(a))


HALFVEC_CASES = {
    **{f"text{n}": (lambda P_, lit=lit: P_.HalfVec.from_text(lit).to_text())
       for n, lit in enumerate(_HALF_LITERALS)},
    "typmod_bad": lambda P_: P_.HalfVec.from_text("[1,2]", typmod=3),
    "ctor_overflow": lambda P_: _half(P_, 70000.0),
    "ctor_nan": lambda P_: _half(P_, float("nan")),
    "max_dim_text": lambda P_: P_.HalfVec.from_text(
        "[" + ",".join(["1"] * 16001) + "]"),
    "binary": lambda P_: P_.HalfVec.from_text("[1.5,-2.25,300]").to_binary(),
    "binary_roundtrip": lambda P_: P_.HalfVec.from_binary(
        P_.HalfVec.from_text("[1.5,-2.25,300]").to_binary()),
    "binary_short": lambda P_: P_.HalfVec.from_binary(b"\x00"),
    "binary_truncated": lambda P_: P_.HalfVec.from_binary(
        struct.pack(">hh", 5, 0) + b"\x00" * 4),
    "binary_unused": lambda P_: P_.HalfVec.from_binary(
        struct.pack(">hh", 1, 2) + b"\x3c\x00"),
    "distances": lambda P_: (
        _half(P_, 0, 0).l2_distance(_half(P_, 3, 4)),
        _half(P_, 1, 2).inner_product(_half(P_, 3, 4)),
        _half(P_, 1, 2).negative_inner_product(_half(P_, 3, 4)),
        _half(P_, 1, 0).cosine_distance(_half(P_, 0, 1)),
        _half(P_, 0, 0).l1_distance(_half(P_, 3, 4)),
        _half(P_, 1, 0).spherical_distance(_half(P_, 0, 1))),
    "seeded_distances": lambda P_: [
        (a.l2_squared_distance(b), a.inner_product(b), a.cosine_distance(b),
         a.l1_distance(b))
        for a, b in [(P_.HalfVec(x), P_.HalfVec(y)) for x, y in
                     np.random.default_rng(4).normal(size=(5, 2, 31))]],
    "dim_mismatch": lambda P_: _half(P_, 0, 0).l2_distance(_half(P_, 1, 2, 3)),
    "norm_normalize": lambda P_: (_half(P_, 3, 4).norm(),
                                  _half(P_, 3, 4).l2_normalize(),
                                  _half(P_, 0, 0).l2_normalize()),
    "arithmetic": lambda P_: (_half(P_, 1.5, 2) + _half(P_, 2, 3),
                              _half(P_, 1.5, 2) - _half(P_, 2, 3),
                              _half(P_, 1.5, 2) * _half(P_, 2, 3)),
    "add_overflow": lambda P_: _half(P_, 60000.0) + _half(P_, 60000.0),
    "mul_overflow": lambda P_: _half(P_, 300.0) * _half(P_, 300.0),
    "mul_underflow": lambda P_: _half(P_, 1e-4) * _half(P_, 1e-4),
    "casts": lambda P_: (P_.HalfVec.from_vector(P_.Vector([1.5, 2.25])),
                         P_.HalfVec.from_vector(
                             P_.Vector([1.5, 2.25])).to_vector()),
    "cast_overflow": lambda P_: P_.HalfVec.from_vector(P_.Vector([1e38])),
    "quantize_subvector_concat": lambda P_: (
        _half(P_, 1, -1, 0, 2).binary_quantize(),
        _half(P_, 1, -1, 0, 2).subvector(2, 2),
        _half(P_, 1).concat(_half(P_, 2))),
    "compare": lambda P_: (
        _half(P_, 1, 2) < _half(P_, 1, 3),
        _half(P_, 1, 2) == P_.HalfVec.from_text("[1,2]"),
        _half(P_, 1, 2) < _half(P_, 1, 2, 0),
        _half(P_, 1, 2) == P_.Vector([1, 2])),
    "hash_negative_zero": lambda P_: (
        _half(P_, 0.0) == _half(P_, -0.0),
        hash(_half(P_, 0.0)) == hash(_half(P_, -0.0))),
    "repr": lambda P_: repr(_half(P_, 1.5, 65504)),
}


@_cases(HALFVEC_CASES)
def test_halfvec_goldens(case):
    _same(case)


# -- sparsevec (test/sql/sparsevec.sql, src/sparsevec.c) ----------------------
_SPARSE_LITERALS = [
    "{1:1.5,3:3.5}/5", "{1:1,2:2,3:3}/3", " { 1 : 1.5 , 3 : 3.5 } / 5 ",
    "{}/5", "{3:1,1:2}/5", "{2:0,1:1}/5", "{0:1}/5", "{6:1}/5",
    "{1:1,1:2}/5", "{1:NaN}/5", "{1:Infinity}/5", "{1:1}/0", "1:1/5",
    "{1:1}/5x", "{1:1}", "{1:4e38}/5", "{1:1,}/5", "{a:1}/5", "{1:1}/",
    "{1 1}/5", "{1:1}/1000000001", "{-1:1}/5",
]


def _sv(pkg, lit):
    return pkg.SparseVec.from_text(lit)


SPARSEVEC_CASES = {
    **{f"text{n}": (lambda P_, lit=lit: _sv(P_, lit).to_text())
       for n, lit in enumerate(_SPARSE_LITERALS)},
    "typmod_bad": lambda P_: P_.SparseVec.from_text("{1:1}/5", typmod=6),
    "too_many_text": lambda P_: P_.SparseVec.from_text(
        "{" + ",".join(f"{i}:1" for i in range(1, 16002)) + "}/20000"),
    "binary": lambda P_: _sv(P_, "{1:1.5,100:-2}/1000").to_binary(),
    "binary_roundtrip": lambda P_: P_.SparseVec.from_binary(
        _sv(P_, "{1:1.5,100:-2}/1000").to_binary()),
    "binary_zero_value": lambda P_: P_.SparseVec.from_binary(
        struct.pack(">iii", 5, 1, 0) + struct.pack(">i", 0)
        + struct.pack(">f", 0.0)),
    "binary_unused": lambda P_: P_.SparseVec.from_binary(
        struct.pack(">iii", 5, 1, 7) + struct.pack(">i", 0)
        + struct.pack(">f", 1.0)),
    "binary_unsorted": lambda P_: P_.SparseVec.from_binary(
        struct.pack(">iii", 5, 2, 0) + struct.pack(">ii", 3, 1)
        + struct.pack(">ff", 1.0, 2.0)),
    "binary_typmod": lambda P_: P_.SparseVec.from_binary(
        _sv(P_, "{1:1}/5").to_binary(), typmod=4),
    "dense_roundtrip": lambda P_: (
        P_.SparseVec.from_dense(P_.Vector([0, 1.5, 0, -2, 0])),
        P_.SparseVec.from_dense(P_.Vector([0, 1.5, 0, -2, 0])).to_vector()),
    "distances_match_dense": lambda P_: [
        (sa.l2_distance(sb), sa.inner_product(sb), sa.l1_distance(sb),
         sa.cosine_distance(sb))
        for sa, sb in [(P_.SparseVec.from_dense(a), P_.SparseVec.from_dense(b))
                       for a, b in np.random.default_rng(0).normal(
                           size=(10, 2, 20))
                       * (np.random.default_rng(1).random((10, 2, 20)) < 0.4)]],
    "norm_normalize": lambda P_: (_sv(P_, "{1:3,2:4}/5").norm(),
                                  _sv(P_, "{1:3,2:4}/5").l2_normalize(),
                                  _sv(P_, "{}/5").l2_normalize()),
    "dim_mismatch": lambda P_: _sv(P_, "{1:1}/5").l2_distance(
        _sv(P_, "{1:1}/6")),
    "compare": lambda P_: (
        _sv(P_, "{1:1}/5") < _sv(P_, "{1:2}/5"),
        _sv(P_, "{2:1}/5") < _sv(P_, "{1:1}/5"),
        _sv(P_, "{}/5") < _sv(P_, "{}/6"),
        _sv(P_, "{1:1}/5") == _sv(P_, "{1:1}/5"),
        _sv(P_, "{1:-1}/5") < _sv(P_, "{}/5")),
    "max_nnz": lambda P_: P_.SparseVec(100000, np.arange(16001),
                                       np.ones(16001, np.float32)),
    "repr": lambda P_: repr(_sv(P_, "{1:1.5,3:-2}/5")),
}


@_cases(SPARSEVEC_CASES)
def test_sparsevec_goldens(case):
    _same(case)


# -- bit (test/sql/bit.sql) ---------------------------------------------------
BIT_CASES = {
    "text": lambda P_: (P_.Bit("10110").to_text(),
                        P_.Bit.from_text("0").to_text()),
    "bad_digit": lambda P_: P_.Bit("10210"),
    "hamming": lambda P_: (P_.Bit("1100").hamming_distance(P_.Bit("1001")),
                           P_.Bit("1111").hamming_distance(P_.Bit("1111"))),
    "jaccard": lambda P_: (P_.Bit("1100").jaccard_distance(P_.Bit("1001")),
                           P_.Bit("0000").jaccard_distance(P_.Bit("0000")),
                           P_.Bit("1111").jaccard_distance(P_.Bit("1111"))),
    "dim_mismatch": lambda P_: P_.Bit("1100").hamming_distance(P_.Bit("10011")),
    "packing": lambda P_: (
        P_.Bit(P_.Vector([1, -1, 0.5, 0, 2, -3, 1, 1, 1]).binary_quantize()),
        P_.Bit(P_.Vector([1, -1, 0.5, 0, 2, -3, 1, 1, 1])
               .binary_quantize()).to_bytes(),
        P_.Bit.from_bytes(bytes([0b10101011, 0b10000000]), 9)),
    "long_vectors": lambda P_: (
        P_.Bit(np.random.default_rng(7).random(1000) < 0.5).hamming_distance(
            P_.Bit(np.random.default_rng(8).random(1000) < 0.5)),
        P_.Bit(np.random.default_rng(7).random(1000) < 0.5).jaccard_distance(
            P_.Bit(np.random.default_rng(8).random(1000) < 0.5))),
}


@_cases(BIT_CASES)
def test_bit_goldens(case):
    _same(case)
