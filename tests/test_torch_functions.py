"""The SQL function surface through both packages: every function and cast
of ``pgvector_tpu.functions`` over the value types' golden values
(test/sql/functions.sql, cast.sql; tests/test_functions_planner.py), run
on the reference and on ``pgvector_tpu_torch.functions``.  A case returns
the same text and the same numbers exactly (host-side numpy arithmetic in
both), or raises the same exception class with the same message."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

import pgvector_tpu as Jpkg
import pgvector_tpu_torch as Ppkg
from pgvector_tpu import functions as JF
from pgvector_tpu_torch import functions as PF

J = SimpleNamespace(F=JF, Vector=Jpkg.Vector, HalfVec=Jpkg.HalfVec,
                    SparseVec=Jpkg.SparseVec, Bit=Jpkg.Bit)
P = SimpleNamespace(F=PF, Vector=Ppkg.Vector, HalfVec=Ppkg.HalfVec,
                    SparseVec=Ppkg.SparseVec, Bit=Ppkg.Bit)


def _norm(v):
    if isinstance(v, (Jpkg.Vector, Jpkg.HalfVec, Jpkg.SparseVec, Jpkg.Bit,
                      Ppkg.Vector, Ppkg.HalfVec, Ppkg.SparseVec, Ppkg.Bit)):
        return (type(v).__name__, v.to_text())
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.tolist())
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    return v


def _outcome(case, ns):
    try:
        return ("ok", _norm(case(ns)))
    except Exception as exc:  # noqa: BLE001 — the class is the result
        return ("raise", type(exc).__name__, str(exc))


_RNG = np.random.default_rng(11)
_A, _B = _RNG.normal(size=(2, 17)).astype(np.float32)
_SA = np.where(_RNG.random(17) < 0.6, 0.0, _A).astype(np.float32)
_SB = np.where(_RNG.random(17) < 0.6, 0.0, _B).astype(np.float32)
_DIST = ("l2_distance", "inner_product", "negative_inner_product",
         "cosine_distance", "l1_distance")


def _vals(ns, kind, a, b):
    if kind == "vector":
        return ns.Vector(a), ns.Vector(b)
    if kind == "halfvec":
        return ns.HalfVec(a), ns.HalfVec(b)
    return ns.SparseVec.from_dense(a), ns.SparseVec.from_dense(b)


CASES = {
    # distances over every type with an overload, golden and seeded
    **{f"{fn}_{kind}_golden": (
        lambda ns, fn=fn, kind=kind: getattr(ns.F, fn)(
            *_vals(ns, kind, [0, 1, 2], [3, 4, 0])))
       for fn in _DIST for kind in ("vector", "halfvec", "sparsevec")},
    **{f"{fn}_{kind}_seeded": (
        lambda ns, fn=fn, kind=kind: getattr(ns.F, fn)(
            *_vals(ns, kind, _SA, _SB)))
       for fn in _DIST for kind in ("vector", "halfvec", "sparsevec")},
    "l2_mismatch": lambda ns: ns.F.l2_distance(ns.Vector([1, 2]),
                                               ns.HalfVec([1, 2])),
    "ip_mismatch": lambda ns: ns.F.inner_product(
        ns.Vector([1, 2]), ns.SparseVec.from_dense([1, 2])),
    "cosine_mismatch": lambda ns: ns.F.cosine_distance(
        ns.HalfVec([1, 2]), ns.SparseVec.from_dense([1, 2])),
    "l1_mismatch": lambda ns: ns.F.l1_distance(ns.SparseVec.from_dense([1]),
                                               ns.Vector([1])),
    "dim_mismatch": lambda ns: ns.F.l2_distance(ns.Vector([1, 2]),
                                                ns.Vector([1, 2, 3])),
    "cosine_zero": lambda ns: ns.F.cosine_distance(ns.Vector([0, 0]),
                                                   ns.Vector([1, 1])),
    "hamming": lambda ns: (ns.F.hamming_distance(ns.Bit("1100"),
                                                 ns.Bit("1001")),
                           ns.F.hamming_distance(ns.Bit("111"),
                                                 ns.Bit("111"))),
    "jaccard": lambda ns: (ns.F.jaccard_distance(ns.Bit("1111"),
                                                 ns.Bit("1111")),
                           ns.F.jaccard_distance(ns.Bit("1100"),
                                                 ns.Bit("1010")),
                           ns.F.jaccard_distance(ns.Bit("000"),
                                                 ns.Bit("000"))),
    "bit_dim_mismatch": lambda ns: ns.F.hamming_distance(ns.Bit("11"),
                                                         ns.Bit("111")),
    # norms and utilities
    **{f"norm_{kind}": (lambda ns, kind=kind: (
        ns.F.l2_norm(_vals(ns, kind, [3, 4], [0, 0])[0]),
        ns.F.vector_norm(_vals(ns, kind, _A, _B)[0])))
       for kind in ("vector", "halfvec", "sparsevec")},
    **{f"l2_normalize_{kind}": (lambda ns, kind=kind: (
        ns.F.l2_normalize(_vals(ns, kind, [3, 4], [0, 0])[0]),
        ns.F.l2_normalize(_vals(ns, kind, [0, 0], [0, 0])[0]),
        ns.F.l2_normalize(_vals(ns, kind, _SA, _SB)[0])))
       for kind in ("vector", "halfvec", "sparsevec")},
    "vector_dims": lambda ns: (
        ns.F.vector_dims(ns.Vector([1, 2, 3])),
        ns.F.vector_dims(ns.HalfVec([1, 2])),
        ns.F.vector_dims(ns.SparseVec.from_dense([0, 1, 0, 0])),
        ns.F.vector_dims(ns.Bit("10101"))),
    "binary_quantize": lambda ns: (
        ns.F.binary_quantize(ns.Vector([1, -1, 0, 2])),
        ns.F.binary_quantize(ns.HalfVec([-1, 0.5])),
        ns.F.binary_quantize(ns.Vector(_A))),
    **{f"subvector_{s}_{c}": (lambda ns, s=s, c=c: (
        ns.F.subvector(ns.Vector([1, 2, 3, 4, 5]), s, c),
        ns.F.subvector(ns.HalfVec([1, 2, 3, 4, 5]), s, c)))
       for s, c in [(1, 3), (3, 2), (-1, 3), (3, 9), (1, 0), (9, 1)]},
    "concat": lambda ns: (ns.F.concat(ns.Vector([1]), ns.Vector([2, 3])),
                          ns.F.concat(ns.HalfVec([1]), ns.HalfVec([2]))),
    "concat_mismatch": lambda ns: ns.F.concat(ns.Vector([1]),
                                              ns.HalfVec([2])),
    "concat_too_long": lambda ns: ns.F.concat(
        ns.Vector(np.ones(9000)), ns.Vector(np.ones(9000))),
    "to_float4": lambda ns: (ns.F.to_float4(ns.Vector([0, 1.5, 0])),
                             ns.F.to_float4(ns.HalfVec([0.1, 65504])),
                             ns.F.to_float4(ns.Vector(_A))),
    # aggregates
    "avg_sum_vector": lambda ns: (
        ns.F.avg([ns.Vector([1, 2]), ns.Vector([3, 4]), ns.Vector([5, 9])]),
        ns.F.sum_([ns.Vector([1, 2]), ns.Vector([3, 4])])),
    "avg_sum_halfvec": lambda ns: (
        ns.F.avg([ns.HalfVec([1, 2]), ns.HalfVec([3, 4])]),
        ns.F.sum_([ns.HalfVec([1, 2]), ns.HalfVec([3, 4])]),
        ns.F.avg([ns.HalfVec(r) for r in _RNG.normal(size=(0, 3))])),
    "avg_seeded": lambda ns: (
        ns.F.avg([ns.Vector(r) for r in
                  np.random.default_rng(5).normal(size=(9, 6))]),
        ns.F.avg([ns.HalfVec(r) for r in
                  np.random.default_rng(5).normal(size=(9, 6))])),
    "avg_empty": lambda ns: (ns.F.avg([]), ns.F.sum_([])),
    "avg_dims_vector": lambda ns: ns.F.avg([ns.Vector([1, 2]),
                                            ns.Vector([1, 2, 3])]),
    "avg_dims_halfvec": lambda ns: ns.F.avg([ns.HalfVec([1, 2]),
                                             ns.HalfVec([1, 2, 3])]),
    "sum_overflow_vector": lambda ns: ns.F.sum_([ns.Vector([3e38]),
                                                 ns.Vector([3e38])]),
    "sum_overflow_halfvec": lambda ns: ns.F.sum_([ns.HalfVec([60000]),
                                                  ns.HalfVec([60000])]),
    "avg_halfvec_no_overflow": lambda ns: ns.F.avg([ns.HalfVec([60000]),
                                                    ns.HalfVec([60000])]),
    "half_agg_combine": lambda ns: (
        ns.F._HalfAgg().accum(ns.HalfVec([1, 2])).combine(
            ns.F._HalfAgg().accum(ns.HalfVec([3, 5]))).avg(),
        ns.F._HalfAgg().combine(
            ns.F._HalfAgg().accum(ns.HalfVec([3, 5]))).sum_result(),
        ns.F._HalfAgg().accum(ns.HalfVec([3, 5])).combine(
            ns.F._HalfAgg()).sum_result(),
        ns.F._HalfAgg().avg(), ns.F._HalfAgg().sum_result()),
    # casts (sql/vector.sql:234-250, 688-710, 1081-1106)
    "to_vector": lambda ns: (
        ns.F.to_vector(ns.Vector([1, 2])),
        ns.F.to_vector(ns.HalfVec([0, 1.5, 0])),
        ns.F.to_vector(ns.SparseVec.from_dense([0, 1.5, 0])),
        ns.F.to_vector([1, 2, 3]), ns.F.to_vector("[1,2]"),
        ns.F.to_vector(np.arange(4, dtype=np.float64)),
        ns.F.to_vector([1, 2, 3], typmod=3)),
    "to_vector_typmod": lambda ns: ns.F.to_vector([1, 2, 3], typmod=4),
    "to_vector_text_typmod": lambda ns: ns.F.to_vector("[1,2]", typmod=3),
    "to_vector_nan": lambda ns: ns.F.to_vector([1.0, float("nan")]),
    "to_vector_inf": lambda ns: ns.F.to_vector([1.0, float("inf")]),
    "to_vector_overflow": lambda ns: ns.F.to_vector([1e39, 1.0]),
    "to_vector_2d": lambda ns: ns.F.to_vector([[1, 2], [3, 4]]),
    "to_vector_bad_text": lambda ns: ns.F.to_vector("[1,x]"),
    "to_halfvec": lambda ns: (
        ns.F.to_halfvec(ns.HalfVec([1, 2])),
        ns.F.to_halfvec(ns.Vector([0, 1.5, 0])),
        ns.F.to_halfvec(ns.SparseVec.from_dense([0, 1.5, 0])),
        ns.F.to_halfvec("[1,2]"), ns.F.to_halfvec([0.1, 0.2]),
        ns.F.to_halfvec(ns.Vector(_A))),
    "to_halfvec_overflow": lambda ns: ns.F.to_halfvec([70000.0]),
    "to_halfvec_vector_overflow": lambda ns: ns.F.to_halfvec(
        ns.Vector([70000.0])),
    "to_halfvec_typmod": lambda ns: ns.F.to_halfvec([1, 2], typmod=3),
    "to_halfvec_2d": lambda ns: ns.F.to_halfvec([[1.0]]),
    "to_sparsevec": lambda ns: (
        ns.F.to_sparsevec(ns.Vector([0, 1.5, 0])),
        ns.F.to_sparsevec(ns.HalfVec([0, 0, 2])),
        ns.F.to_sparsevec(ns.SparseVec.from_dense([1, 0])),
        ns.F.to_sparsevec("{1:1.5}/3"), ns.F.to_sparsevec([0, 0, 3]),
        ns.F.to_sparsevec(ns.Vector(_SA))),
    "to_sparsevec_typmod": lambda ns: ns.F.to_sparsevec([0, 1], typmod=3),
    "to_sparsevec_text_typmod": lambda ns: ns.F.to_sparsevec(
        "{1:1}/3", typmod=4),
    "to_bit": lambda ns: (
        ns.F.to_bit(ns.Bit("101")), ns.F.to_bit(ns.Vector([1, -2, 3])),
        ns.F.to_bit(ns.HalfVec([-1, 0, 1])), ns.F.to_bit("0110"),
        ns.F.to_bit([True, False, True])),
    "to_bit_bad_text": lambda ns: ns.F.to_bit("01x"),
}


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
def test_function_matches_reference(case):
    ref, port = _outcome(case, J), _outcome(case, P)
    assert port == ref, (ref, port)


def test_cases_cover_every_function():
    """Every public callable of the reference's module has a case."""
    names = {n for n in dir(JF) if not n.startswith("_")
             and callable(getattr(JF, n)) and getattr(
                 getattr(JF, n), "__module__", "") == JF.__name__}
    with open(__file__) as f:
        src = f.read()
    covered = {n for n in names if n in _DIST or f"ns.F.{n}(" in src}
    assert names - covered == set(), names - covered
    assert {n for n in dir(PF) if not n.startswith("_")} >= names
