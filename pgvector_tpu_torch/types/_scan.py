"""Shared literal scanning / shortest-decimal formatting for the type layer;
a copy of ``pgvector_tpu.types._scan`` (the port imports nothing of the
JAX package).

Mirrors the hand-rolled scanners in the reference (src/vector.c:176-326,
src/sparsevec.c:203-423) and Postgres's Ryu shortest-decimal printer
(float_to_shortest_decimal_bufn, used at src/vector.c:291-293): the printed
form is the shortest decimal string that round-trips to the same float32,
using scientific notation outside a fixed exponent window.
"""

from __future__ import annotations

import math
import re
from typing import Optional, Tuple

import numpy as np

from ..errors import InvalidTextRepresentation, NumericValueOutOfRange

# Whitespace set used by the reference scanners (src/vector.c:151-163).
_SPACE = " \t\n\r\v\f"

# strtof-compatible number token: decimal/scientific, inf/infinity/nan,
# and hex floats.  Case-insensitive, like C strtof.
_NUM_RE = re.compile(
    r"""
    [+-]?
    (?:
        # hex float FIRST: regex alternation is ordered, so the decimal
        # branch would otherwise claim the leading '0' of '0x1p+1' and
        # leave the rest as junk
        0[xX][0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?(?:[pP][+-]?\d+)?  # hex float
      | (?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?   # decimal
      | [iI][nN][fF](?:[iI][nN][iI][tT][yY])?  # inf / infinity
      | [nN][aA][nN]                           # nan
    )
    """,
    re.VERBOSE,
)


def skip_space(s: str, i: int) -> int:
    while i < len(s) and s[i] in _SPACE:
        i += 1
    return i


def strtof(s: str, i: int) -> Tuple[Optional[float], int, str]:
    """C-strtof analogue: parse a float64 starting at offset ``i``.

    Returns (value, end_offset, matched_text); value is None when nothing
    matched (stringEnd == pt in the reference, src/vector.c:230-233).
    The caller narrows to f32/f16 and applies range checks.
    """
    m = _NUM_RE.match(s, i)
    if m is None:
        return None, i, ""
    text = m.group(0)
    low = text.lower().lstrip("+-")
    if low.startswith("inf"):
        val = math.inf if not text.startswith("-") else -math.inf
    elif low.startswith("nan"):
        val = math.nan
    elif low.startswith("0x"):
        val = float.fromhex(text)
    else:
        val = float(text)  # never raises for decimal within regex; huge → inf
    return val, m.end(), text


def narrow_f32(val: float, text: str, type_name: str) -> np.float32:
    """float64 → float32 with the reference's ERANGE semantics
    (src/vector.c:240-243): overflow of a finite literal errors; underflow
    to zero/denormal is silently accepted."""
    with np.errstate(over="ignore"):
        f = np.float32(val)
    if np.isinf(f) and math.isfinite(val):
        raise NumericValueOutOfRange(
            f'"{text}" is out of range for type {type_name}'
        )
    return f


def narrow_f16(val: float, text: str, type_name: str) -> np.float16:
    """float64 → float16 with checked rounding (Float4ToHalf overflow error,
    src/halfutils.h:244-261)."""
    with np.errstate(over="ignore"):
        h = np.float16(val)
    if np.isinf(h) and math.isfinite(val):
        raise NumericValueOutOfRange(
            f'"{text}" is out of range for type {type_name}'
        )
    return h


def bad_literal(type_name: str, lit: str, detail: str = "") -> InvalidTextRepresentation:
    msg = f'invalid input syntax for type {type_name}: "{lit}"'
    if detail:
        msg += f"\nDETAIL:  {detail}"
    return InvalidTextRepresentation(msg)


def format_f32(x) -> str:
    """Shortest-roundtrip decimal for a float32, Postgres float4out style:
    plain notation for decimal exponents in [-4, 15), otherwise scientific
    ``de+XX`` with a two-digit exponent.  Matches the golden outputs in
    the reference's test/expected/vector_type.out (e.g. ``1.5e+38``,
    ``-0``, ``1.23456``)."""
    f = np.float32(x)
    if f == 0:
        return "-0" if np.signbit(f) else "0"
    # shortest unique digits for this float32
    sci = np.format_float_scientific(f, unique=True, trim="-")
    mant, _, exp_s = sci.partition("e")
    exp = int(exp_s)
    neg = mant.startswith("-")
    digits = mant.lstrip("-").replace(".", "")
    if -4 <= exp < 15:
        if exp >= len(digits) - 1:
            body = digits + "0" * (exp - len(digits) + 1)
        elif exp >= 0:
            body = digits[: exp + 1] + "." + digits[exp + 1:]
        else:
            body = "0." + "0" * (-exp - 1) + digits
        return ("-" if neg else "") + body
    mant_out = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return ("-" if neg else "") + f"{mant_out}e{'+' if exp >= 0 else '-'}{abs(exp):02d}"


def format_f16(x) -> str:
    """halfvec_out converts half → float4 and prints with the float32
    shortest printer (src/halfvec.c:290-330 via HalfToFloat4), so 65504
    prints as ``65504``, not the f16-shortest ``6.55e+04``."""
    return format_f32(np.float32(np.float16(x)))
