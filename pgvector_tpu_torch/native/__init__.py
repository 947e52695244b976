"""Native (C++) bulk codec — counterpart of ``pgvector_tpu.native``,
ctypes-bound and compiled on demand.

The per-value semantics stay in the Python value layer (exact error
parity); the *bulk* load/dump path runs in C++ (``codec.cpp``, this
package's own copy): millions of literals a second, shortest-roundtrip
formatting through ``std::to_chars`` (the Ryu digits Postgres prints).

``load()`` compiles the library with ``g++`` at first use into the
package's ``_build/`` directory (beside the CUDA kernels' library, never
beside the source), rebuilt when a hash of the source and the flags
changes.  Without a toolchain the callers take the pure-Python codec,
as the reference's do; :func:`available` says which route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..errors import (
    DataException,
    InvalidTextRepresentation,
    NumericValueOutOfRange,
    ProgramLimitExceeded,
)

_SRC = Path(__file__).resolve().parent / "codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_PATH = BUILD_DIR / "libpgvt_codec.so"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_ERRORS = {
    1: (InvalidTextRepresentation, "invalid input syntax for type vector"),
    2: (DataException, "NaN not allowed in vector"),
    3: (DataException, "infinite value not allowed in vector"),
    4: (NumericValueOutOfRange, "value is out of range for type vector"),
    5: (DataException, "dimension mismatch"),
    6: (ProgramLimitExceeded, "vector cannot have more than 16000 dimensions"),
    7: (DataException, "vector must have at least 1 dimension"),
    8: (DataException, "insufficient data left in message"),
}


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return h.hexdigest()


def _compile() -> Optional[Path]:
    """The built library, compiled unless it matches the source; None when
    no toolchain can build it."""
    digest = _digest()
    stamp = BUILD_DIR / "libpgvt_codec.sha256"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"libpgvt_codec.{os.getpid()}.tmp.so"
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
        stamp.write_text(digest)
        return LIB_PATH
    except (OSError, subprocess.CalledProcessError):
        return None


def load() -> Optional[ctypes.CDLL]:
    """The codec library, or None when no toolchain is available."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _compile()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.pgv_parse_vectors.restype = ctypes.c_int
        lib.pgv_parse_vectors.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pgv_format_vectors.restype = ctypes.c_int64
        lib.pgv_format_vectors.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pgv_encode_binary.restype = ctypes.c_int64
        lib.pgv_encode_binary.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pgv_decode_binary.restype = ctypes.c_int
        lib.pgv_decode_binary.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return lib


def available() -> bool:
    return load() is not None


def parse_vectors(lits: List[str], expected_dim: int = -1,
                  max_dim: int = 16000) -> np.ndarray:
    """Bulk ``[a,b,...]`` parse → (count, dim) float32.  Native when
    possible, Python otherwise."""
    if not lits:
        # the C path's dim return can't tell "no rows" from its
        # expected_dim initializer
        return np.zeros((0, max(expected_dim, 0)), np.float32)
    lib = load()
    if lib is None:
        from ..types import Vector

        rows = [Vector.from_text(l, expected_dim).x for l in lits]
        return np.stack(rows) if rows else np.zeros((0, 0), np.float32)
    enc = [l.encode() for l in lits]
    buf = b"\0".join(enc) + b"\0"
    lens = np.fromiter((len(e) + 1 for e in enc), np.int64, len(enc))
    offsets = np.zeros(len(enc), np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    # first pass with a dim guess inferred from the first literal
    probe_dim = expected_dim if expected_dim > 0 else max(
        lits[0].count(",") + 1, 1)
    out = np.zeros((len(enc), probe_dim), np.float32)
    bad = ctypes.c_int64(-1)
    rc = lib.pgv_parse_vectors(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(enc), probe_dim if expected_dim > 0 else -1,
        min(probe_dim, max_dim) if expected_dim > 0 else max_dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(bad),
    )
    if rc < 0:
        exc, msg = _ERRORS.get(-rc, (DataException, "vector parse error"))
        row = int(bad.value)
        lit = lits[row] if 0 <= row < len(lits) else ""
        if -rc == 1:
            raise exc(f'invalid input syntax for type vector: "{lit}"')
        if -rc == 5:
            raise exc(f"different vector dimensions in row {row}")
        raise exc(msg)
    if rc != probe_dim:
        # the inferred dim differs from the guess; again with the exact dim
        return parse_vectors(lits, expected_dim=rc, max_dim=max_dim)
    return out[:, :rc] if rc else out


def format_vectors(arr: np.ndarray) -> List[str]:
    """Bulk (count, dim) float32 → ``[a,b,...]`` literals (Ryu-shortest)."""
    lib = load()
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    count, dim = arr.shape
    if lib is None:
        from ..types import Vector

        return [Vector(row, _checked=True).to_text() for row in arr]
    cap = count * (dim * 18 + 3) + 16
    out = ctypes.create_string_buffer(cap)
    offsets = np.zeros(count + 1, np.int64)
    total = lib.pgv_format_vectors(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count, dim,
        out, cap, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if total < 0:
        raise DataException("format buffer overflow")
    raw = out.raw
    o = offsets.tolist()
    # strip each literal's trailing NUL
    return [raw[o[i]: o[i + 1] - 1].decode() for i in range(count)]


def encode_binary(arr: np.ndarray) -> bytes:
    """Bulk vector_send wire format (big-endian rows)."""
    lib = load()
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    count, dim = arr.shape
    if lib is None:
        from ..types import Vector

        return b"".join(Vector(r, _checked=True).to_binary() for r in arr)
    out = np.zeros(count * (4 + 4 * dim), np.uint8)
    lib.pgv_encode_binary(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count, dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.tobytes()


def decode_binary(data: bytes, count: int) -> np.ndarray:
    """Bulk vector_recv wire decode — rows must share one dim."""
    lib = load()
    if lib is None or count == 0:
        from ..types import Vector

        out = []
        off = 0
        for _ in range(count):
            dim = int.from_bytes(data[off:off + 2], "big")
            rowlen = 4 + 4 * dim
            out.append(Vector.from_binary(data[off: off + rowlen]).x)
            off += rowlen
        return np.stack(out) if out else np.zeros((0, 0), np.float32)
    if len(data) < 2:
        raise DataException("insufficient data left in message")
    dim0 = int.from_bytes(data[0:2], "big")
    out = np.zeros((count, dim0), np.float32)
    bad = ctypes.c_int64(-1)
    buf = np.frombuffer(data, dtype=np.uint8)
    rc = lib.pgv_decode_binary(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data), count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.byref(bad),
    )
    if rc < 0:
        exc, msg = _ERRORS.get(-rc, (DataException, "vector decode error"))
        raise exc(msg)
    return out
