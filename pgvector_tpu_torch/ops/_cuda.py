"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, ``_build/
libpgvt_kernels.so``, which is loaded with ``ctypes``.  The build runs at
the first kernel launch and again whenever a hash of the sources and flags
changes; nothing is built when the package is imported.  Each C entry
point launches on the stream it is given and returns the
``cudaGetLastError()`` of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libpgvt_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signatures: every pointer and the stream as c_void_p, ints as c_int
_SIGNATURES = {
    # qs, db, dbsq, nq, n, d, k, splits, tiles_per_split,
    # part_d, part_i, out_d, out_i, stream
    "pgvt_fused_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P],
    # pool_d, pool_p, cand_d, cand_i, q, ef, w, out_d, out_p, stream
    "pgvt_hop_tail": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
#: seconds the last build in this process took (None: no build ran)
build_seconds = None


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the kernels unless the library matches the sources."""
    global build_seconds
    digest = _digest()
    stamp = BUILD_DIR / "libpgvt_kernels.sha256"
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libpgvt_kernels.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    # ptxas -v reports registers, shared memory and spills per kernel
    (BUILD_DIR / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def check_tensor(t, name: str, dtype, ndim: int) -> None:
    """The kernels take contiguous CUDA tensors of one dtype and rank."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
