"""Checkpoints — counterpart of ``pgvector_tpu.io.checkpoint``, in the
same directory format, so either package reads what the other writes.

A checkpoint is a directory:

    manifest.json      — magic "pgvector-tpu", format version 1, epoch,
                         object kind and parameters
    <name>.<epoch>.npy — one file per array; bfloat16 arrays are stored as
                         their uint16 bit patterns under
                         <name>.<epoch>.bf16.npy (numpy has no bfloat16)

Saves are crash-atomic: the array files are written under a fresh epoch
and fsynced, then ``manifest.json`` is replaced atomically (tmp + fsync +
``os.replace``), then the directory is fsynced and older epochs' files are
removed.  A crash leaves either the previous epoch or the new one.

The port holds dense, bit and sparse tables, HNSW graphs over each (with
or without heap-TID dedup, either backlink mode, vacuumed or not) and
dense and bit IVFFlat indexes.  Bit words are written as the reference's
uint32 arrays.  A checkpoint of another kind of table raises
:class:`~pgvector_tpu_torch.errors.FeatureNotSupported`; none is loaded
into something that answers differently.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..errors import DataException, FeatureNotSupported
from ..ops.metric import Metric
from ..store.table import BitTable, DenseTable, SparseTable
from .convert import (as_tensor, hnsw_from_numpy, ivfflat_from_numpy,
                      words_as_int32)

MAGIC = "pgvector-tpu"
FORMAT_VERSION = 1

# <name>.<epoch>.npy / <name>.<epoch>.bf16.npy, or the legacy <name>.npy
_ARRAY_RE = re.compile(r"^(?P<name>.+?)(?:\.(?P<epoch>\d+))?(?P<tag>\.bf16)?\.npy$")

#: table dtypes by their manifest names (numpy's names, as the reference
#: writes them)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms that cannot open directories
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _begin_save(path: str) -> int:
    """Create the directory and pick the next epoch: one past anything in
    the manifest or on disk, so a crashed save's orphans are never
    overwritten."""
    os.makedirs(path, exist_ok=True)
    epoch = 0
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            epoch = int(json.load(f).get("epoch", 0))
    except (OSError, ValueError):
        pass
    for fn in os.listdir(path):
        m = _ARRAY_RE.match(fn)
        if m and m.group("epoch"):
            epoch = max(epoch, int(m.group("epoch")))
    return epoch + 1


def _write_manifest(path: str, payload: Dict[str, Any], epoch: int) -> None:
    """Commit point: publish the manifest of ``epoch`` atomically, then
    remove every other epoch's array files (best effort)."""
    payload = dict(payload, magic=MAGIC, version=FORMAT_VERSION, epoch=epoch)
    final = os.path.join(path, "manifest.json")
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(path)
    for fn in os.listdir(path):
        m = _ARRAY_RE.match(fn)
        if m and (m.group("epoch") or "0") != str(epoch):
            try:
                os.remove(os.path.join(path, fn))
            except OSError:
                pass


def _read_manifest(path: str, kind: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
    except FileNotFoundError:
        raise DataException(
            f"invalid checkpoint at {path!r}: no manifest "
            "(interrupted first save, or not a checkpoint directory)")
    except ValueError:
        raise DataException(f"invalid checkpoint at {path!r}: corrupt manifest")
    if m.get("magic") != MAGIC:
        raise DataException("invalid checkpoint: bad magic")
    if m.get("version") != FORMAT_VERSION:
        raise DataException(f"unsupported checkpoint version {m.get('version')}")
    if m.get("object") != kind:
        article = "a" if kind == "table" else "an"
        raise DataException(f'expected {article} {kind} checkpoint, '
                            f'found "{m.get("object")}"')
    return m


def _array_name(name: str, epoch: Optional[int], tagged: bool) -> str:
    tag = ".bf16" if tagged else ""
    if epoch:
        return f"{name}.{epoch}{tag}.npy"
    return f"{name}{tag}.npy"  # legacy layout without epochs


def _save_arrays(path: str, arrays: Dict[str, Any], epoch: int) -> None:
    for name, arr in arrays.items():
        tagged = torch.is_tensor(arr) and arr.dtype == torch.bfloat16
        if tagged:
            a = arr.detach().cpu().contiguous().view(torch.int16).numpy() \
                .view(np.uint16)
        elif torch.is_tensor(arr):
            a = arr.detach().cpu().numpy()
        else:
            a = np.asarray(arr)
        fn = os.path.join(path, _array_name(name, epoch, tagged))
        np.save(fn, a)
        _fsync_file(fn)


def _load(path: str, name: str, epoch: int):
    """A numpy array, or a CPU bfloat16 tensor for a ``.bf16`` file."""
    tagged = os.path.join(path, _array_name(name, epoch, True))
    if os.path.exists(tagged):
        bits = np.load(tagged).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    try:
        return np.load(os.path.join(path, _array_name(name, epoch, False)))
    except FileNotFoundError:
        raise DataException(f"checkpoint at {path!r} lacks the array {name!r}")


def _dtype_name(dtype: torch.dtype) -> str:
    return next(k for k, v in _DTYPES.items() if v == dtype)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def _words(t: torch.Tensor) -> np.ndarray:
    """Packed bit words as the reference's uint32 array."""
    return t.detach().cpu().numpy().view(np.uint32)


def save_table(table, path: str) -> None:
    n = table.count
    if isinstance(table, DenseTable):
        kind, arrays = "dense", {"data": table.data[:n]}
        extra = {"dim": table.dim, "dtype": _dtype_name(table.dtype)}
    elif isinstance(table, BitTable):
        kind, arrays = "bit", {"data": _words(table.data[:n])}
        extra = {"dim": table.dim}
    elif isinstance(table, SparseTable):
        kind = "sparse"
        arrays = {"idx": table.idx[:n], "val": table.val[:n]}
        extra = {"dim": table.dim, "nnz_cap": table.nnz_cap}
    else:
        raise DataException(f"cannot checkpoint {type(table).__name__}")
    epoch = _begin_save(path)
    arrays["valid"] = table.valid[:n]
    _save_arrays(path, arrays, epoch)
    _write_manifest(path, {"object": "table", "kind": kind, "count": n,
                           **extra}, epoch)


def load_table(path: str, device=None):
    """The table of a checkpoint, on ``device`` (default: the card, as
    every table)."""
    m = _read_manifest(path, "table")
    count, ep = int(m["count"]), m.get("epoch", 0)
    cap = max(count, 8)
    if m["kind"] == "dense":
        if m["dtype"] not in _DTYPES:
            raise FeatureNotSupported(
                f'dense tables of {m["dtype"]} are not ported yet')
        dtype = _DTYPES[m["dtype"]]
        table = DenseTable(int(m["dim"]), dtype=dtype, capacity=cap,
                           device=device)
        if count:
            table.data[:count] = as_tensor(_load(path, "data", ep),
                                           table.device, dtype)
            table.count = count
    elif m["kind"] == "bit":
        table = BitTable(int(m["dim"]), capacity=cap, device=device)
        if count:
            table.insert_words(words_as_int32(_load(path, "data", ep)))
    elif m["kind"] == "sparse":
        table = SparseTable(int(m["dim"]), nnz_cap=int(m["nnz_cap"]),
                            capacity=cap, device=device)
        if count:
            table.insert_arrays(_load(path, "idx", ep), _load(path, "val", ep),
                                _checked=True)
    else:
        raise FeatureNotSupported(
            f'{m["kind"]} table checkpoints are not ported yet')
    if count:
        table.valid[:count] = as_tensor(_load(path, "valid", ep),
                                        table.device, torch.bool)
    return table


# ---------------------------------------------------------------------------
# indexes
# ---------------------------------------------------------------------------


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return int(v) if isinstance(v, np.integer) else v


def save_hnsw(idx, path: str) -> None:
    """The graph arrays and manifest of the reference's ``save_hnsw``:
    ``values0`` (and, for sparse, ``values1``) are the index's value
    arrays."""
    epoch = _begin_save(path)
    n, nu = idx.n_elems, idx.n_upper
    arrays = {
        "nbr0": idx.nbr0[:n], "nbr_up": idx.nbr_up[:nu],
        "kept0": idx.kept0[:n], "kept_up": idx.kept_up[:nu],
        "up_slot": idx.up_slot[:n], "levels": idx.levels[:n],
        "elem_rows": idx.elem_rows[:n]}
    for j, v in enumerate(idx._value_arrays()):
        arrays[f"values{j}"] = _words(v[:n]) if idx.kind == "bit" else v[:n]
    _save_arrays(path, arrays, epoch)
    _write_manifest(path, {
        "object": "hnsw", "kind": idx.kind, "metric": idx.metric.name,
        "m": idx.m, "ef_construction": idx.ef_construction,
        "n_elems": n, "n_upper": nu,
        "nbr_up_width": int(idx.nbr_up.shape[1]),
        "entry": idx.entry, "entry_level": idx.entry_level,
        "free_slots": [int(e) for e in idx.free_slots], "seed": idx.seed,
        "rng_state": _plain(idx._rng.bit_generator.state),
        "wave_size": idx.wave_size, "beam_expand": idx.beam_expand,
        "backlink_mode": idx.backlink_mode, "dedup": idx.dedup,
    }, epoch)


def load_hnsw(table, path: str):
    """The graph of an HNSW checkpoint over ``table`` (dense, bit or
    sparse, on its device): dedup or not, either backlink mode, vacuumed
    (with free slots) or not."""
    m = _read_manifest(path, "hnsw")
    ep = m.get("epoch", 0)
    arrays = {}
    names = ("nbr0", "nbr_up", "kept0", "kept_up", "up_slot", "levels",
             "elem_rows", "values0")
    if m.get("kind") == "sparse":
        names += ("values1",)
    for name in names:
        arrays[name] = _load(path, name, ep)
    meta = dict(m)
    meta.setdefault("nbr_up_width", int(arrays["nbr_up"].shape[1]))
    meta.setdefault("wave_size", 1024)
    meta.setdefault("beam_expand", 1)
    meta.setdefault("backlink_mode", "wholesale")
    idx = hnsw_from_numpy(table, arrays, meta)
    if "rng_state" in m:
        idx._rng.bit_generator.state = m["rng_state"]
    return idx


def save_ivfflat(idx, path: str) -> None:
    """The trained centers, list lengths and row assignments; the
    postings are derived state, rebuilt at load."""
    epoch = _begin_save(path)
    _save_arrays(path, {"centroids_f32": idx.centroids,
                        "list_lens": idx.list_lens,
                        "assignments": idx.assignments}, epoch)
    _write_manifest(path, {"object": "ivfflat", "metric": idx.metric.name,
                           "lists": idx.lists, "seed": idx.seed,
                           "is_bit": idx._is_bit}, epoch)


def load_ivfflat(table, path: str):
    """The IVFFlat index of a checkpoint over ``table`` (a DenseTable, or
    a BitTable for a bit index; on its device).  The f32 centers are
    stored; the postings are rebuilt from the assignments."""
    m = _read_manifest(path, "ivfflat")
    ep = m.get("epoch", 0)
    arrays = {name: _load(path, name, ep)
              for name in ("centroids_f32", "list_lens", "assignments")}
    return ivfflat_from_numpy(table, arrays, {
        "metric": Metric[m["metric"]], "lists": m["lists"],
        "seed": m["seed"], "is_bit": bool(m.get("is_bit", False))})
