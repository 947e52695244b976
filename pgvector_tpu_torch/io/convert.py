"""Reference state → port state.

``pgvector_tpu.io.checkpoint`` writes an index as numpy arrays plus a
manifest: ``save_hnsw`` a graph (checkpoint.py:225-274), ``save_ivfflat``
the trained centers and each row's list (:390-404).
:func:`hnsw_from_numpy` and :func:`ivfflat_from_numpy` take exactly those
arrays and manifest fields and return a port index holding the same
state, so an index built by either package is searched by the port;
:mod:`.checkpoint` only reads and writes the files.  A 16-bit array may
come as a CPU ``torch.bfloat16`` tensor (numpy has no bfloat16); packed
bit words come as the reference's uint32 (or the port's int32) arrays.
:func:`table_from_numpy`, :func:`bit_table_from_numpy` and
:func:`sparse_table_from_numpy` fill a table from arrays in bulk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..errors import DataException
from ..index.hnsw import HNSWIndex, _dup_keys, _host_rows
from ..index.ivfflat import IVFFlatIndex
from ..ops.metric import Metric
from ..store.table import BitTable, DenseTable, SparseTable

#: the arrays and manifest fields save_hnsw writes (a sparse index also
#: writes ``values1``, the values beside ``values0``'s indices)
HNSW_ARRAYS = ("nbr0", "nbr_up", "kept0", "kept_up", "up_slot", "levels",
               "elem_rows", "values0")
HNSW_FIELDS = ("m", "ef_construction", "entry", "entry_level", "n_elems",
               "n_upper", "nbr_up_width", "seed", "wave_size", "beam_expand",
               "backlink_mode")

#: the arrays and manifest fields save_ivfflat writes
IVFFLAT_ARRAYS = ("centroids_f32", "list_lens", "assignments")
IVFFLAT_FIELDS = ("metric", "lists", "seed", "is_bit")


def as_tensor(a, device, dtype=None) -> torch.Tensor:
    """A copy of ``a`` (numpy array, or tensor such as a bf16 one) on
    ``device``; numpy arrays may be read-only views."""
    t = a if torch.is_tensor(a) else torch.tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype, copy=True)


def table_from_numpy(db: np.ndarray, valid: np.ndarray,
                     device=None) -> DenseTable:
    """A DenseTable on ``device`` (default: the card, as every table)
    holding rows ``db`` with validity ``valid`` (False = deleted row)."""
    db = np.asarray(db)
    table = DenseTable(db.shape[1], dtype=torch.float32,
                       capacity=max(len(db), 1), device=device)
    table.insert(db)
    table.valid[: len(db)] = torch.as_tensor(np.asarray(valid, dtype=bool),
                                             device=table.device)
    return table


def words_as_int32(a) -> torch.Tensor:
    """Packed bit words (uint32 or int32, numpy or tensor) as an int32
    tensor with the same bit patterns."""
    if torch.is_tensor(a):
        return a.to(torch.int32)
    return torch.from_numpy(np.array(a, copy=True).view(np.int32))


def bit_table_from_numpy(words, dim: int, valid: np.ndarray,
                         device=None) -> BitTable:
    """A BitTable of ``dim`` bits on ``device`` (default: the card)
    holding packed rows ``words`` (N, ceil(dim/32)), uint32 or int32,
    with validity ``valid``."""
    words = words_as_int32(words)
    table = BitTable(dim, capacity=max(len(words), 1), device=device)
    table.insert_words(words)
    table.valid[: len(words)] = torch.as_tensor(
        np.asarray(valid, dtype=bool), device=table.device)
    return table


def sparse_table_from_numpy(idx, val, dim: int, valid: np.ndarray,
                            nnz_cap: int = 0, device=None) -> SparseTable:
    """A SparseTable on ``device`` (default: the card) holding padded CSR
    rows ``idx`` / ``val`` (N, P): ascending distinct indices padded with
    SPARSE_PAD, non-zero values, 0 at the pads; ``nnz_cap`` defaults to
    P."""
    idx = torch.as_tensor(idx, dtype=torch.int32)
    table = SparseTable(dim, nnz_cap=nnz_cap or idx.shape[1],
                        capacity=max(len(idx), 1), device=device)
    table.insert_arrays(idx, val)
    table.valid[: len(idx)] = torch.as_tensor(
        np.asarray(valid, dtype=bool), device=table.device)
    return table


def hnsw_from_numpy(table, arrays: Dict[str, np.ndarray],
                    meta: dict, device=None) -> HNSWIndex:
    """An HNSWIndex over ``table`` (dense, bit or sparse, as the
    manifest's ``kind``) holding the graph in ``arrays`` (the
    ``save_hnsw`` arrays, sliced to ``n_elems`` / ``n_upper`` rows) and
    ``meta`` (its manifest, which also names the metric).  ``dedup``
    defaults to True and ``free_slots`` to none, as in the reference's
    loader; ``row_to_elem`` and the dedup keys are rebuilt from the arrays
    as that loader rebuilds them.  The index and its tensors live on
    ``device`` (default: the table's)."""
    missing = [a for a in HNSW_ARRAYS if a not in arrays] + \
        [f for f in HNSW_FIELDS if f not in meta]
    if missing:
        raise DataException(f"hnsw state lacks {', '.join(missing)}")
    kind = meta.get("kind", "dense")
    want = {"dense": DenseTable, "bit": BitTable, "sparse": SparseTable}
    if not isinstance(table, want.get(kind, ())):
        raise DataException(
            f"an hnsw graph over a {kind} table cannot index "
            f"{type(table).__name__}")
    if kind == "sparse" and "values1" not in arrays:
        raise DataException("hnsw state lacks values1")
    if device is not None and torch.device(device) != table.device:
        raise DataException("the index lives on its table's device")
    metric = meta["metric"]
    metric = Metric[metric] if isinstance(metric, str) else metric
    n, nu = int(meta["n_elems"]), int(meta["n_upper"])
    idx = HNSWIndex(table, metric, m=int(meta["m"]),
                    ef_construction=int(meta["ef_construction"]),
                    seed=int(meta["seed"]), build=False,
                    wave_size=int(meta["wave_size"]),
                    beam_expand=int(meta["beam_expand"]),
                    backlink_mode=meta["backlink_mode"],
                    dedup=bool(meta.get("dedup", True)))
    while idx.cap_e < n:
        idx._grow()
    levels = np.asarray(arrays["levels"], np.int32)[:n]
    idx._ensure_unroll_depth(max(int(meta["nbr_up_width"]),
                                 int(levels.max(initial=0))))
    idx._alloc_upper_bulk(nu)  # grows nbr_up / kept_up to hold nu rows
    dev = idx.device
    idx.n_elems = n
    idx.entry, idx.entry_level = int(meta["entry"]), int(meta["entry_level"])
    idx.free_slots = [int(e) for e in meta.get("free_slots", [])]
    idx.levels[:n] = levels
    idx.up_slot[:n] = np.asarray(arrays["up_slot"], np.int32)[:n]
    idx.elem_rows[:n] = np.asarray(arrays["elem_rows"], np.int32)[:n]
    # torch.tensor copies: the arrays may be read-only views
    idx.nbr0[:n] = torch.tensor(np.asarray(arrays["nbr0"], np.int32)[:n],
                                device=dev)
    idx.kept0[:n] = torch.tensor(np.asarray(arrays["kept0"], bool)[:n],
                                 device=dev)
    width = idx.nbr_up.shape[1]
    for name, fill in (("nbr_up", -1), ("kept_up", False)):
        a = np.asarray(arrays[name])[:nu]
        # a narrower saved depth pads with empty levels, a wider one holds
        # only empty tail levels
        if a.shape[1] < width:
            pad = np.full((nu, width - a.shape[1], idx.m), fill, a.dtype)
            a = np.concatenate([a, pad], axis=1)
        getattr(idx, name)[:nu] = torch.tensor(a[:, :width], device=dev)
    # restored values are index-private, whatever they aliased when saved:
    # fresh (cap, ...) arrays of the free-slot fill
    idx._alias_values = False
    if kind == "dense":
        saved = [as_tensor(arrays["values0"][:n], dev, idx._val_dtype)]
    elif kind == "bit":
        saved = [words_as_int32(arrays["values0"][:n]).to(dev)]
    else:
        saved = [as_tensor(arrays[f"values{j}"][:n], dev) for j in (0, 1)]
    fresh = []
    for a, f in zip(saved, idx._value_fills()):
        full = a.new_full((idx.cap_e,) + tuple(a.shape[1:]), f)
        full[:n] = a
        fresh.append(full)
    idx._set_value_arrays(fresh)
    # each row's element, the last element holding it winning, as the
    # reference's loader fills it element by element
    er = idx.elem_rows[:n]
    e_of, slot = np.nonzero(er >= 0)
    idx.row_to_elem = dict(zip(er[e_of, slot].tolist(), e_of.tolist()))
    if idx.dedup and n:
        live = np.flatnonzero(levels >= 0)
        keys = _dup_keys(_host_rows(tuple(a[:n]
                                          for a in idx._value_arrays())))
        idx._dup_index = {keys[e]: int(e) for e in live}
    idx._dirty = True
    idx._drop_packed()
    return idx


def ivfflat_from_numpy(table, arrays: Dict[str, np.ndarray],
                       meta: dict) -> IVFFlatIndex:
    """An IVFFlatIndex over ``table`` with the trained centers and row
    assignments of ``arrays`` (the ``save_ivfflat`` arrays) and ``meta``
    (its manifest).  The postings and the posting-ordered value copy are
    rebuilt from the assignments, as the reference's ``load_ivfflat``
    does; the index lives on the table's device."""
    missing = [a for a in IVFFLAT_ARRAYS if a not in arrays] + \
        [f for f in IVFFLAT_FIELDS if f not in meta]
    if missing:
        raise DataException(f"ivfflat state lacks {', '.join(missing)}")
    if bool(meta["is_bit"]) != isinstance(table, BitTable):
        raise DataException(
            f"an ivfflat index with is_bit={bool(meta['is_bit'])} cannot "
            f"index {type(table).__name__}")
    metric = meta["metric"]
    metric = Metric[metric] if isinstance(metric, str) else metric
    idx = IVFFlatIndex(table, metric, lists=int(meta["lists"]),
                       seed=int(meta["seed"]), build=False)
    centers = as_tensor(arrays["centroids_f32"], table.device, torch.float32)
    if tuple(centers.shape) != (idx.lists, table.dim):
        raise DataException(
            f"ivfflat centers of shape {tuple(centers.shape)} do not fit "
            f"{idx.lists} lists of {table.dim} dimensions")
    idx.centroids = centers
    idx._load_postings(np.asarray(arrays["assignments"], np.int64).copy())
    if not np.array_equal(idx.list_lens,
                          np.asarray(arrays["list_lens"], np.int64)):
        raise DataException("ivfflat list_lens disagree with assignments")
    return idx
