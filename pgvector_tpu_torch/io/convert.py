"""Reference state → port state.

``pgvector_tpu.io.checkpoint.save_hnsw`` writes an HNSW graph as numpy
arrays plus a manifest (checkpoint.py:225-274).  :func:`hnsw_from_numpy`
takes exactly those arrays and manifest fields and returns a port
:class:`~pgvector_tpu_torch.index.hnsw.HNSWIndex` holding the same graph,
so a graph built by either package is searched by the port; a checkpoint
reader only has to load the files.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..errors import DataException
from ..index.hnsw import HNSWIndex
from ..ops.metric import Metric
from ..store.table import DenseTable

#: the arrays and manifest fields save_hnsw writes for a dense index
HNSW_ARRAYS = ("nbr0", "nbr_up", "kept0", "kept_up", "up_slot", "levels",
               "elem_rows", "values0")
HNSW_FIELDS = ("m", "ef_construction", "entry", "entry_level", "n_elems",
               "n_upper", "nbr_up_width", "seed", "wave_size", "beam_expand",
               "backlink_mode")


def table_from_numpy(db: np.ndarray, valid: np.ndarray,
                     device=None) -> DenseTable:
    """A DenseTable on ``device`` holding rows ``db`` with validity
    ``valid`` (False = deleted row)."""
    db = np.asarray(db)
    table = DenseTable(db.shape[1], dtype=torch.float32,
                       capacity=max(len(db), 1), device=device)
    table.insert(db)
    table.valid[: len(db)] = torch.as_tensor(np.asarray(valid, dtype=bool),
                                             device=table.device)
    return table


def hnsw_from_numpy(table: DenseTable, arrays: Dict[str, np.ndarray],
                    meta: dict, device=None) -> HNSWIndex:
    """An HNSWIndex over ``table`` holding the graph in ``arrays`` (the
    ``save_hnsw`` arrays, sliced to ``n_elems`` / ``n_upper`` rows) and
    ``meta`` (its manifest, which also names the metric).  The index and
    its tensors live on ``device`` (default: the table's)."""
    missing = [a for a in HNSW_ARRAYS if a not in arrays] + \
        [f for f in HNSW_FIELDS if f not in meta]
    if missing:
        raise DataException(f"hnsw state lacks {', '.join(missing)}")
    if meta["backlink_mode"] != "wholesale":
        raise DataException(
            f'backlink_mode "{meta["backlink_mode"]}" is not ported yet')
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
                    backlink_mode=meta["backlink_mode"], dedup=False)
    while idx.cap_e < n:
        idx._grow()
    levels = np.asarray(arrays["levels"], np.int32)[:n]
    idx._ensure_unroll_depth(max(int(meta["nbr_up_width"]),
                                 int(levels.max(initial=0))))
    idx._alloc_upper_bulk(nu)  # grows nbr_up / kept_up to hold nu rows
    dev = idx.device
    idx.n_elems = n
    idx.entry, idx.entry_level = int(meta["entry"]), int(meta["entry_level"])
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
    # restored values are index-private, whatever they aliased when saved
    idx._alias_values = False
    idx.values = torch.zeros((idx.cap_e, table.dim), dtype=idx._val_dtype,
                             device=dev)
    idx.values[:n] = torch.tensor(np.asarray(arrays["values0"])[:n],
                                  device=dev).to(idx._val_dtype)
    idx._dirty = True
    idx._nbr_vals = None
    return idx
