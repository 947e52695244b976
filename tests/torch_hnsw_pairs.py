"""Shared helpers of the port's HNSW tests: a reference index's state as
the arrays and manifest fields ``io.checkpoint.save_hnsw`` writes, that
state loaded into the port, tables holding the same rows in both
packages, equal bookkeeping, recall, and level-0 list agreement."""

import numpy as np


def reference_state(idx):
    """The arrays and manifest fields of io.checkpoint.save_hnsw."""
    n, nu = idx.n_elems, idx.n_upper
    arrays = {
        "nbr0": np.asarray(idx.nbr0[:n]),
        "nbr_up": np.asarray(idx.nbr_up[:nu]),
        "kept0": np.asarray(idx.kept0[:n]),
        "kept_up": np.asarray(idx.kept_up[:nu]),
        "up_slot": idx.up_slot[:n],
        "levels": idx.levels[:n],
        "elem_rows": idx.elem_rows[:n],
        "values0": np.asarray(idx.values[0][:n]),
    }
    meta = {
        "metric": idx.metric.name, "m": idx.m,
        "ef_construction": idx.ef_construction, "n_elems": n,
        "n_upper": nu, "nbr_up_width": int(idx.nbr_up.shape[1]),
        "entry": idx.entry, "entry_level": idx.entry_level,
        "free_slots": list(idx.free_slots), "seed": idx.seed,
        "wave_size": idx.wave_size, "beam_expand": idx.beam_expand,
        "backlink_mode": idx.backlink_mode, "dedup": idx.dedup,
    }
    return arrays, meta


def port_of(ref, table):
    """The reference index ``ref`` loaded into the port over ``table``,
    its level draws going on where the reference's stand."""
    from pgvector_tpu_torch.io.convert import hnsw_from_numpy

    port = hnsw_from_numpy(table, *reference_state(ref))
    port._rng.bit_generator.state = ref._rng.bit_generator.state
    return port


def recall(r, gt):
    """Mean share of each row of ``gt``'s live ids found in ``r``."""
    out = []
    for a, b in zip(np.asarray(r), np.asarray(gt)):
        b = set(int(x) for x in b if x >= 0)
        out.append(len(set(int(x) for x in a if x >= 0) & b) / max(len(b), 1))
    return float(np.mean(out))


def list_overlap(a, b, rows):
    """Per row of ``rows``, the share of the live ids of ``b``'s neighbor
    list that ``a``'s list holds too."""
    out = []
    for x in rows:
        sa, sb = set(a[x][a[x] >= 0].tolist()), set(b[x][b[x] >= 0].tolist())
        out.append(len(sa & sb) / max(len(sb), 1))
    return np.asarray(out)


def same_lists(a, b, rows=None):
    """Share of ``rows`` (default all) whose neighbor lists hold the same
    ids as sets in the two (n, w) arrays."""
    a, b = np.sort(np.asarray(a), axis=1), np.sort(np.asarray(b), axis=1)
    if rows is not None:
        a, b = a[rows], b[rows]
    return float((a == b).all(axis=1).mean())


def tables(db, capacity=1024):
    """The same rows in a reference table and a port table (CPU)."""
    from pgvector_tpu.store.table import DenseTable as JTable
    from pgvector_tpu_torch import DenseTable

    jt = JTable(db.shape[1], capacity=capacity)
    jt.insert(db)
    tt = DenseTable(db.shape[1], capacity=capacity, device="cpu")
    tt.insert(db)
    return jt, tt


def insert_both(jt, tt, rows):
    """Append the same rows to both tables; their row ids."""
    r0, r1 = jt.insert(rows), tt.insert(rows)
    np.testing.assert_array_equal(r0, r1)
    return r1


def assert_same_books(ref, port):
    """Element bookkeeping equal in the two packages."""
    n = ref.n_elems
    assert (port.n_elems, port.n_upper) == (n, ref.n_upper)
    np.testing.assert_array_equal(port.elem_rows[:n], ref.elem_rows[:n])
    np.testing.assert_array_equal(port.levels[:n], ref.levels[:n])
    np.testing.assert_array_equal(port.up_slot[:n], ref.up_slot[:n])
    assert port.live_elements == ref.live_elements
    assert port.row_to_elem == ref.row_to_elem
    assert port.free_slots == ref.free_slots
    assert port._dup_index == ref._dup_index
    assert (port.entry, port.entry_level) == (ref.entry, ref.entry_level)
