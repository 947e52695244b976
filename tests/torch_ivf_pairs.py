"""Shared inputs of the IVFFlat parity tests (tests/test_torch_ivfflat.py,
tests/test_torch_ivf_kmeans.py): the reference's trained state in the
form ``io.checkpoint.save_ivfflat`` writes, tables filled alike in both
packages, and recall against exact neighbors.  Imports the reference
package, so only CPU tests use it."""

import jax.numpy as jnp
import numpy as np
import torch

from pgvector_tpu.index.ivfflat import IVFFlatIndex as JIVF
from pgvector_tpu.ops.metric import Metric as JMetric
from pgvector_tpu.store.table import DenseTable as JTable
from pgvector_tpu_torch import DenseTable
from pgvector_tpu_torch.io.convert import ivfflat_from_numpy, table_from_numpy

K, LISTS = 10, 20


def reference_data():
    """tests/test_ivfflat.py's set: 5,000 × 16 rows, 20 queries."""
    rng = np.random.default_rng(12)
    db = rng.normal(size=(5000, 16)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    return db, q


def reference_state(ref):
    """The arrays and manifest fields of io.checkpoint.save_ivfflat."""
    return ({"centroids_f32": np.asarray(ref.centroids_f32),
             "list_lens": ref.list_lens, "assignments": ref.assignments},
            {"metric": ref.metric.name, "lists": ref.lists, "seed": ref.seed,
             "is_bit": ref._is_bit})


def reference_on(jt, metric, centers):
    """A reference index over ``jt`` with given centers: the build's
    assign and load phases without k-means (as load_ivfflat does)."""
    ref = JIVF(jt, JMetric[metric], lists=len(centers), seed=1, build=False)
    ref.centroids = ref.centroids_f32 = centers
    ref._assign_all(np.flatnonzero(np.asarray(jt.valid[: jt.count])))
    return ref


def tables(db, dtype="float32"):
    """A reference table and a port table filled the same way (same
    capacity growth)."""
    jt = JTable(db.shape[1], dtype=jnp.dtype(dtype))
    jt.insert(db)
    tt = DenseTable(db.shape[1], dtype=getattr(torch, dtype), device="cpu")
    tt.insert(db)
    return jt, tt


def reference_pairs(db):
    """get(metric, deleted) → (reference index, port index over the
    reference's state), built on first use: the reference trains on
    ``db`` (lists 20, seed 1); ``deleted`` tables lose every 7th row
    after training, visible to searches before any vacuum."""
    cache = {}

    def get(metric, deleted=False):
        if (metric, False) not in cache:
            jt = JTable(db.shape[1])
            jt.insert(db)
            ref = JIVF(jt, JMetric[metric], lists=LISTS, seed=1)
            tt = table_from_numpy(db, np.ones(len(db), bool), device="cpu")
            cache[(metric, False)] = (
                ref, ivfflat_from_numpy(tt, *reference_state(ref)))
        if deleted and (metric, True) not in cache:
            ref0 = cache[(metric, False)][0]
            valid = np.ones(len(db), bool)
            valid[::7] = False
            jt = JTable(db.shape[1])
            rows = jt.insert(db)
            jt.delete(rows[~valid])
            # the reference's load_ivfflat path: same centers, same lists
            ref = JIVF(jt, JMetric[metric], lists=LISTS, seed=1, build=False)
            ref.centroids = ref.centroids_f32 = ref0.centroids_f32
            ref._load_postings(ref0.assignments.copy())
            tt = table_from_numpy(db, valid, device="cpu")
            cache[(metric, True)] = (
                ref, ivfflat_from_numpy(tt, *reference_state(ref0)))
        return cache[(metric, deleted)]

    return get


def recall(r, gt):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                    for a, b in zip(r, gt)])


def exact_topk(metric, db, q):
    """Exact top-K row ids by the metric's order (numpy, stable ties)."""
    if metric == "L2":
        s = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    elif metric == "IP":
        s = -(q @ db.T)
    else:
        s = -(q @ db.T) / np.linalg.norm(q, axis=1)[:, None] \
            / np.linalg.norm(db, axis=1)[None, :]
    return np.argsort(s, axis=1, kind="stable")[:, :K]
