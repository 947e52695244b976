"""Meshes and collectives — counterpart of ``pgvector_tpu.parallel.mesh``.

The reference is single-controller SPMD: one Python process holds the
whole table and ``jax.shard_map`` places each shard on a device of a
``jax.sharding.Mesh``, with XLA inserting the collectives.  The port keeps
that model with no process group: one process launches each shard's work
on its device in turn, and the collectives are copies between devices in
shard order (:func:`all_gather`, :func:`psum`).  A fixed order makes a run
deterministic and a replicated result the same tensor wherever it lands.

A mesh's devices may repeat: ``[cpu] * 8`` is the counterpart of the
reference's 8-device virtual CPU mesh, and ``[cuda:0] * 4`` four shards
on one card.  Without a card and without ``devices`` a mesh is an error,
never a quiet CPU mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..errors import DataException


class Mesh:
    """An array of ``torch.device`` with named axes: the attributes the
    reference reads off ``jax.sharding.Mesh`` — ``devices`` (an object
    ndarray, one axis a name), ``axis_names``, ``shape`` (axis name →
    size) and ``size``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device array takes "
                             f"{arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis:
        where a 1-D shard's data lives (the other axes replicate it)."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        idx = tuple(slice(None) if a == axis else 0 for a in self.axis_names)
        return list(self.devices[idx])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _visible_cards() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise DataException(
            "no CUDA device: a mesh takes the visible cards by default; "
            'pass devices=[...] to name them (["cpu"] * 8 for a CPU mesh)')
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _take(devices, n: int) -> list:
    devs = list(_visible_cards() if devices is None else devices)
    if len(devs) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    return devs[:n]


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (default: the
    visible cards).  The axis shards table rows; queries replicate."""
    devs = list(_visible_cards() if devices is None else devices)
    if n_devices is not None:
        devs = _take(devs, n_devices)
    return Mesh(devs, (axis,))


def make_mesh2(n_shards: int, n_replicas: int = 1, axis: str = "shard",
               qaxis: str = "qp", devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D (row-shard × query-replica) mesh: index arrays shard over
    ``axis`` and replicate over ``qaxis``, and the query batch splits over
    ``qaxis`` — the serving fan-out, read QPS scaled by replicas of the
    same index with per-query work unchanged."""
    devs = _take(devices, n_shards * n_replicas)
    arr = np.empty(n_shards * n_replicas, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n_shards, n_replicas), (axis, qaxis))


def shard_rows(n: int, n_shards: int) -> list:
    """Contiguous row ranges per shard, balanced to ±1."""
    base = n // n_shards
    extra = n % n_shards
    out = []
    start = 0
    for s in range(n_shards):
        size = base + (1 if s < extra else 0)
        out.append((start, start + size))
        start += size
    return out


# ---------------------------------------------------------------------------
# collectives: copies between devices, in shard order
# ---------------------------------------------------------------------------


def to_device(x, device: torch.device):
    """``x`` (a tensor or a tuple of tensors) on ``device``; a tensor
    already there is returned as it is."""
    if isinstance(x, tuple):
        return tuple(to_device(t, device) for t in x)
    # a copy to the host waits for the data: non_blocking would hand back
    # a tensor the copy has not yet filled
    return x.to(device, non_blocking=device.type == "cuda")


def all_gather(parts: Sequence[torch.Tensor], device: torch.device,
               dim: int = 0) -> torch.Tensor:
    """The shards' tensors concatenated along ``dim`` in shard order, on
    ``device``."""
    return torch.cat([to_device(p, device) for p in parts], dim=dim)


def psum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the shards' tensors, added in shard order on ``device``
    (out of place: no shard's tensor changes)."""
    total = to_device(parts[0], device)
    for p in parts[1:]:
        total = total + to_device(p, device)
    return total
