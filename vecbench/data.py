"""Rows and queries from the seed, made on the device in a few large calls.

The distribution is ``bench.py``'s ``make_data`` ("clustered", its
default), copied here: 1,024 centers drawn N(0, 1)·1.5, each row a random
center plus N(0, 1) noise, each query the same from its own draws.  Here
the centers are fixed by the configuration (``centers_seed``) and the
run's seed draws the rows and queries around them.  The
centers overlap, so a row's nearest neighbours cross cluster borders and
recall@10 moves with ef instead of saturating.  ``bench.py`` draws with
numpy on the host; this copy draws the same mixture with a
``torch.Generator`` on the device, so the numbers differ from
``bench.py``'s for the same seed and repeat exactly for one seed on one
device type.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one stream of draws (rows, queries, order) of a
    seed; any whole number is a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return g


def make_data(n: int, nq: int, dim: int, seed: int, device,
              dtype: torch.dtype = torch.float32, centers: int = 1024,
              center_scale: float = 1.5, centers_seed: int = 0):
    """(rows (n, dim), queries (nq, dim)) in ``dtype``: the seed's draws in
    f32, rounded once to the column's type.  The mixture's centers are the
    data set's shape and come from ``centers_seed``, so every seed draws
    its rows and queries from the same distribution and gives the system
    the same amount of work.  Rows and queries come from separate streams,
    so the query pool does not depend on ``n``."""
    gc = generator(centers_seed, 2, device)
    c = torch.randn((centers, dim), generator=gc, device=device) \
        * center_scale
    g = generator(seed, 0, device)
    assign = torch.randint(0, centers, (n,), generator=g, device=device)
    rows = torch.randn((n, dim), generator=g, device=device)
    rows += c[assign]
    gq = generator(seed, 1, device)
    qa = torch.randint(0, centers, (nq,), generator=gq, device=device)
    qs = torch.randn((nq, dim), generator=gq, device=device)
    qs += c[qa]
    return rows.to(dtype), qs.to(dtype)
