"""The port stands alone: with ``jax`` made unimportable, importing
``pgvector_tpu_torch`` and running a 2,000-row build and search on the CPU
succeeds, and neither ``jax`` nor ``pgvector_tpu`` is loaded."""

import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import pgvector_tpu_torch as P

    rng = np.random.default_rng(0)
    db = rng.normal(size=(2000, 8)).astype(np.float32)
    table = P.DenseTable(8)
    table.insert(db)
    idx = P.HNSWIndex(table, P.Metric.L2, m=8, ef_construction=32,
                      wave_size=512, beam_expand=4, dedup=False)
    d, r = idx.search(db[:5], 3, ef_search=32)
    assert (r[:, 0] == np.arange(5)).all(), r
    d, r = P.FlatIndex(table, P.Metric.L2).search(db[:5], 3)
    assert (r[:, 0] == np.arange(5)).all(), r
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "pgvector_tpu")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print("ok")
""")


def test_port_runs_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
