"""Cells cut to a size the CPU runs in seconds, through the same harness."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(name: str, rows: int = 4096, dim: int = 16):
    """The cell ``name`` at ``rows`` x ``dim``, with requests of 64 queries
    over a pool of 4 batches (index builds: batches of 512 rows, 256 check
    queries) and a traced stretch of 2 requests from the second."""
    from vecbench import spec

    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.workload = copy.deepcopy(cell.workload)
    cell.config.update(rows=rows, dim=dim)
    cell.config["index"]["capacity"] = rows
    wl = cell.workload
    if "request_queries" in wl:
        wl.update(request_queries=64, pool_batches=4)
    if "batch_rows" in wl:
        wl.update(batch_rows=512, check_queries=256)
    wl["trace"] = {"after": 1, "count": 2}
    return cell


@pytest.fixture
def tiny():
    return tiny_cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time,
    never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
