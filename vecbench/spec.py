"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``workloads/<cell>.json``,
``kinds/<kind>.py`` and ``metrics/<metric>.py``."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


@dataclass
class Cell:
    name: str
    entry: dict      # the cell's entry of BENCHMARK.json
    config: dict     # configs/<config>.json
    workload: dict   # workloads/<cell>.json
    bench: dict      # the whole of BENCHMARK.json

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: with ``trace`` its per-layer
        metrics, else its end-to-end ones.  A metric without ``workloads``
        belongs to every cell that reports the end-to-end metric it
        moves (or, end to end, to every cell)."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        mine = {m["name"] for m in e2e}

        def belongs(m):
            if "workloads" in m:
                return self.name in m["workloads"]
            return m["moves"] in mine

        return [m for m in self.bench["per_layer"] if belongs(m)]


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"vecbench: no cell {name!r} in BENCHMARK.json "
                         f"(cells: {', '.join(sorted(entries))})")
    entry = entries[name]
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    for key in ("config", "traffic", "chips"):
        if workload.get(key) != entry[key]:
            raise SystemExit(f"vecbench: workloads/{name}.json says {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(name, entry, config, workload, bench)


def _load_module(path: Path, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``: a module with ``read(run)`` returning the
    metric's value, or None where the run holds nothing to read."""
    tag = "vecbench.metrics." + metric.replace(".", "_").replace("-", "_")
    return _load_module(HERE / "metrics" / f"{metric}.py", tag)


def kind(name: str) -> ModuleType:
    """``kinds/<name>.py``: ``setup``, ``window``, ``check`` (module
    docstring of :mod:`vecbench.kinds`)."""
    return importlib.import_module(f"vecbench.kinds.{name}")
