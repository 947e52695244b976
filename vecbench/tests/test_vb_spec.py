"""BENCHMARK.json and the files it names: present, loadable, within the
contract's limits, and consistent with each other."""

import importlib.util
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
VB = ROOT / "vecbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w
               for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200
    assert entry["file"] == f"vecbench/configs/{entry['name']}.json"
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    # every key cut from the source is listed, with the published value
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) or k == "dim"
                   for k in entry["reduced"]), "a width is never cut"
    for k, cut in cfg["reduced"].items():
        assert cfg[k] == cut["here"] and cut["published"] != cut["here"]
    assert entry["name"] in {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(entry):
    from vecbench import spec

    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for k in ("name", "config", "traffic"):
        assert NAME.match(entry[k])
    assert entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cell = spec.load_cell(entry["name"], BENCH)  # files found by name
    assert (VB / "kinds" / f"{cell.workload['kind']}.py").is_file()
    e2e = {m["name"] for m in cell.metrics(trace=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics(trace=True), "at least one per-layer metric"


def test_cells_unique_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len(set(CELLS)) == len(CELLS)
    assert 1 <= len(CELLS) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric(m):
    from vecbench import spec

    per_layer = m in BENCH["per_layer"]
    keys = {"name", "unit", "better", "source"}
    keys |= {"layer", "moves"} if per_layer else {"bound"}
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert spec.reader(m["name"]).read  # metrics/<name>.py, found by name
    if per_layer:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for c in m.get("workloads", []):
        assert c in CELLS


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_reported_by_its_cells(m):
    """Each per-layer metric moves an end-to-end metric that every cell it
    names reports."""
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for c in m["workloads"]:
        assert c in e2e[m["moves"]].get("workloads", CELLS)


def test_names_unique_and_setup_s():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_one_layer_name_per_layer():
    """Metrics of one layer name it letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    folded = {x.lower().replace(" ", "") for x in layers}
    assert len(folded) == len(layers)


def test_every_file_named_from_name_characters():
    for p in VB.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_metric_readers_load_alone():
    for p in (VB / "metrics").glob("*.py"):
        spec_ = importlib.util.spec_from_file_location("m", p)
        mod = importlib.util.module_from_spec(spec_)
        spec_.loader.exec_module(mod)
        assert callable(mod.read)
