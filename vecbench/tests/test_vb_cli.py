"""The command as the check runs it: no result without a card; on the card
(``-m cuda``), one result line with the contract's keys."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(*args, env=None, timeout=900):
    return subprocess.run([sys.executable, "-m", "vecbench.run", *args],
                          capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run("--workload", "sift1m.exact", "--seed", "1", "--seconds",
               "1", env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_one_run_on_the_card(cuda_device):
    out = _run("--workload", "sift1m.exact", "--seed", str(2**31 + 21),
               "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"exact_qps", "exact_p95_ms", "setup_s"}
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
