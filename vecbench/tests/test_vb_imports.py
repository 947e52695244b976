"""Nothing the benchmark loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``pgvector_tpu`` (compared whole: ``pgvector_tpu_torch``
begins with ``pgvector_tpu``), and the reference loads nothing of the
program.  Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from conftest import ROOT

TESTS = ROOT / "vecbench" / "tests"


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{TESTS}"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax_and_no_reference_package():
    mods = _modules(
        "import time\n"
        "from conftest import tiny_cell\n"
        "from vecbench.run import execute, forbidden_modules\n"
        "for name in ('sift1m.hnsw.ef40', 'sift1m.exact', 'sift1m.build'):\n"
        "    r, _, _ = execute(tiny_cell(name), 3, 0.2, True, 'cpu',\n"
        "                      t0=time.perf_counter())\n"
        "    assert r['correct'], r\n"
        "assert forbidden_modules() == [], forbidden_modules()\n")
    assert "pgvector_tpu_torch" in mods  # the system under test ran
    assert not mods & {"jax", "jaxlib", "flax", "pgvector_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import vecbench.reference, vecbench.judge, "
                    "vecbench.control, vecbench.data, vecbench.peaks")
    assert not mods & {"pgvector_tpu_torch", "pgvector_tpu", "jax"}


def test_forbidden_names_compared_whole():
    from vecbench import run

    before = dict(sys.modules)
    try:
        sys.modules["pgvector_tpu_torchx"] = object()
        sys.modules["jaxtyping"] = object()
        assert run.forbidden_modules() == sorted(
            {"jax", "jaxlib", "flax", "pgvector_tpu"}
            & {m.split(".", 1)[0] for m in before})
        sys.modules["jax.numpy"] = object()
        assert "jax" in run.forbidden_modules()
    finally:
        for m in ("pgvector_tpu_torchx", "jaxtyping", "jax.numpy"):
            if m not in before:
                sys.modules.pop(m, None)
