"""vecbench — the benchmark of ``pgvector_tpu_torch`` on NVIDIA GPUs.

One command runs one cell once, from the root of a checkout::

    python3 -m vecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's table and query pool on the card from ``--seed``,
sets the system up (kernels, table, index, warm-up), drives it for
``--seconds`` as one closed-loop client, judges the answers of the window
against a plain exact reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, the metrics, ``device`` and the numbers
compared beside their limits (``checks``).

Everything is found by name, so a cell or a metric is added as files:

- ``BENCHMARK.json`` (the checkout's root): the cells and which metrics
  each reports;
- ``vecbench/configs/<config>.json``: one deployment (shapes, index
  parameters, the guarantees it states);
- ``vecbench/workloads/<cell>.json``: one traffic mix (its kind, request
  sizes, pool, what is traced) and the limits of its checks;
- ``vecbench/kinds/<kind>.py``: one way of driving the system;
- ``vecbench/metrics/<metric>.py``: one metric's reader.

The benchmark imports neither ``jax`` nor ``pgvector_tpu``; the reference
(:mod:`vecbench.reference`) imports nothing of ``pgvector_tpu_torch``.
"""
