"""The halfvec searches of ``chip_smoke.py``'s phase 9 alone, for
comparing two trees in one call on one card.

    cd <root of a checkout> && python <path>/tools/halfvec_searches.py

It imports ``pgvector_tpu_torch`` from the working directory, so run as
a file from the root of each checkout (an earlier tree, then this one)
it measures that checkout's package.  On ``bench.make_data(200_000,
8_000, dim=960, seed=7)``'s rows (:func:`.k1_breakdown.clustered`, the
same values) in a bf16 table: the
exact top-10 (FlatIndex), the HNSW build (m 16, ef_construction 64, wave
1,024, build beam 4, dedup off), then with query beam 8 three timed
searches of the 8,000 queries at ef 40 and 100 (after one warm-up each)
over the bf16 slab ``auto`` picks and then the int8 slab
(``PGVECTOR_TPU_PACKED_SCAN=int8``): QPS of each, recall@10.  Prints one
JSON line.
"""
import json
import os
import sys
import time

import numpy as np
import torch


def main():
    sys.path.insert(0, os.getcwd())  # the checkout run from
    from pgvector_tpu_torch import DenseTable, FlatIndex, HNSWIndex, Metric
    from pgvector_tpu_torch.tools.k1_breakdown import clustered

    dev = torch.device("cuda", 0)
    gdb, gqs = clustered(200_000, 8000, dim=960, seed=7)
    table = DenseTable(960, dtype=torch.bfloat16, capacity=200_000, device=dev)
    table.insert(gdb)
    _, gt = FlatIndex(table, Metric.L2).search(gqs, 10)
    t0 = time.perf_counter()
    idx = HNSWIndex(table, Metric.L2, m=16, ef_construction=64,
                    wave_size=1024, dedup=False, beam_expand=4)
    out = {"root": os.getcwd(), "build_s": time.perf_counter() - t0}
    idx.beam_expand = 8
    for tier in ("bf16", "int8"):
        if tier == "int8":
            os.environ["PGVECTOR_TPU_PACKED_SCAN"] = "int8"
            idx._drop_packed()
        for ef in (40, 100):
            idx.search(gqs, 10, ef_search=ef)
            torch.cuda.synchronize()
            qps = []
            for _ in range(3):
                t0 = time.perf_counter()
                _, r = idx.search(gqs, 10, ef_search=ef)
                qps.append(len(gqs) / (time.perf_counter() - t0))
            rec = float(np.mean([len(set(a.tolist()) & set(b.tolist()))
                                 for a, b in zip(r, gt)]) / 10)
            out[f"{tier}_ef{ef}"] = {"qps": qps, "recall_at_10": rec,
                                     "slab": str(idx._nbr_vals.dtype)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
