"""The port stands alone: with ``jax`` made unimportable, importing
``pgvector_tpu_torch`` and running 2,000-row HNSW and IVFFlat builds and
searches on the CPU (HNSW also through the int8 packed tier), a
binary-quantized index, bit IVFFlat, a sparse HNSW index, the grouped
exact engine over a bf16 table, the value types' text and binary I/O and
aggregates, with checkpoint round trips, and the SQL-facing surface (a
Relation loaded by COPY through the native codec, its HNSW and btree
indexes, the planner, EXPLAIN ANALYZE, the batching executor, a
replication log replayed onto a replica, the SQL functions) and the mesh
paths (sharded and dim-sharded exact search, a device-sharded HNSW index
and the mesh build on four CPU shards; no mesh without a card or named
devices) succeeds, and neither ``jax`` nor ``pgvector_tpu`` is loaded.
Building the codec writes only under the port's own build directory."""

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
    table = P.DenseTable(8, device="cpu")
    table.insert(db)
    idx = P.HNSWIndex(table, P.Metric.L2, m=8, ef_construction=32,
                      wave_size=512, beam_expand=4, dedup=False)
    d, r = idx.search(db[:5], 3, ef_search=32)
    assert (r[:, 0] == np.arange(5)).all(), r
    d, r = P.FlatIndex(table, P.Metric.L2).search(db[:5], 3)
    assert (r[:, 0] == np.arange(5)).all(), r
    import os
    os.environ["PGVECTOR_TPU_PACKED_SCAN"] = "int8"
    d, r = idx.search(db[:5], 3, ef_search=32)
    assert idx._nbr_vals.dtype == torch.int8, idx._nbr_vals.dtype
    assert (r[:, 0] == np.arange(5)).all(), r
    del os.environ["PGVECTOR_TPU_PACKED_SCAN"]
    half = P.DenseTable(8, dtype=torch.bfloat16, device="cpu")
    half.insert(rng.normal(size=(5000, 8)).astype(np.float32))
    flat = P.FlatIndex(half, P.Metric.COSINE)
    d, r = flat.search(db[:3], 5)
    assert flat.last_path == "grouped" and (r >= 0).all(), (flat.last_path, r)
    v = P.Vector.from_text("[1,2.5,-3]")
    assert P.Vector.from_binary(v.to_binary()) == v == P.avg([v, v])
    h = P.HalfVec.from_text("[1,65504]")
    assert P.HalfVec.from_binary(h.to_binary()).to_text() == "[1,65504]"
    s = P.SparseVec.from_text("{2:1.5}/3")
    assert P.SparseVec.from_binary(s.to_binary()).to_text() == "{2:1.5}/3"

    import tempfile
    from pgvector_tpu_torch.io import checkpoint
    ivf = P.IVFFlatIndex(table, P.Metric.L2, lists=10, seed=1)
    d, r = ivf.search(db[:5], 3, probes=10)
    assert (r[:, 0] == np.arange(5)).all(), r
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_table(table, tmp + "/t")
        checkpoint.save_ivfflat(ivf, tmp + "/i")
        checkpoint.save_hnsw(idx, tmp + "/h")
        t2 = checkpoint.load_table(tmp + "/t", device="cpu")
        d2, r2 = checkpoint.load_ivfflat(t2, tmp + "/i").search(
            db[:5], 3, probes=10)
        assert (r2 == r).all() and np.allclose(d2, d), (r, r2)
        assert checkpoint.load_hnsw(t2, tmp + "/h").n_elems == 2000
    # the bit and sparse kinds and the re-rank pipelines
    bq = P.BinaryQuantizedIndex(table, m=8, ef_construction=32,
                                wave_size=512, beam_expand=4)
    d, r = bq.search(db[:5], 3)
    assert (r[:, 0] == np.arange(5)).all(), r
    bits = P.BitTable(8, device="cpu")
    bits.insert(db > 0)
    bivf = P.IVFFlatIndex(bits, P.Metric.HAMMING, lists=4, seed=1)
    d, r = bivf.search(db[:5] > 0, 3, probes=4)
    assert (d[:, 0] == 0).all(), d
    sp = P.SparseTable(8, nnz_cap=8, device="cpu")
    sp.insert([P.SparseVec.from_dense(v) for v in db[:300]])
    sidx = P.HNSWIndex(sp, P.Metric.L2, m=8, ef_construction=32)
    q = [P.SparseVec.from_dense(v) for v in db[:3]]
    d, r = sidx.search(q, 3)
    assert (r[:, 0] == np.arange(3)).all(), r
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_table(sp, tmp + "/s")
        checkpoint.save_hnsw(sidx, tmp + "/sh")
        s2 = checkpoint.load_table(tmp + "/s", device="cpu")
        _, r2 = checkpoint.load_hnsw(s2, tmp + "/sh").search(q, 3)
        assert (r2 == r).all(), (r, r2)
    # the SQL-facing surface
    from pgvector_tpu_torch import functions, native, planner
    from pgvector_tpu_torch.io import copy as pcopy
    from pgvector_tpu_torch.io import replication
    from pgvector_tpu_torch.runtime import BatchingExecutor
    assert native.available()
    rel = P.Relation(P.DenseTable(8, device="cpu"))
    pcopy.copy_in_binary(rel, pcopy.copy_out_binary(table))
    pcopy.copy_in_text(rel, pcopy.copy_out_text(table)[:10])
    h = rel.create_index("hnsw", P.Metric.L2, m=8, ef_construction=32,
                         wave_size=512, beam_expand=4)
    bt = rel.create_index("btree")
    assert bt.search_eq(db[7]).tolist() == [7, 2007]
    d, r = rel.knn(db[:5], 3, ef_search=32)
    assert (np.isin(r[:, 0], [0, 1, 2, 3, 4, 2000, 2001, 2002, 2003, 2004])
            ).all(), r
    assert "Index Searches: 1" in rel.explain(analyze=True, q=db[0], k=3)
    assert planner.choose_path(rel.table, rel.indexes, P.Metric.L2).kind \
        == "hnsw"
    ex = BatchingExecutor(h, max_batch=8, max_wait_ms=1, ef_search=32)
    try:
        assert ex.search(db[9], 3, timeout=60)[1][0] in (9, 2009)
    finally:
        ex.shutdown()
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_table(rel.table, tmp + "/t")
        rt = checkpoint.load_table(tmp + "/t", device="cpu")
        rel.replication_log = replication.ReplicationLog(tmp + "/log")
        rel.insert(db[:4] + 1.0)
        rel.delete([3])
        rel.vacuum()
        assert replication.apply_deltas(rt, [], tmp + "/log") == 3
        assert torch.equal(rt.data[: rt.count], rel.table.data[: rt.count])
    assert functions.l2_distance(P.Vector([0, 0]), P.Vector([3, 4])) == 5.0
    # the mesh paths: four shards on the CPU
    from pgvector_tpu_torch import parallel as PP
    mesh = PP.make_mesh(4, devices=["cpu"] * 4)
    d, r = PP.sharded_exact_search(mesh, P.Metric.L2, db, db[:5], 3)
    assert (r[:, 0].numpy() == np.arange(5)).all(), r
    d, r = PP.dim_sharded_exact_search(mesh, P.Metric.IP, db, db[:5], 3)
    assert r.shape == (5, 3), r.shape
    dsh = PP.DeviceShardedHNSWIndex(mesh, table, P.Metric.L2, m=8,
                                    ef_construction=32, wave_size=512)
    d, r = dsh.search(db[:5], 3, ef_search=32)
    assert (r[:, 0] == np.arange(5)).all(), r
    built = P.HNSWIndex(table, P.Metric.L2, m=8, ef_construction=32,
                        wave_size=512, dedup=False, build_mesh=mesh)
    assert torch.equal(built.nbr0, P.HNSWIndex(
        table, P.Metric.L2, m=8, ef_construction=32, wave_size=512,
        dedup=False).nbr0)
    if not torch.cuda.is_available():
        try:
            PP.make_mesh()
        except P.DataException:
            pass
        else:
            raise AssertionError("a mesh without a card and devices")
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


_BUILD_SCRIPT = textwrap.dedent("""
    import os, sys
    from pathlib import Path
    sys.modules["jax"] = None
    root = Path(sys.argv[1])
    ref = root / "pgvector_tpu"

    def tree():
        return sorted((str(p), p.stat().st_mtime_ns)
                      for p in ref.rglob("*") if "__pycache__" not in p.parts)

    before = tree()
    from pgvector_tpu_torch import native
    assert ref not in native.LIB_PATH.parents, native.LIB_PATH
    native.BUILD_DIR = Path(sys.argv[2])
    native.LIB_PATH = native.BUILD_DIR / "libpgvt_codec.so"
    assert native.available() and native.LIB_PATH.exists()
    assert native.parse_vectors(["[1,2]"]).tolist() == [[1.0, 2.0]]
    assert tree() == before
    print("ok")
""")


def test_codec_builds_only_in_port_build_dir(tmp_path):
    """A fresh build of the codec writes its library into the build
    directory it is given and nothing under pgvector_tpu/."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _BUILD_SCRIPT, root, str(tmp_path / "b")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
    assert (tmp_path / "b" / "libpgvt_codec.so").exists()
