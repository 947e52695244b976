"""The wave build's search phase a wave: the program's phase timer
``hnsw.wave.search``, each phase ended by a device sync
(``PGVECTOR_TPU_PHASE_SYNC=1``), over the waves of the traced run's
window after its profiled stretch."""

PHASE = "hnsw.wave.search"


def read(run):
    t = run.timers.get(PHASE)
    if not t or not t["count"]:
        return None
    return t["total_s"] * 1e3 / t["count"]
