"""Blocking device -> host reads an insert wave: the reads the program
counted on ``hnsw.wave`` and the spans under it (the wave search's
descent and beam loops, the connect's edge count) inside the traced
window, over the ``hnsw.wave`` spans there."""

from vecbench import program_spans

WAVE = "hnsw.wave"


def read(run):
    spans = program_spans.in_window(run)
    waves = [s for s in spans or () if s.name == WAVE]
    if not waves:
        return None
    return sum(s.host_reads for s in spans if s.under(WAVE)) / len(waves)
