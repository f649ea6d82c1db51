"""The host's graph launch per chunk: the program's ``cfd.graph.replay``
spans (``Chunk._replay``, the host's ``cudaGraphLaunch`` of the chunk's
program; 5 a 50-step chunk of 10-step graphs) summed per chunk, median over the
window's chunks that neither ran under the profiler nor captured. Read
from the program's recorder, on the host clock, so the profiler's cost
of a graph's nodes is not in it. Graph route only."""

from harness.program_spans import median_chunk_ms

LAYER = "chunk"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = ["cavity1024.dct", "cylinder600x180.rbsor", "cavity1024.mg2",
             "cylinder600x180.dct"]


def read(record):
    return median_chunk_ms(record, "cfd.graph.replay")
