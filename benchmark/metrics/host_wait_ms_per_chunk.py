"""The runner's wait on the card per chunk: from the chunk's last launch
to its metrics on the host, the program's ``cfd.chunk.copy_out`` (the
clones out of the graph's buffers, which queue behind the graphs when the
card is far behind) and ``cfd.runner.read`` (``Simulation._chunk``: the
stack, cat and ``.cpu()`` of the chunk's one device→host copy, which
returns when the card has run the chunk) summed, median over the window's
chunks that neither ran under the profiler nor captured. Near zero where
the host sets the pace."""

from harness.program_spans import median_chunk_ms

LAYER = "runner"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = None  # every cell


def read(record):
    return median_chunk_ms(record, "cfd.chunk.copy_out", "cfd.runner.read")
