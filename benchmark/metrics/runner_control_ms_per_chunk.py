"""The runner's turn after a chunk, from inside the program: its
``cfd.runner.control`` span (``Simulation.run``: health check, history,
back-off, snapshot, log), median over the window's chunks that neither
ran under the profiler nor captured. The in-program counterpart of
``runner_host_ms_per_chunk``, which times the whole gap between the
benchmark's chunk spans."""

from harness.program_spans import median_chunk_ms

LAYER = "runner"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = None


def read(record):
    return median_chunk_ms(record, "cfd.runner.control")
