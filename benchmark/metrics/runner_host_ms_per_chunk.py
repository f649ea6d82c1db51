"""The runner's host time per chunk: the wall time between one chunk span
and the next (health check, history, logging, the loop), averaged over
the window's chunks, leaving out the two gaps that hold the profiler's
start and stop. The card has nothing queued in that time."""

LAYER = "runner"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = None  # every cell


def read(record):
    gaps = record.host_gaps_ms
    return sum(gaps) / len(gaps) if gaps else None
