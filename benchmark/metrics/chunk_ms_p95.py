"""The 95th percentile of the runner's chunk times (50 steps, span to
span on the host clock), over the window's chunks that the profiler did
not trace. A stall anywhere in the window shows here and not in a mean.

Not an end-to-end metric: where a 10-step graph holds thousands of nodes
the chunk runs at the slower of the device and the host's graph launch,
so its time takes one of two values, and the 95th percentile falls on one
or the other from run to run (9-18% apart on an H100)."""

import statistics

LAYER = "runner"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = None


def read(record):
    ms = record.chunk_ms
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
