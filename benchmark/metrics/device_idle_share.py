"""The share of the window's wall time in which no operation ran on the
card: 1 − (device time a step, the union of the device operations'
intervals over the traced chunks) / (wall time a step over the window's
untraced chunks: a chunk's span and the runner's turn after it, over the
chunk's steps).

The device time comes from the trace, the wall time from chunks that the
profiler did not slow: under CUPTI a 10-step graph of thousands of nodes
launches up to 67% slower (an H100), and that cost would land in an idle
share taken inside the traced window. Where the card is busy throughout,
the reading sits near 0 and may fall a little below it: the traced
kernels' time and the untraced chunks' wall come from different chunks."""

from harness.trace import union_length

LAYER = "device"
UNIT = "%"
MOVES = "cell_updates_per_s"
WORKLOADS = None


def read(record):
    if not record.ops or not record.chunk_ms or record.steps <= 0:
        return None
    gaps = record.host_gaps_ms
    wall_ms = sum(record.chunk_ms) / len(record.chunk_ms) + (sum(gaps) / len(gaps) if gaps else 0.0)
    device_ms = 1e-3 * union_length([(o.start, o.end) for o in record.ops]) * \
        record.chunk_steps / record.steps
    return 100.0 * (1.0 - device_ms / wall_ms)
