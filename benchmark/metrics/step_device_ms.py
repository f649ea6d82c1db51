"""Device time per step: the union of the device operations' intervals
over the traced chunks, over the steps they ran."""

from harness.trace import union_length

LAYER = "step"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = None


def read(record):
    if not record.ops or record.steps <= 0:
        return None
    return 1e-3 * union_length([(o.start, o.end) for o in record.ops]) / record.steps
