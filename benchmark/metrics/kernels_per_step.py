"""Kernels run on the card per step over the traced chunks (copies and
fills not counted), the runner's own per chunk included. The count
repeats exactly; a fusion lowers it."""

LAYER = "step"
UNIT = "kernels"
MOVES = "cell_updates_per_s"
WORKLOADS = None


def read(record):
    if record.steps <= 0:
        return None
    n = sum(1 for o in record.ops if o.kind == "kernel")
    return n / record.steps if n else None
