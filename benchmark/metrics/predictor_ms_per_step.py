"""Device time per step of the fused predictor kernel, matched by name:
the union of its launches' intervals over the steps traced.

Its share of a roofline is not reported: inside the captured chunk the
kernel reads u and v that the step before wrote, from the 50 MB L2, so it
can beat the memory-bandwidth bound (16.8 MB at 3.35 TB/s, 5.01 µs at
1024²; a traced launch took 5.05 µs on an H100) and no published peak
bounds it."""

from harness.trace import matching, union_length

LAYER = "kernels"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = ["cavity1024.dct"]
PATTERN = r"\bfused_predictor_central_kernel\b"


def read(record):
    calls = [o for o in matching(record.ops, PATTERN) if o.kind == "kernel"]
    if not calls or record.steps <= 0:
        return None
    return 1e-3 * union_length([(o.start, o.end) for o in calls]) / record.steps
