"""Device time per step of cuFFT's kernels (the DCT solve's transforms),
matched by name: the union of their intervals over the steps traced."""

from harness.trace import matching, union_length

LAYER = "pressure solve"
UNIT = "ms"
MOVES = "cell_updates_per_s"
WORKLOADS = ["cavity1024.dct", "cylinder600x180.dct"]
# cuFFT's kernels carry "fft" in their names (regular_fft, vector_fft, ...)
PATTERN = r"(?i)fft"


def read(record):
    ops = [o for o in matching(record.ops, PATTERN) if o.kind == "kernel"]
    if not ops or record.steps <= 0:
        return None
    return 1e-3 * union_length([(o.start, o.end) for o in ops]) / record.steps
