"""Kernel A's (the masked red-black SOR kernel's) share of its roofline:
the least time the card could take for the traced solves over the time
they took.

A solve reads φ, the right-hand side and the solid mask once and writes φ
once (16 bytes a cell), and computes 11 float32 operations per fluid cell
per sweep. Its sweeps are the program's own count of the early-exit
chunks it ran, so an early exit lowers the bound with the time. One
50-sweep chunk on the 600×180 cylinder: 106,948 fluid cells × 50 × 11 =
58.8 MFLOP, 0.878 µs; 1.73 MB, 0.52 µs."""

from harness.peaks import bound_seconds, roofline_percent
from harness.trace import matching
from reference.flow2d import fluid_cells

LAYER = "kernels"
UNIT = "%"
MOVES = "cell_updates_per_s"
WORKLOADS = ["cylinder600x180.rbsor"]
PATTERN = r"\brbsor_(?:cluster_)?kernel\b"
FLOPS_PER_UPDATE = 11


def bound_per_launch(problem: dict, sweeps: float) -> float:
    cells = problem["ny"] * problem["nx"]
    return bound_seconds(16.0 * cells, FLOPS_PER_UPDATE * fluid_cells(problem) * sweeps)


def read(record):
    launches = [o for o in matching(record.ops, PATTERN) if o.kind == "kernel"]
    before, after = record.counters.get("before"), record.counters.get("after")
    if not launches or not before or not after:
        return None
    sweeps = (after["poisson_chunks_run"] - before["poisson_chunks_run"]) * \
        after["poisson_check_every"]
    measured = 1e-6 * sum(o.end - o.start for o in launches)
    bound = len(launches) * bound_per_launch(record.problem, sweeps / len(launches))
    return roofline_percent(bound, measured)
