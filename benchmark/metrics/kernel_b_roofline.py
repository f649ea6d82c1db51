"""Kernel B's (the temporally blocked red-black kernel's) share of its
roofline on the multigrid's finest level: the least time the card could
take for the traced launches over the time they took.

A launch reads φ and the right-hand side once and writes φ once (12 bytes
a cell) and computes 11 float32 operations a cell per sweep. Each V-cycle
smooths the finest level twice, ``pre`` sweeps down and ``post`` sweeps
up, so a step holds cycles × 2 passes of the finest level: the bound
counts each launch as one such pass. Where a step holds another number of
launches (the kernel routed onto a coarser level, or a pass split), that
count no longer holds and the reader raises rather than inflate the bound.
One 2-sweep pass at 1024²: 12.6 MB, 3.76 µs; 23 MFLOP, 0.34 µs."""

from harness.peaks import bound_seconds, roofline_percent
from harness.trace import matching

LAYER = "kernels"
UNIT = "%"
MOVES = "cell_updates_per_s"
WORKLOADS = ["cavity1024.mg2"]
PATTERN = r"\brbsor_blocked_kernel\b"
FLOPS_PER_UPDATE = 11


def bound_per_launch(ny: int, nx: int, sweeps: float) -> float:
    cells = ny * nx
    return bound_seconds(12.0 * cells, FLOPS_PER_UPDATE * cells * sweeps)


def read(record):
    launches = [o for o in matching(record.ops, PATTERN) if o.kind == "kernel"]
    if not launches or record.steps <= 0:
        return None
    p = record.problem
    mg = p["poisson"]
    passes = record.steps * mg["cycles"] * 2
    if len(launches) != passes:
        raise ValueError(f"kernel B launched {len(launches)} times in {record.steps} steps, "
                         f"not the finest level's {passes} passes: its bound no longer holds")
    sweeps = record.steps * mg["cycles"] * (mg["pre"] + mg["post"]) / passes
    measured = 1e-6 * sum(o.end - o.start for o in launches)
    return roofline_percent(len(launches) * bound_per_launch(p["ny"], p["nx"], sweeps), measured)
