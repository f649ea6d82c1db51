"""Published peaks of one NVIDIA H100 (SXM data sheet, dense, at the full
700 W power limit), and the roofline bound of a kernel call.

A kernel's bound is the larger of its bytes over the memory bandwidth and
its float32 operations over the float32 rate outside the tensor cores; the
counts come from the metric's own work formulas, never from the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_seconds(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def roofline_percent(bound_s: float, measured_s: float):
    """The bound as a share of the measured time, in %; None where
    nothing was measured."""
    if measured_s <= 0.0:
        return None
    return 100.0 * bound_s / measured_s
