"""Simulation health monitoring (a numpy-only copy of ``cfdsim_tpu.monitor``):
``check_metrics`` for the incompressible and spectral tiers,
``check_compressible`` for the 2D compressible cases.

The reference's in-loop guards (``monitor_simulation_health`` v5.py:599-613,
cavity_flow_v1.py:445-455, ``check_health`` v1_shock.py:319-328) as a
host-side check over the metric scalars each chunk returns — the fields
themselves never leave the device for health checking.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HealthReport:
    ok: bool
    reason: str = ""
    max_vel: float = 0.0
    div_max: float = 0.0


def check_metrics(
    metrics,
    max_velocity: float,
    div_threshold: float = 2.0,
    warmup_div_threshold: float = 20.0,
    warmup_steps: int = 1000,
    step: int = 0,
) -> HealthReport:
    """Check a chunk's stacked StepMetrics (device arrays or numpy).

    Thresholds mirror reference v5.py:599-613: non-finite state, velocity
    magnitude bound, and a divergence bound that is looser during warmup.
    """
    max_vel = float(np.max(np.asarray(metrics.max_vel)))
    # metric types without a divergence field (e.g. the spectral solver,
    # whose projection is exact) skip the divergence check
    div_max = (
        float(np.max(np.asarray(metrics.div_post)))
        if hasattr(metrics, "div_post")
        else 0.0
    )
    energy = float(np.asarray(metrics.energy)[-1])

    if not np.isfinite(max_vel) or not np.isfinite(energy):
        return HealthReport(False, "non-finite values", max_vel, div_max)
    if max_vel > max_velocity:
        return HealthReport(False, f"high velocity {max_vel:.3f}", max_vel, div_max)
    thresh = warmup_div_threshold if step <= warmup_steps else div_threshold
    if div_max > thresh:
        return HealthReport(False, f"high divergence {div_max:.3f}", max_vel, div_max)
    return HealthReport(True, "", max_vel, div_max)



def check_compressible(
    metrics,
    max_velocity: float = 100.0,
    rho_min: float = 1e-8,
    p_min: float = 1e-8,
    **_,
) -> HealthReport:
    """Compressible-state health: finite values, positive density and
    pressure, bounded velocity (reference check_health v1_shock.py:319-328,
    monitor_simulation_health cavity_flow_v1.py:445-455)."""
    max_vel = float(np.max(np.asarray(metrics.max_vel)))
    rho = float(np.min(np.asarray(metrics.min_rho)))
    p = float(np.min(np.asarray(metrics.min_p)))
    if not np.isfinite(max_vel) or not np.isfinite(rho):
        return HealthReport(False, "non-finite values", max_vel)
    if rho < rho_min or p < p_min:
        return HealthReport(False, f"invalid density/pressure ({rho:.2e}, {p:.2e})", max_vel)
    if max_vel > max_velocity:
        return HealthReport(False, f"high velocity {max_vel:.3f}", max_vel)
    return HealthReport(True, "", max_vel)
