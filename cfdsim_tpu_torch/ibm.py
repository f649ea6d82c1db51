"""Immersed-boundary geometry and forcing for the collocated cylinder
(``cfdsim_tpu.ibm``: ``cylinder_masks``, ``apply_ibm``, ``ibm_ramp``,
``potential_flow_cylinder``).

The mask and initial-field builders are numpy, run once at set-up, and
give the JAX package's arrays bit for bit; the step moves them to its
device. ``apply_ibm`` and ``ibm_ramp`` are the per-step torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from cfdsim_tpu_torch.grid import Grid


def cylinder_masks(grid: Grid, center: tuple[float, float], radius: float):
    """(solid_mask bool, ibm_mask float32) numpy arrays for an embedded
    cylinder. The IBM mask is 1 inside the body and decays as a Gaussian
    shell exp(−((r−R)/2dx)²) out to R+5dx."""
    X, Y = grid.meshgrid()
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    solid = dist <= radius
    sigma = 2.0 * grid.dx
    shell = np.exp(-(((dist - radius) / sigma) ** 2))
    ibm = np.where(dist < radius, 1.0, np.where(dist < radius + 5 * grid.dx, shell, 0.0))
    return solid, ibm.astype(np.float32)


def apply_ibm(u, v, ibm_mask, strength):
    """Penalize velocity inside/near the body: q *= (1 − mask·strength)."""
    damp = 1.0 - ibm_mask * strength
    return u * damp, v * damp


def ibm_ramp(step, ramp_steps: int):
    """Force-strength ramp min(1, step/ramp_steps) as a 0-dim float32 tensor
    on ``step``'s device; 1 if no ramp."""
    if ramp_steps <= 0:
        return torch.ones((), dtype=torch.float32, device=step.device)
    return (step.to(torch.float32) / ramp_steps).clamp(max=1.0)


def potential_flow_cylinder(grid: Grid, center: tuple[float, float], radius: float,
                            v_inf: float, ibm_mask):
    """Initial (u, v), float32 numpy: ideal potential flow around a
    cylinder, blended to rest inside the IBM shell."""
    X, Y = grid.meshgrid()
    dx = grid.dx
    r = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    theta = np.arctan2(Y - center[1], X - center[0])
    mask = np.asarray(ibm_mask)
    factor = (radius / np.maximum(r, 1e-10)) ** 2
    u_far = v_inf * (1.0 - factor * np.cos(2.0 * theta)) * (1.0 - mask)
    v_far = -v_inf * factor * np.sin(2.0 * theta) * (1.0 - mask)
    blend = np.minimum(1.0, ((r - radius) / (4.0 * dx)) ** 2)
    u_near = v_inf * blend * (1.0 - mask)
    far = r > radius + 4.0 * dx
    u0 = np.where(far, u_far, u_near)
    v0 = np.where(far, v_far, 0.0)
    return u0.astype(np.float32), v0.astype(np.float32)
