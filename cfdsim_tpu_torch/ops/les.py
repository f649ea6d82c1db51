"""Smagorinsky LES subgrid viscosity (``cfdsim_tpu.ops.les``):
ν_t = (C_s Δ)² |S| with Δ = sqrt(dx·dy) and one-sided forward differences
for the strain-rate tensor, zero on the boundary frame.
"""

from __future__ import annotations

import torch

from cfdsim_tpu_torch.ops.stencil import _pad1


def smagorinsky_viscosity(u, v, dx: float, dy: float, cs: float):
    delta = (dx * dy) ** 0.5
    cs_delta_sq = (cs * delta) ** 2
    dudx = (u[1:-1, 2:] - u[1:-1, 1:-1]) * (1.0 / dx)
    dudy = (u[2:, 1:-1] - u[1:-1, 1:-1]) * (1.0 / dy)
    dvdx = (v[1:-1, 2:] - v[1:-1, 1:-1]) * (1.0 / dx)
    dvdy = (v[2:, 1:-1] - v[1:-1, 1:-1]) * (1.0 / dy)
    s_mag = torch.sqrt(2.0 * (dudx * dudx + dvdy * dvdy) + (dudy + dvdx) ** 2)
    return _pad1(cs_delta_sq * s_mag)
