"""Convection operators (``cfdsim_tpu.ops.convection``).

Only the central scheme is ported so far; upwind, TVD and SUPG follow the
module queue in ROADMAP.md.
"""

from __future__ import annotations

from cfdsim_tpu_torch.ops.stencil import _pad1


def convection_central(u, v, phi, dx: float, dy: float):
    """Plain second-order central convection u·∇φ; zero on boundary frame."""
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    dphidx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * (0.5 / dx)
    dphidy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * (0.5 / dy)
    return _pad1(uc * dphidx + vc * dphidy)
