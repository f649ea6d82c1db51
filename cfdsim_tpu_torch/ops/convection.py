"""Convection operators (``cfdsim_tpu.ops.convection``): central,
first-order upwind, SUPG-stabilized central with the reference-parity
scaling, and second-order TVD (MUSCL with the van Leer slope of
``ops/limiters.py``).

Each operator is zero on the boundary frame and repeats the JAX package's
fp32 arithmetic in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.ops.stencil import _pad1


def convection_central(u, v, phi, dx: float, dy: float):
    """Plain second-order central convection u·∇φ; zero on boundary frame."""
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    dphidx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * (0.5 / dx)
    dphidy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * (0.5 / dy)
    return _pad1(uc * dphidx + vc * dphidy)


def convection_upwind(u, v, phi, dx: float, dy: float):
    """First-order upwind u·∇φ (backward difference where the velocity is
    positive, forward otherwise); zero on boundary frame."""
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    pc = phi[1:-1, 1:-1]
    bwd_x = (pc - phi[1:-1, :-2]) * (1.0 / dx)
    fwd_x = (phi[1:-1, 2:] - pc) * (1.0 / dx)
    bwd_y = (pc - phi[:-2, 1:-1]) * (1.0 / dy)
    fwd_y = (phi[2:, 1:-1] - pc) * (1.0 / dy)
    dphidx = torch.where(uc > 0, bwd_x, fwd_x)
    dphidy = torch.where(vc > 0, bwd_y, fwd_y)
    return _pad1(uc * dphidx + vc * dphidy)


def supg_tau(u, v, dx: float, dy: float, dt, nu_eff):
    """SUPG stabilization parameter τ = h/(2|u|)·min(1, Pe/2) with
    Pe = |u|h/ν_eff, τ = dt/2 at stagnation points; boundary frame zeroed.

    ``nu_eff`` is a tensor or a number; a number is summed with 1e-10 in
    float32, as the JAX package sums its float32 ν_eff array."""
    tau = supg_tau_field(u, v, dx, dy, dt, nu_eff)
    return _pad1(tau[1:-1, 1:-1])


def supg_tau_field(u, v, dx: float, dy: float, dt, nu_eff):
    """:func:`supg_tau` on every node, the frame included (a block of a
    distributed field zeroes the frame of the global grid instead)."""
    h = min(dx, dy)
    vel = torch.sqrt(u * u + v * v)
    if torch.is_tensor(nu_eff):
        den = nu_eff + 1e-10
    else:
        den = float(np.float32(nu_eff) + np.float32(1e-10))
    pe = vel * h / den
    # h / x as a float32 division (torch's `float / tensor` multiplies by
    # the reciprocal, which rounds differently)
    h_t = torch.full((), h, dtype=vel.dtype, device=vel.device)
    tau_flow = h_t / (2.0 * vel.clamp(min=1e-10)) * (pe / 2.0).clamp(max=1.0)
    return torch.where(vel > 1e-10, tau_flow, dt / 2.0)


def convection_supg(u, v, phi, dx: float, dy: float, tau, ref_parity: bool = False):
    """Central-difference convection minus the SUPG correction term:

        conv = u·∇φ − τ·(u ∂²φ/∂x² + v ∂²φ/∂y²);  zero on boundary frame.

    ``ref_parity=True`` reproduces the reference's halved convection
    scaling (0.25/dx first derivatives, (0.5/dx)² second derivatives)."""
    uc = u[1:-1, 1:-1]
    vc = v[1:-1, 1:-1]
    pc = phi[1:-1, 1:-1]
    if ref_parity:
        d1x, d1y = 0.25 / dx, 0.25 / dy
        d2x, d2y = (0.5 / dx) ** 2, (0.5 / dy) ** 2
    else:
        d1x, d1y = 0.5 / dx, 0.5 / dy
        d2x, d2y = 1.0 / (dx * dx), 1.0 / (dy * dy)
    dphidx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * d1x
    dphidy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * d1y
    conv_std = uc * dphidx + vc * dphidy
    lap_x = (phi[1:-1, 2:] - 2.0 * pc + phi[1:-1, :-2]) * d2x
    lap_y = (phi[2:, 1:-1] - 2.0 * pc + phi[:-2, 1:-1]) * d2y
    tc = tau[1:-1, 1:-1]
    supg = tc * (uc * lap_x + vc * lap_y)
    return _pad1(torch.where(tc > 0, conv_std - supg, conv_std))


def convection_tvd(u, v, phi, dx: float, dy: float):
    """Second-order TVD convection: MUSCL face reconstruction with a van
    Leer limited slope, in flux form with a φ·∇·u correction so the
    operator reduces to the advective u·∇φ the rest of the solver expects.
    At smooth extrema the limiter keeps full second-order accuracy
    (central-like), at sharp gradients it reduces to monotone upwind. Zero
    on the boundary frame like the other convection operators."""
    # edge-padded neighbours (the one-sided slope at a wall is 0)
    pe = torch.cat([phi[:, :1], phi, phi[:, -1:]], 1)
    sx = vanleer_slope(phi - pe[:, :-2], pe[:, 2:] - phi)  # (ny, nx)
    pey = torch.cat([phi[:1], phi, phi[-1:]], 0)
    sy = vanleer_slope(phi - pey[:-2, :], pey[2:, :] - phi)

    uf = 0.5 * (u[:, :-1] + u[:, 1:])  # x-face velocities (ny, nx-1)
    phiL = phi[:, :-1] + 0.5 * sx[:, :-1]
    phiR = phi[:, 1:] - 0.5 * sx[:, 1:]
    Fx = uf * torch.where(uf >= 0.0, phiL, phiR)

    vf = 0.5 * (v[:-1, :] + v[1:, :])  # y-face velocities (ny-1, nx)
    phiB = phi[:-1, :] + 0.5 * sy[:-1, :]
    phiT = phi[1:, :] - 0.5 * sy[1:, :]
    Fy = vf * torch.where(vf >= 0.0, phiB, phiT)

    dF = (Fx[1:-1, 1:] - Fx[1:-1, :-1]) * (1.0 / dx)
    dG = (Fy[1:, 1:-1] - Fy[:-1, 1:-1]) * (1.0 / dy)
    # subtract φ·∇·u built from the SAME face velocities so the flux form
    # telescopes exactly to the advective form
    divu_f = (uf[1:-1, 1:] - uf[1:-1, :-1]) * (1.0 / dx) + (
        vf[1:, 1:-1] - vf[:-1, 1:-1]
    ) * (1.0 / dy)
    return _pad1(dF + dG - phi[1:-1, 1:-1] * divu_f)
