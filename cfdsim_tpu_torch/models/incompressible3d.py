"""3D incompressible Navier–Stokes, collocated, Chorin projection on
(nz, ny, nx) (``cfdsim_tpu.models.incompressible3d``): the 3D lid-driven
cavity of BASELINE.json config 5 (256³, geometric-multigrid pressure).

First-order upwind convection, explicit diffusion, a central-difference
divergence and gradient, and the projection through
``solvers/poisson3d.py`` (multigrid by default). The BCs write the
boundary faces in place on tensors the step allocated itself, so no input
tensor changes. The pressure solve runs a fixed number of V-cycles, so the
step reads nothing on the host and a chunk of steps captures into one CUDA
graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig, Poisson3DSolver, residual_3d


class Incompressible3DState(NamedTuple):
    u: torch.Tensor  # (nz, ny, nx)
    v: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor


class Step3DMetrics(NamedTuple):
    dt: torch.Tensor
    div_pre: torch.Tensor
    div_post: torch.Tensor  # a 2-node frame excluded
    max_vel: torch.Tensor
    energy: torch.Tensor
    poisson_res: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Incompressible3DConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    grid: Grid3D
    nu: float
    poisson: Poisson3DConfig = Poisson3DConfig()
    cfl_target: float = 0.4
    dt_min: float = 1e-7
    dt_max: float = 1.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def _pad0(inner):
    return F.pad(inner, (1, 1, 1, 1, 1, 1))


def gradient3(phi, dx: float, dy: float, dz: float):
    gx = (phi[1:-1, 1:-1, 2:] - phi[1:-1, 1:-1, :-2]) * (0.5 / dx)
    gy = (phi[1:-1, 2:, 1:-1] - phi[1:-1, :-2, 1:-1]) * (0.5 / dy)
    gz = (phi[2:, 1:-1, 1:-1] - phi[:-2, 1:-1, 1:-1]) * (0.5 / dz)
    return _pad0(gx), _pad0(gy), _pad0(gz)


def divergence3(u, v, w, dx: float, dy: float, dz: float):
    return _pad0((u[1:-1, 1:-1, 2:] - u[1:-1, 1:-1, :-2]) * (0.5 / dx)
                 + (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1]) * (0.5 / dy)
                 + (w[2:, 1:-1, 1:-1] - w[:-2, 1:-1, 1:-1]) * (0.5 / dz))


def laplacian3(phi, dx: float, dy: float, dz: float):
    c = phi[1:-1, 1:-1, 1:-1]
    return _pad0((phi[1:-1, 1:-1, 2:] - 2 * c + phi[1:-1, 1:-1, :-2]) / dx**2
                 + (phi[1:-1, 2:, 1:-1] - 2 * c + phi[1:-1, :-2, 1:-1]) / dy**2
                 + (phi[2:, 1:-1, 1:-1] - 2 * c + phi[:-2, 1:-1, 1:-1]) / dz**2)


def convection3_upwind(u, v, w, phi, dx: float, dy: float, dz: float):
    """First-order upwind (u·∇)φ, zero on the boundary shell."""
    uc = u[1:-1, 1:-1, 1:-1]
    vc = v[1:-1, 1:-1, 1:-1]
    wc = w[1:-1, 1:-1, 1:-1]
    pc = phi[1:-1, 1:-1, 1:-1]
    ddx = torch.where(uc > 0, (pc - phi[1:-1, 1:-1, :-2]) / dx, (phi[1:-1, 1:-1, 2:] - pc) / dx)
    ddy = torch.where(vc > 0, (pc - phi[1:-1, :-2, 1:-1]) / dy, (phi[1:-1, 2:, 1:-1] - pc) / dy)
    ddz = torch.where(wc > 0, (pc - phi[:-2, 1:-1, 1:-1]) / dz, (phi[2:, 1:-1, 1:-1] - pc) / dz)
    return _pad0(uc * ddx + vc * ddy + wc * ddz)


def init_state(cfg: Incompressible3DConfig, *, device) -> Incompressible3DState:
    g = cfg.grid
    return Incompressible3DState(
        u=g.zeros(device=device), v=g.zeros(device=device), w=g.zeros(device=device),
        p=g.zeros(device=device), t=torch.zeros((), dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))


def lid_cavity3d_bcs(lid_velocity: float = 1.0) -> Callable:
    """Lid at z_hi moving in +x, no-slip on the other five faces; writes in
    place and returns (u, v, w)."""

    def apply(u, v, w):
        for q in (u, v, w):
            q[0] = 0.0
            q[:, 0, :] = 0.0
            q[:, -1, :] = 0.0
            q[:, :, 0] = 0.0
            q[:, :, -1] = 0.0
        u[-1] = lid_velocity
        v[-1] = 0.0
        w[-1] = 0.0
        return u, v, w

    return apply


class Incompressible3DStep(nn.Module):
    """``step(state, cfl_scale) -> (state, Step3DMetrics)``; the Poisson
    solver's tables are buffers on ``device``."""

    reads_host = False

    def __init__(self, cfg: Incompressible3DConfig, bc_fn: Callable, *, device):
        super().__init__()
        g = cfg.grid
        self.cfg = cfg
        self.bc_fn = bc_fn
        self.device = torch.device(device)
        self.poisson = Poisson3DSolver(g.shape, g.dx, g.dy, g.dz, cfg.poisson, device=device)

    def forward(self, state: Incompressible3DState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        u, v, w = state.u, state.v, state.w
        h = min(dx, dy, dz)
        vel_max = torch.maximum(u.abs(), torch.maximum(v.abs(), w.abs())).amax().clamp(min=1e-10)
        dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
        dt_visc = 0.15 * h * h / cfg.nu  # the 3D explicit diffusion bound (1/6)
        dt = dt_cfl.clamp(max=dt_visc).clamp(cfg.dt_min, cfg.dt_max)

        u_s, v_s, w_s = self.bc_fn(*(
            q + dt * (cfg.nu * laplacian3(q, dx, dy, dz)
                      - convection3_upwind(u, v, w, q, dx, dy, dz)) for q in (u, v, w)))

        div = divergence3(u_s, v_s, w_s, dx, dy, dz)
        rhs = div / dt
        rhs = rhs - rhs.mean()
        phi = self.poisson(state.p, rhs)
        gx, gy, gz = gradient3(phi, dx, dy, dz)
        u_n, v_n, w_n = self.bc_fn(u_s - dt * gx, v_s - dt * gy, w_s - dt * gz)
        u_n = u_n.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_n = v_n.clamp(-cfg.max_velocity, cfg.max_velocity)
        w_n = w_n.clamp(-cfg.max_velocity, cfg.max_velocity)

        new_state = Incompressible3DState(u=u_n, v=v_n, w=w_n, p=phi, t=state.t + dt,
                                          step=state.step + 1)
        if not cfg.compute_metrics:
            z = torch.zeros((), dtype=torch.float32, device=u.device)
            return new_state, Step3DMetrics(dt, z, z, z, z, z)
        div_post = divergence3(u_n, v_n, w_n, dx, dy, dz)
        return new_state, Step3DMetrics(
            dt=dt,
            div_pre=div.abs().amax(),
            div_post=div_post[2:-2, 2:-2, 2:-2].abs().amax(),
            max_vel=vel_max,
            energy=(0.5 * (u_n**2 + v_n**2 + w_n**2)).mean(),
            poisson_res=residual_3d(phi, rhs, dx, dy, dz),
        )


def make_step(cfg: Incompressible3DConfig, bc_fn: Callable, *, device) -> Incompressible3DStep:
    """Build the step module on ``device``; ``bc_fn(u, v, w)`` writes the
    boundary values in place (:func:`lid_cavity3d_bcs`)."""
    return Incompressible3DStep(cfg, bc_fn, device=device)
