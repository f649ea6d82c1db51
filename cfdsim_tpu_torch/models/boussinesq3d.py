"""3D Boussinesq natural convection on the staggered (MAC) grid
(``cfdsim_tpu.models.boussinesq3d``): the differentially heated cube.

Hot wall θ = 1 at x = 0, cold wall θ = 0 at x = 1, adiabatic elsewhere,
no slip everywhere, gravity in −z (buoyancy Ra·Pr·θ on the w faces), in
the α-units of ``models/boussinesq.py``. The momentum step is the 3D MAC
tier's (``models/mac3d.py``: its advection and Laplacian, the in-place
no-slip BCs on copies, the exact 3D projection through
``Poisson3DSolver``); θ is advected conservatively with the projected
face velocities (central or upwind) and diffused with κ = 1. The metrics
(``boussinesq.BoussinesqMetrics``) carry the hot-wall and mid-plane
Nusselt numbers; the Tric, Labrosse & Betrouni (2000) cube gives Nu =
2.054 at Ra = 1e4. The step reads nothing on the host (unless its Poisson
method does), so a chunk of steps captures into one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.models import mac3d
from cfdsim_tpu_torch.models.boussinesq import BoussinesqMetrics
from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig, Poisson3DSolver


class Boussinesq3DState(NamedTuple):
    u: torch.Tensor  # (nz, ny, nx+1)
    v: torch.Tensor  # (nz, ny+1, nx)
    w: torch.Tensor  # (nz+1, ny, nx)
    p: torch.Tensor  # (nz, ny, nx)
    theta: torch.Tensor  # (nz, ny, nx)
    t: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Boussinesq3DConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    grid: Grid3D
    rayleigh: float
    prandtl: float = 0.71
    theta_scheme: str = "central"  # central | upwind
    flow_scheme: str = "central"  # central | upwind | tvd (mac3d.advect3d)
    poisson: Poisson3DConfig = Poisson3DConfig(method="dct")
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-4
    dt_min: float = 1e-9
    dt_max: float = 1.0
    theta_hot: float = 1.0
    theta_cold: float = 0.0


def init_state(cfg: Boussinesq3DConfig, theta0=None, *, device) -> Boussinesq3DState:
    """Fluid at rest with ``theta0``, or the conducting profile (linear hot
    → cold along x), on ``device``."""
    g = cfg.grid
    if theta0 is None:
        c = (torch.arange(g.nx, dtype=torch.float32, device=device) + 0.5) * g.dx / (
            g.x_max - g.x_min)
        prof = cfg.theta_hot + (cfg.theta_cold - cfg.theta_hot) * c
        theta0 = prof[None, None, :].expand(g.nz, g.ny, g.nx)
    flow = mac3d.mac3d_state(g.nx, g.ny, g.nz, device=device)
    theta = torch.as_tensor(np.asarray(theta0) if not torch.is_tensor(theta0) else theta0,
                            dtype=torch.float32, device=device).clone()
    return Boussinesq3DState(u=flow.u, v=flow.v, w=flow.w, p=flow.p, theta=theta, t=flow.t,
                             step=flow.step)


def _theta_ghost3d(theta, hot: float, cold: float):
    """(nz+2, ny+2, nx+2) ghost-extended θ, a new tensor: Dirichlet x walls
    (mirror ghosts), adiabatic y and z walls (copies)."""
    nz, ny, nx = theta.shape
    te = theta.new_zeros((nz + 2, ny + 2, nx + 2))
    te[1:-1, 1:-1, 1:-1] = theta
    te[1:-1, 1:-1, 0] = 2.0 * hot - theta[:, :, 0]
    te[1:-1, 1:-1, -1] = 2.0 * cold - theta[:, :, -1]
    te[:, 0, :] = te[:, 1, :]
    te[:, -1, :] = te[:, -2, :]
    te[0] = te[1]
    te[-1] = te[-2]
    return te


class Boussinesq3DStep(nn.Module):
    """``step(state, cfl_scale) -> (state, BoussinesqMetrics)``; the
    Poisson solver's tables are buffers on ``device``."""

    def __init__(self, cfg: Boussinesq3DConfig, *, device):
        super().__init__()
        if cfg.theta_scheme not in ("central", "upwind"):
            raise ValueError(f"unknown theta_scheme {cfg.theta_scheme!r}")
        g = cfg.grid
        self.cfg = cfg
        self.device = torch.device(device)
        self.bcs = mac3d.cavity3d_bcs(lid_velocity=0.0)  # the closed no-slip box
        self.poisson = Poisson3DSolver(g.shape, g.dx, g.dy, g.dz, cfg.poisson, device=device)
        self.reads_host = self.poisson.reads_host
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=device))

    def forward(self, state: Boussinesq3DState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        h = min(dx, dy, dz)
        nu = cfg.prandtl  # Pr in α-units
        buoy = cfg.rayleigh * cfg.prandtl
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        bcs = self.bcs
        u, v, w = bcs.set_normal(state.u.clone(), state.v.clone(), state.w.clone())
        theta = state.theta
        if cfg.adaptive_dt:
            vel_max = torch.maximum(torch.maximum(u.abs().amax(), v.abs().amax()),
                                    w.abs().amax().clamp(min=1e-10))
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            dt = dt_cfl.clamp(max=0.125 * h * h / max(nu, 1.0)).clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        ghosts = bcs.ghosts(u, v, w)
        conv_u, conv_v, conv_w = mac3d.advect3d(u, v, w, ghosts, dx, dy, dz, cfg.flow_scheme)
        lap_u, lap_v, lap_w = mac3d.diffuse3d(u, v, w, ghosts, dx, dy, dz)
        # buoyancy on the interior w faces: θ averaged across the z face
        th_face = 0.5 * (theta[:-1] + theta[1:])
        u_star, v_star, w_star = u.clone(), v.clone(), w.clone()
        u_star[:, :, 1:-1] += dt * (nu * lap_u - conv_u)
        v_star[:, 1:-1, :] += dt * (nu * lap_v - conv_v)
        w_star[1:-1] += dt * (nu * lap_w - conv_w + buoy * th_face)
        u_star, v_star, w_star = bcs.set_normal(u_star, v_star, w_star)

        # the exact 3D projection
        div_star = mac3d.divergence_mac3d(u_star, v_star, w_star, dx, dy, dz)
        rhs = div_star / dt
        if cfg.poisson.method != "dct":
            rhs = rhs - rhs.mean()
        phi = self.poisson(state.p, rhs)
        u_star[:, :, 1:-1] += -dt * (phi[:, :, 1:] - phi[:, :, :-1]) * (1.0 / dx)
        v_star[:, 1:-1, :] += -dt * (phi[:, 1:, :] - phi[:, :-1, :]) * (1.0 / dy)
        w_star[1:-1] += -dt * (phi[1:] - phi[:-1]) * (1.0 / dz)
        u_new, v_new, w_new = bcs.set_normal(u_star, v_star, w_star)

        # temperature: conservative advection and diffusion
        te = _theta_ghost3d(theta, cfg.theta_hot, cfg.theta_cold)
        if cfg.theta_scheme == "upwind":
            thx = torch.where(u_new >= 0.0, te[1:-1, 1:-1, :-1], te[1:-1, 1:-1, 1:])
            thy = torch.where(v_new >= 0.0, te[1:-1, :-1, 1:-1], te[1:-1, 1:, 1:-1])
            thz = torch.where(w_new >= 0.0, te[:-1, 1:-1, 1:-1], te[1:, 1:-1, 1:-1])
        else:
            thx = 0.5 * (te[1:-1, 1:-1, :-1] + te[1:-1, 1:-1, 1:])
            thy = 0.5 * (te[1:-1, :-1, 1:-1] + te[1:-1, 1:, 1:-1])
            thz = 0.5 * (te[:-1, 1:-1, 1:-1] + te[1:, 1:-1, 1:-1])
        fx, fy, fz = u_new * thx, v_new * thy, w_new * thz
        adv = ((fx[:, :, 1:] - fx[:, :, :-1]) * (1.0 / dx)
               + (fy[:, 1:, :] - fy[:, :-1, :]) * (1.0 / dy)
               + (fz[1:] - fz[:-1]) * (1.0 / dz))
        ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
        lap_t = ((te[1:-1, 1:-1, 2:] - 2.0 * theta + te[1:-1, 1:-1, :-2]) * ax
                 + (te[1:-1, 2:, 1:-1] - 2.0 * theta + te[1:-1, :-2, 1:-1]) * ay
                 + (te[2:, 1:-1, 1:-1] - 2.0 * theta + te[:-2, 1:-1, 1:-1]) * az)
        theta_new = theta + dt * (lap_t - adv)

        new_state = Boussinesq3DState(u=u_new, v=v_new, w=w_new, p=phi, theta=theta_new,
                                      t=state.t + dt, step=state.step + 1)

        # Nusselt numbers at the hot wall and through the mid-plane,
        # normalised by the hot wall's conduction flux
        div_post = mac3d.divergence_mac3d(u_new, v_new, w_new, dx, dy, dz)
        d_t = cfg.theta_hot - cfg.theta_cold
        lx = g.x_max - g.x_min
        nu_hot = (2.0 * (cfg.theta_hot - theta_new[:, :, 0]) / dx).mean() * lx / d_t
        i_mid = g.nx // 2
        th_mid = 0.5 * (theta_new[:, :, i_mid - 1] + theta_new[:, :, i_mid])
        dth_mid = (theta_new[:, :, i_mid] - theta_new[:, :, i_mid - 1]) * (1.0 / dx)
        area = dy * dz
        plane = (g.y_max - g.y_min) * (g.z_max - g.z_min)
        nu_mid = (u_new[:, :, i_mid] * th_mid - dth_mid).sum() * area * lx / (d_t * plane)
        ucc, vcc, wcc = mac3d.center_velocities_3d(u_new, v_new, w_new)
        return new_state, BoussinesqMetrics(
            dt=dt,
            div_post=div_post.abs().amax(),
            max_vel=torch.maximum(torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                                  w_new.abs().amax()),
            energy=(0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)).mean(),
            nu_hot_wall=nu_hot,
            nu_mid=nu_mid,
            theta_min=theta_new.amin(),
            theta_max=theta_new.amax(),
        )


def make_step(cfg: Boussinesq3DConfig, *, device) -> Boussinesq3DStep:
    """Build the step module on ``device``."""
    return Boussinesq3DStep(cfg, device=device)
