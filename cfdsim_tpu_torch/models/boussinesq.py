"""Boussinesq natural convection on the staggered (MAC) grid
(``cfdsim_tpu.models.boussinesq``).

Temperature feeds back into the momentum equation as a buoyancy force.
In the thermal-diffusion units α/L of the standard benchmark form,

    ∂u/∂t + u·∇u = −∇p + Pr ∇²u + Ra·Pr·θ ĵ
    ∂θ/∂t + u·∇θ = ∇²θ

on a closed no-slip box: ``heated_axis="x"`` heats the wall x = 0 and
cools x = 1 with adiabatic top and bottom (the de Vahl Davis cavity);
``"y"`` heats from below (Rayleigh–Bénard). The momentum step is the MAC
tier's (``models/mac.py``: its advection and Laplacian, the in-place
no-slip BCs on copies of the state, the exact projection through
``PoissonSolver``, so ``mg`` runs the RB-SOR kernels on a CUDA device); θ is
advected conservatively at cell centres with the projected face
velocities (central or upwind) and diffused with κ = 1. The metrics carry
the hot-wall and mid-plane Nusselt numbers. The step reads nothing on the
host (unless its Poisson method's streaming early exit does:
``reads_host``), so a chunk of steps captures into one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.solvers.autotune import resolve_poisson_config
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, PoissonSolver


class BoussinesqState(NamedTuple):
    u: torch.Tensor  # (ny, nx+1)
    v: torch.Tensor  # (ny+1, nx)
    p: torch.Tensor  # (ny, nx)
    theta: torch.Tensor  # (ny, nx) cell-centred temperature
    t: torch.Tensor
    step: torch.Tensor


class BoussinesqMetrics(NamedTuple):
    dt: torch.Tensor
    div_post: torch.Tensor
    max_vel: torch.Tensor
    energy: torch.Tensor
    nu_hot_wall: torch.Tensor  # mean Nusselt number from the hot-wall gradient
    nu_mid: torch.Tensor  # mean Nusselt number through the mid-plane (2nd order)
    theta_min: torch.Tensor
    theta_max: torch.Tensor

    # the runner's and monitor's names
    @property
    def div_pre(self):
        return self.div_post

    @property
    def vort_max(self):
        return torch.zeros_like(self.dt)

    @property
    def poisson_res(self):
        return torch.zeros_like(self.dt)


@dataclasses.dataclass(frozen=True)
class BoussinesqConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    grid: Grid
    rayleigh: float
    prandtl: float = 0.71
    theta_scheme: str = "central"  # central | upwind
    flow_scheme: str = "central"
    poisson: PoissonConfig = PoissonConfig(method="dct")
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-4
    dt_min: float = 1e-9
    dt_max: float = 1.0
    theta_hot: float = 1.0
    theta_cold: float = 0.0
    # "x": differentially heated side walls (hot at x = 0); "y": heated from
    # below (hot at y = 0, Rayleigh–Bénard, Ra_c = 1708 rigid-rigid)
    heated_axis: str = "x"


def init_state(cfg: BoussinesqConfig, theta0=None, *, device) -> BoussinesqState:
    """Fluid at rest with ``theta0``, or the conducting profile (linear hot →
    cold along the heated axis), on ``device``."""
    g = cfg.grid
    ny, nx = g.ny, g.nx
    if theta0 is None:
        if cfg.heated_axis == "x":
            c = (torch.arange(nx, dtype=torch.float32, device=device) + 0.5) * g.dx / (
                g.x_max - g.x_min)
            prof = cfg.theta_hot + (cfg.theta_cold - cfg.theta_hot) * c
            theta0 = prof[None, :].expand(ny, nx)
        else:
            c = (torch.arange(ny, dtype=torch.float32, device=device) + 0.5) * g.dy / (
                g.y_max - g.y_min)
            prof = cfg.theta_hot + (cfg.theta_cold - cfg.theta_hot) * c
            theta0 = prof[:, None].expand(ny, nx)
    state = mac.mac_state(nx, ny, device=device)
    return BoussinesqState(u=state.u, v=state.v, p=state.p,
                           theta=torch.as_tensor(theta0, dtype=torch.float32,
                                                 device=device).clone(),
                           t=state.t, step=state.step)


def _theta_ghost(theta, hot: float, cold: float, heated_axis: str = "x"):
    """(ny+2, nx+2) ghost-extended θ, a new tensor: Dirichlet on the heated
    pair of walls (ghost = 2θ_wall − interior), adiabatic on the other pair
    (ghost = edge)."""
    te = F.pad(theta, (1, 1, 1, 1))
    if heated_axis == "x":
        te[1:-1, 0] = 2.0 * hot - theta[:, 0]
        te[1:-1, -1] = 2.0 * cold - theta[:, -1]
        te[0, :] = te[1, :]
        te[-1, :] = te[-2, :]
    else:
        te[0, 1:-1] = 2.0 * hot - theta[0, :]
        te[-1, 1:-1] = 2.0 * cold - theta[-1, :]
        te[:, 0] = te[:, 1]
        te[:, -1] = te[:, -2]
    return te


class BoussinesqStep(nn.Module):
    """``step(state, cfl_scale) -> (state, BoussinesqMetrics)``; the
    Poisson solver's tables are buffers on ``device``."""

    def __init__(self, cfg: BoussinesqConfig, *, device):
        super().__init__()
        if cfg.theta_scheme not in ("central", "upwind"):
            raise ValueError(f"unknown theta_scheme {cfg.theta_scheme!r}")
        if cfg.heated_axis not in ("x", "y"):
            raise ValueError(f"unknown heated_axis {cfg.heated_axis!r}")
        g = cfg.grid
        # pin dct_variant="auto" now: the autotuner times on the device
        pois = resolve_poisson_config(cfg.poisson, (g.ny, g.nx), g.dx, g.dy, device=device)
        if pois is not cfg.poisson:
            cfg = dataclasses.replace(cfg, poisson=pois)
        self.cfg = cfg
        self.device = torch.device(device)
        self.bcs = mac.cavity_bcs(lid_velocity=0.0)  # the closed no-slip box
        self.poisson = PoissonSolver((g.ny, g.nx), g.dx, g.dy, cfg.poisson, device=device)
        self.reads_host = self.poisson.reads_host
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=device))

    def forward(self, state: BoussinesqState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy = g.dx, g.dy
        h = min(dx, dy)
        nu = cfg.prandtl  # Pr in α-units
        buoy = cfg.rayleigh * cfg.prandtl
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        set_normal = self.bcs.set_normal
        u, v = set_normal(state.u.clone(), state.v.clone())
        theta = state.theta
        ue, ve = self.bcs.extend(u, v)

        # dt: the convective CFL and the tighter of the two diffusivities
        if cfg.adaptive_dt:
            vel_max = torch.maximum(u.abs().amax(), v.abs().amax()).clamp(min=1e-10)
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            dt = dt_cfl.clamp(max=0.2 * h * h / max(nu, 1.0)).clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        # momentum predictor with buoyancy at the interior v-faces
        conv_u, conv_v = mac._advect(u, v, ue, ve, dx, dy, cfg.flow_scheme)
        lap_u, lap_v = mac._diffuse(ue, ve, dx, dy)
        th_face = 0.5 * (theta[:-1, :] + theta[1:, :])  # (ny−1, nx)
        u_star = mac._add_interior(u.clone(), 1, dt * (nu * lap_u - conv_u))
        v_star = mac._add_interior(v.clone(), 0, dt * (nu * lap_v - conv_v + buoy * th_face))
        u_star, v_star = set_normal(u_star, v_star)

        # exact projection
        div_star = mac.divergence_mac(u_star, v_star, dx, dy)
        rhs = div_star / dt
        if cfg.poisson.method not in ("dct", "fft"):
            rhs = rhs - rhs.mean()
        phi = self.poisson(state.p, rhs)
        u_new = mac._add_interior(u_star, 1, -dt * (phi[:, 1:] - phi[:, :-1]) * (1.0 / dx))
        v_new = mac._add_interior(v_star, 0, -dt * (phi[1:, :] - phi[:-1, :]) * (1.0 / dy))
        u_new, v_new = set_normal(u_new, v_new)

        # temperature: conservative advection by the projected face
        # velocities, and diffusion with κ = 1
        te = _theta_ghost(theta, cfg.theta_hot, cfg.theta_cold, cfg.heated_axis)
        if cfg.theta_scheme == "upwind":
            thx = torch.where(u_new >= 0.0, te[1:-1, :-1], te[1:-1, 1:])
            thy = torch.where(v_new >= 0.0, te[:-1, 1:-1], te[1:, 1:-1])
        else:
            thx = 0.5 * (te[1:-1, :-1] + te[1:-1, 1:])
            thy = 0.5 * (te[:-1, 1:-1] + te[1:, 1:-1])
        fx = u_new * thx  # (ny, nx+1); the wall faces carry u = 0, so no flux
        fy = v_new * thy  # (ny+1, nx)
        adv = (fx[:, 1:] - fx[:, :-1]) * (1.0 / dx) + (fy[1:, :] - fy[:-1, :]) * (1.0 / dy)
        lap_t = (te[1:-1, 2:] - 2.0 * theta + te[1:-1, :-2]) * (1.0 / dx**2) + (
            te[2:, 1:-1] - 2.0 * theta + te[:-2, 1:-1]) * (1.0 / dy**2)
        theta_new = theta + dt * (lap_t - adv)

        new_state = BoussinesqState(u=u_new, v=v_new, p=phi, theta=theta_new,
                                    t=state.t + dt, step=state.step + 1)

        # Nusselt numbers at the hot wall (ghost gradient) and through the
        # mid-plane (2nd-order flux integral), normalised by the conduction
        # flux dT/L of the heated axis (Nu = 1 in pure conduction)
        div_post = mac.divergence_mac(u_new, v_new, dx, dy)
        d_t = cfg.theta_hot - cfg.theta_cold
        lx = g.x_max - g.x_min
        ly = g.y_max - g.y_min
        if cfg.heated_axis == "x":
            nu_hot = (2.0 * (cfg.theta_hot - theta_new[:, 0]) / dx).mean() * lx / d_t
            i_mid = g.nx // 2  # the u-face column at mid-x (even nx)
            th_mid = 0.5 * (theta_new[:, i_mid - 1] + theta_new[:, i_mid])
            dth_mid = (theta_new[:, i_mid] - theta_new[:, i_mid - 1]) * (1.0 / dx)
            nu_mid = (u_new[:, i_mid] * th_mid - dth_mid).sum() * dy * lx / (d_t * ly)
        else:
            nu_hot = (2.0 * (cfg.theta_hot - theta_new[0, :]) / dy).mean() * ly / d_t
            j_mid = g.ny // 2  # the v-face row at mid-y
            th_mid = 0.5 * (theta_new[j_mid - 1, :] + theta_new[j_mid, :])
            dth_mid = (theta_new[j_mid, :] - theta_new[j_mid - 1, :]) * (1.0 / dy)
            nu_mid = (v_new[j_mid, :] * th_mid - dth_mid).sum() * dx * ly / (d_t * lx)
        ucc, vcc = mac.center_velocities(u_new, v_new)
        return new_state, BoussinesqMetrics(
            dt=dt,
            div_post=div_post.abs().amax(),
            max_vel=torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            energy=(0.5 * (ucc * ucc + vcc * vcc)).mean(),
            nu_hot_wall=nu_hot,
            nu_mid=nu_mid,
            theta_min=theta_new.amin(),
            theta_max=theta_new.amax(),
        )


def make_step(cfg: BoussinesqConfig, *, device) -> BoussinesqStep:
    """Build the step module on ``device`` (``dct_variant="auto"`` is
    resolved here, by the port's autotuner)."""
    return BoussinesqStep(cfg, device=device)
