"""3D scalar (temperature) transport coupled to the staggered MAC flow, the
forced-convection tier (``cfdsim_tpu.models.transport3d``).

A passive temperature θ at the cell centres is advected by the step's
projected face velocities (conservative finite-volume fluxes: upwind,
central, or van Leer MUSCL) and diffused with α = ν/Pr. The momentum
physics is the flow step's, ``models/mac3d.py``'s on a uniform grid or
``models/mac_stretched3d.py``'s (:func:`make_stretched_step`), run first so
θ sees the projected velocities of the same step. An
isothermal immersed body is imposed by penalization of θ toward θ_body
(``ibm_mask_c``) or by ghost-cell stencils applied to the shifted field
θ − θ_body (``ibm_ghost_c``); the heat either injects is the body's
convective flux,

    Q = Σ Δθ·dV / dt,   Nu = Q / (π·D·α·Δθ)   (a sphere of diameter D).

θ's boundaries: Dirichlet θ_in at the inflow x_lo (mirror ghost; the
advective donor there is θ_in itself), zero gradient at the outflow and
on the lateral faces. The step reads nothing on the host, so a chunk of
steps captures into one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.ibm_ghost import GhostForcing3D
from cfdsim_tpu_torch.models import mac3d
from cfdsim_tpu_torch.models import mac_stretched3d as ms3
from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig


class Transport3DState(NamedTuple):
    u: torch.Tensor  # (nz, ny, nx+1)
    v: torch.Tensor  # (nz, ny+1, nx)
    w: torch.Tensor  # (nz+1, ny, nx)
    p: torch.Tensor  # (nz, ny, nx)
    theta: torch.Tensor  # (nz, ny, nx)
    t: torch.Tensor
    step: torch.Tensor


class Transport3DMetrics(NamedTuple):
    dt: torch.Tensor
    div_post: torch.Tensor
    max_vel: torch.Tensor
    energy: torch.Tensor
    fx: torch.Tensor  # the body force (momentum exchange)
    fy: torch.Tensor
    fz: torch.Tensor
    q_body: torch.Tensor  # the body's heat source Σ Δθ·dV/dt (per unit ρc_p)
    nusselt: torch.Tensor  # Q/(π·D·α·Δθ), the sphere's surface-mean Nu
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
class Transport3DConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    grid: Grid3D
    nu: float  # momentum diffusivity (from Re)
    prandtl: float = 0.7  # α = nu/prandtl
    scheme: str = "tvd"  # momentum advection (mac3d schemes)
    theta_scheme: str = "upwind"  # upwind | central | tvd
    theta_body: float = 1.0  # isothermal body temperature
    theta_in: float = 0.0  # inflow temperature
    body_diameter: float = 1.0  # D of the Nusselt normalization
    poisson: Poisson3DConfig = Poisson3DConfig(method="dct")
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-3
    dt_min: float = 1e-6
    dt_max: float = 1.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def init_state(cfg: Transport3DConfig, u0=None, v0=None, w0=None, theta0=None, *,
               device) -> Transport3DState:
    """Zero velocities (or the given ones) and θ = θ_in (or ``theta0``) on
    ``device``."""
    g = cfg.grid
    flow = mac3d.mac3d_state(g.nx, g.ny, g.nz, u0, v0, w0, device=device)
    if theta0 is None:
        theta = torch.full((g.nz, g.ny, g.nx), cfg.theta_in, dtype=torch.float32, device=device)
    else:
        theta = torch.as_tensor(np.asarray(theta0) if not torch.is_tensor(theta0) else theta0,
                                dtype=torch.float32, device=device).clone()
    return Transport3DState(u=flow.u, v=flow.v, w=flow.w, p=flow.p, theta=theta, t=flow.t,
                            step=flow.step)


def _theta_ghost_open(theta, theta_in: float):
    """(nz+2, ny+2, nx+2) ghost-extended θ, a new tensor: the inflow's mirror
    ghost 2θ_in − θ at x_lo, copies at the outflow and the lateral faces."""
    nz, ny, nx = theta.shape
    te = theta.new_zeros((nz + 2, ny + 2, nx + 2))
    te[1:-1, 1:-1, 1:-1] = theta
    te[1:-1, 1:-1, 0] = 2.0 * theta_in - theta[:, :, 0]
    te[1:-1, 1:-1, -1] = theta[:, :, -1]
    te[:, 0, :] = te[:, 1, :]
    te[:, -1, :] = te[:, -2, :]
    te[0] = te[1]
    te[-1] = te[-2]
    return te


def _theta_faces(theta, te, u, v, w, scheme: str, theta_in: float, muscl):
    """θ at the x, y and z faces: upwind, central, or the MUSCL donors of
    ``muscl`` ((inv_sp, d_lo, d_hi) per axis x, y, z); on the inflow faces
    the advective donor is θ_in, not the mirror ghost."""
    if scheme == "central":
        return (0.5 * (te[1:-1, 1:-1, :-1] + te[1:-1, 1:-1, 1:]),
                0.5 * (te[1:-1, :-1, 1:-1] + te[1:-1, 1:, 1:-1]),
                0.5 * (te[:-1, 1:-1, 1:-1] + te[1:, 1:-1, 1:-1]))
    samples = (te[1:-1, 1:-1, :], te[1:-1, :, 1:-1], te[:, 1:-1, 1:-1])
    faces = []
    for vel, q, axis, m in zip((u, v, w), samples, (2, 1, 0), muscl):
        if scheme == "tvd":
            lo, hi = ms3._muscl_axis(q, *m, axis, True)
        else:
            n = q.shape[axis]
            lo, hi = q.narrow(axis, 0, n - 1), q.narrow(axis, 1, n - 1)
        faces.append(torch.where(vel >= 0.0, lo, hi))
    faces[0][:, :, 0] = torch.where(u[:, :, 0] >= 0.0, theta_in, theta[:, :, 0])
    return tuple(faces)


class _ThetaBody(nn.Module):
    """The isothermal body's θ forcing: ``ibm_mask_c`` penalization or
    ``ibm_ghost_c`` stencils on θ − θ_body; ``forward`` returns (θ,
    heat source Σ Δθ·dV/dt, Nu)."""

    def __init__(self, cfg, ibm_mask_c, ibm_ghost_c, ibm_ramp_steps: int, cell_vol, *, device):
        super().__init__()
        if ibm_ghost_c is not None and ibm_mask_c is not None:
            raise ValueError("ibm_ghost_c and ibm_mask_c are mutually exclusive")
        alpha = cfg.nu / cfg.prandtl
        self.theta_body = cfg.theta_body
        self.compute_metrics = cfg.compute_metrics
        self.ibm_ramp_steps = ibm_ramp_steps
        self.qscale = 1.0 / (np.pi * cfg.body_diameter * alpha
                             * max(abs(cfg.theta_body - cfg.theta_in), 1e-30))
        self.cell_vol = cell_vol  # a float (uniform) or a buffer (stretched)
        self.register_buffer("mask_c", None if ibm_mask_c is None else torch.as_tensor(
            np.asarray(ibm_mask_c) if not torch.is_tensor(ibm_mask_c) else ibm_mask_c,
            dtype=torch.float32, device=device))
        self.ghost_c = None if ibm_ghost_c is None else GhostForcing3D(ibm_ghost_c, device=device)

    def _q(self, dth, dt):
        if torch.is_tensor(self.cell_vol):
            return (dth * self.cell_vol).sum() / dt
        return dth.sum() * self.cell_vol / dt

    def forward(self, theta_new, step, dt, zero):
        q_body = nusselt = zero
        if self.mask_c is not None:
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            dth = (self.theta_body - theta_new) * (strength * self.mask_c)
            theta_new = theta_new + dth
            if self.compute_metrics:
                q_body = self._q(dth, dt)
                nusselt = q_body * self.qscale
        if self.ghost_c is not None:
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            shifted, dneg = self.ghost_c(theta_new - self.theta_body, strength)
            theta_new = shifted + self.theta_body
            if self.compute_metrics:
                q_body = self._q(-dneg, dt)
                nusselt = q_body * self.qscale
        return theta_new, q_body, nusselt


def _check(cfg):
    if cfg.scheme not in ("central", "upwind", "tvd"):
        raise ValueError(f"unknown scheme {cfg.scheme!r}")
    if cfg.theta_scheme not in ("central", "upwind", "tvd"):
        raise ValueError(f"unknown theta_scheme {cfg.theta_scheme!r}")


class Transport3DStep(nn.Module):
    """``step(state, cfl_scale) -> (state, Transport3DMetrics)``: the flow
    step ``flow`` (``mac3d``'s on a uniform grid, ``mac_stretched3d``'s on a
    stretched one: external-flow BCs, penalization masks or ghost stencils,
    the exact projection), then θ advected by its projected velocities and
    diffused, and the isothermal body's θ forcing. The θ-diffusion
    stability bound joins the flow's dt_max."""

    reads_host = False

    def __init__(self, cfg: Transport3DConfig, flow, ibm_mask_c, ibm_ghost_c,
                 ibm_ramp_steps: int, cell_vol, *, device):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.flow = flow
        self.theta_body = _ThetaBody(cfg, ibm_mask_c, ibm_ghost_c, ibm_ramp_steps, cell_vol,
                                     device=device)

    def _theta_terms(self, theta, te, thx, thy, thz, u, v, w):
        """(advection, Laplacian) of θ on the uniform grid."""
        g = self.cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        fxa, fya, fza = u * thx, v * thy, w * thz
        adv = ((fxa[:, :, 1:] - fxa[:, :, :-1]) * (1.0 / dx)
               + (fya[:, 1:, :] - fya[:, :-1, :]) * (1.0 / dy)
               + (fza[1:] - fza[:-1]) * (1.0 / dz))
        ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
        lap = ((te[1:-1, 1:-1, 2:] - 2.0 * theta + te[1:-1, 1:-1, :-2]) * ax
               + (te[1:-1, 2:, 1:-1] - 2.0 * theta + te[1:-1, :-2, 1:-1]) * ay
               + (te[2:, 1:-1, 1:-1] - 2.0 * theta + te[:-2, 1:-1, 1:-1]) * az)
        return adv, lap

    def _muscl(self):
        g = self.cfg.grid
        return tuple((1.0 / d, 0.5 * d, 0.5 * d) for d in (g.dx, g.dy, g.dz))

    def forward(self, state: Transport3DState, cfl_scale):
        cfg = self.cfg
        zero = self.flow.zero
        new_mac, fm = self.flow(mac3d.MAC3DState(u=state.u, v=state.v, w=state.w, p=state.p,
                                                 t=state.t, step=state.step), cfl_scale)
        dt = fm.dt
        u_new, v_new, w_new = new_mac.u, new_mac.v, new_mac.w
        theta = state.theta
        te = _theta_ghost_open(theta, cfg.theta_in)
        thx, thy, thz = _theta_faces(theta, te, u_new, v_new, w_new, cfg.theta_scheme,
                                     cfg.theta_in, self._muscl())
        adv, lap_t = self._theta_terms(theta, te, thx, thy, thz, u_new, v_new, w_new)
        theta_new = theta + dt * ((cfg.nu / cfg.prandtl) * lap_t - adv)
        theta_new, q_body, nusselt = self.theta_body(theta_new, state.step, dt, zero)

        new_state = Transport3DState(u=u_new, v=v_new, w=w_new, p=new_mac.p, theta=theta_new,
                                     t=new_mac.t, step=new_mac.step)
        if not cfg.compute_metrics:
            return new_state, Transport3DMetrics(dt, *([zero] * 10))
        return new_state, Transport3DMetrics(
            dt=dt, div_post=fm.div_post, max_vel=fm.max_vel, energy=fm.energy,
            fx=fm.fx, fy=fm.fy, fz=fm.fz, q_body=q_body, nusselt=nusselt,
            theta_min=theta_new.amin(), theta_max=theta_new.amax())


class StretchedTransport3DStep(Transport3DStep):
    """:class:`Transport3DStep` on a stretched grid: θ's fluxes and its
    flux-form diffusion on the flow step's metric gaps."""

    def _theta_terms(self, theta, te, thx, thy, thz, u, v, w):
        f = self.flow
        fxa, fya, fza = u * thx, v * thy, w * thz
        adv = ((fxa[:, :, 1:] - fxa[:, :, :-1]) * f.inv_hx
               + (fya[:, 1:, :] - fya[:, :-1, :]) * f.inv_hy
               + (fza[1:] - fza[:-1]) * f.inv_hz)
        gx = (te[1:-1, 1:-1, 1:] - te[1:-1, 1:-1, :-1]) * f.inv_dfx
        gy = (te[1:-1, 1:, 1:-1] - te[1:-1, :-1, 1:-1]) * f.inv_dfy
        gz = (te[1:, 1:-1, 1:-1] - te[:-1, 1:-1, 1:-1]) * f.inv_dfz
        lap = ((gx[:, :, 1:] - gx[:, :, :-1]) * f.inv_hx
               + (gy[:, 1:, :] - gy[:, :-1, :]) * f.inv_hy
               + (gz[1:] - gz[:-1]) * f.inv_hz)
        return adv, lap

    def _muscl(self):
        f = self.flow
        return ((f.inv_dfx, f.dxl_f, f.dxr_f), (f.inv_dfy, f.dyl_f, f.dyr_f),
                (f.inv_dfz, f.dzl_f, f.dzr_f))


def _flow_fields(cfg: Transport3DConfig, h_min: float) -> dict:
    """The flow step's configuration fields; the θ-diffusion bound joins
    dt_max."""
    alpha = cfg.nu / cfg.prandtl
    return dict(nu=cfg.nu, scheme=cfg.scheme, adaptive_dt=cfg.adaptive_dt,
                cfl_target=cfg.cfl_target, dt_base=cfg.dt_base, dt_min=cfg.dt_min,
                dt_max=min(cfg.dt_max, 0.125 * h_min * h_min / max(alpha, 1e-30)),
                max_velocity=cfg.max_velocity, compute_metrics=cfg.compute_metrics)


def make_step(cfg: Transport3DConfig, bcs: mac3d.MAC3DBCs, ibm_mask_u=None, ibm_mask_v=None,
              ibm_mask_w=None, ibm_mask_c=None, ibm_ramp_steps: int = 0, ibm_ghost=None,
              ibm_ghost_c=None, *, device) -> Transport3DStep:
    """Build the uniform-grid step module on ``device``: ``ibm_mask_c`` is
    the cell-centred body mask of the θ penalization; ``ibm_ghost`` /
    ``ibm_ghost_c`` (``ibm_ghost.GhostIBM3D`` / ``GhostFaceSet``) the
    ghost-cell treatment of momentum / θ in place of the masks."""
    _check(cfg)
    g = cfg.grid
    flow_cfg = mac3d.MAC3DConfig(grid=g, poisson=cfg.poisson,
                                 **_flow_fields(cfg, min(g.dx, g.dy, g.dz)))
    flow = mac3d.make_step(flow_cfg, bcs, ibm_mask_u, ibm_mask_v, ibm_mask_w,
                           ibm_ramp_steps=ibm_ramp_steps, ibm_ghost=ibm_ghost, device=device)
    return Transport3DStep(cfg, flow, ibm_mask_c, ibm_ghost_c, ibm_ramp_steps,
                           g.dx * g.dy * g.dz, device=device)


def make_stretched_step(cfg: Transport3DConfig, bcs: mac3d.MAC3DBCs, x_faces, y_faces,
                        z_faces, ibm_mask_u=None, ibm_mask_v=None, ibm_mask_w=None,
                        ibm_mask_c=None, ibm_ramp_steps: int = 0, ibm_ghost=None,
                        ibm_ghost_c=None, *, device) -> StretchedTransport3DStep:
    """Build the stretched-grid step module on ``device``; ``cfg.grid`` is
    the nominal uniform descriptor (its nx, ny, nz), the face vectors the
    real geometry. The projection is the exact FDM solve: a non-default
    ``cfg.poisson`` is refused."""
    if cfg.poisson != Poisson3DConfig(method="dct"):
        raise ValueError(
            "make_stretched_step projects with the exact FDM solver; a non-default "
            "Transport3DConfig.poisson cannot be honored on the stretched path")
    _check(cfg)
    g = cfg.grid
    h_min = float(min(np.diff(np.asarray(f, np.float64)).min()
                      for f in (x_faces, y_faces, z_faces)))
    flow_cfg = ms3.StretchedMAC3DConfig(nx=g.nx, ny=g.ny, nz=g.nz, **_flow_fields(cfg, h_min))
    flow = ms3.make_step(flow_cfg, bcs, x_faces, y_faces, z_faces, ibm_mask_u=ibm_mask_u,
                         ibm_mask_v=ibm_mask_v, ibm_mask_w=ibm_mask_w,
                         ibm_ramp_steps=ibm_ramp_steps, ibm_ghost=ibm_ghost, device=device)
    return StretchedTransport3DStep(cfg, flow, ibm_mask_c, ibm_ghost_c, ibm_ramp_steps,
                                    flow.cell_vol, device=device)
