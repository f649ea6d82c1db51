"""Incompressible MAC solver on stretched (nonuniform tensor-product)
grids (``cfdsim_tpu.models.mac_stretched``).

Grid lines cluster where the flow needs them (tanh wall clustering,
Gaussian refinement around a body and its wake) while the discretization
stays structured. The projection stays exact: the separable stretched
pressure operator is solved directly by fast diagonalization
(``solvers/fdm.py``, four full-fp32 matmuls).

The layout is ``models/mac.py``'s (u on x-faces (ny, nx+1), v on y-faces
(ny+1, nx), p at centres), and so are the state (``MACState``) and the BCs
(``MACBCs``): the wall-tangential ghost (ghost = 2·wall − first row, ghost
gap = first cell width) reproduces the half-cell wall gradient exactly. The
metric coefficients (cell widths, centre gaps, interpolation weights) are
float32 buffers built once in float64 numpy.

Not ported: the ghost-cell IBM (``ibm_ghost=``, ``moving_scheme="ghost"``),
which raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac import (
    MACBCs,
    MACState,
    _add_interior,
    check_mac_options,
    mac_state,
    moving_body_masks,
)
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.solvers.fdm import make_fdm_solver


@dataclasses.dataclass(frozen=True)
class StretchedMACConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    nx: int
    ny: int
    nu: float
    scheme: str = "central"  # central | upwind | tvd
    projection: str = "chorin"  # chorin | incremental (see mac.MACConfig)
    time_scheme: str = "euler"  # euler | rk2
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    warmup_steps: int = 0
    warmup_dt: float = 0.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def stretched_faces(n: int, length: float, refine=(), x_min: float = 0.0):
    """Monotone face coordinates (n+1,) on [x_min, x_min+length] whose
    spacing shrinks inside Gaussian refinement regions ``refine``, a
    sequence of (center, width, strength): the local spacing is divided by
    1 + strength·exp(−((x−center)/width)²)."""
    s = np.linspace(0.0, 1.0, 4 * n + 1)
    x_probe = x_min + s * length
    w = np.ones_like(s)
    for center, width, strength in refine:
        w += strength * np.exp(-(((x_probe - center) / width) ** 2))
    density = w / np.trapezoid(w, s)
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (density[1:] + density[:-1]) * np.diff(s))])
    cdf /= cdf[-1]
    faces = x_min + np.interp(np.linspace(0, 1, n + 1), cdf, s) * length
    faces[0], faces[-1] = x_min, x_min + length
    return faces


def wall_clustered_faces(n: int, length: float, beta: float = 2.0, x_min: float = 0.0):
    """tanh clustering at both walls; a larger ``beta`` makes finer wall cells."""
    s = np.linspace(-1.0, 1.0, n + 1)
    x = np.tanh(beta * s) / np.tanh(beta)
    return x_min + (x + 1.0) * 0.5 * length


class _Metrics1D(NamedTuple):
    h: np.ndarray      # cell widths (n,)
    xc: np.ndarray     # cell centres (n,)
    dc: np.ndarray     # interior centre gaps (n-1,)
    dfull: np.ndarray  # centre gaps with the ghost gaps h[0], h[-1] (n+1,)
    wf: np.ndarray     # interior-face weight toward the higher cell


def _metrics(faces) -> _Metrics1D:
    f = np.asarray(faces, np.float64)
    h = np.diff(f)
    xc = 0.5 * (f[:-1] + f[1:])
    dc = np.diff(xc)
    dfull = np.concatenate([[h[0]], dc, [h[-1]]])
    wf = (f[1:-1] - xc[:-1]) / dc
    return _Metrics1D(h, xc, dc, dfull, wf)


def init_state(cfg: StretchedMACConfig, u0=None, v0=None, p0=None, *, device) -> MACState:
    return mac_state(cfg.nx, cfg.ny, u0, v0, p0, device=device)


class StretchedMACStep(nn.Module):
    """``step(state, cfl_scale) -> (state, StepMetrics)`` on the stretched
    grid of face coordinates ``x_faces`` (nx+1,) and ``y_faces`` (ny+1,).
    Metric coefficients, the FDM matrices, the IBM masks and their control
    volumes are buffers on ``device``; the step reads nothing on the host."""

    reads_host = False

    def __init__(self, cfg: StretchedMACConfig, bcs: MACBCs, x_faces, y_faces,
                 ibm_mask_u=None, ibm_mask_v=None, ibm_ramp_steps: int = 0, moving_body=None,
                 ibm_ghost=None, moving_scheme: str = "penalize", *, device):
        super().__init__()
        check_mac_options("fp32", ibm_ghost, moving_scheme)
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown projection {cfg.projection!r}")
        if cfg.scheme not in ("central", "upwind", "tvd"):
            raise ValueError(f"unknown scheme {cfg.scheme!r}")
        mx, my = _metrics(x_faces), _metrics(y_faces)
        if len(mx.h) != cfg.nx or len(my.h) != cfg.ny:
            raise ValueError(f"faces for {len(my.h)}×{len(mx.h)} cells, config {cfg.ny}×{cfg.nx}")
        self.cfg = cfg
        self.bcs = bcs
        self.device = torch.device(device)
        self.ibm_ramp_steps = ibm_ramp_steps
        self.moving_body = moving_body
        self.h_min = float(min(mx.h.min(), my.h.min()))
        self.fdm = make_fdm_solver(mx.h, my.h, device=device)
        xf, yf = np.asarray(x_faces, np.float64), np.asarray(y_faces, np.float64)

        def buf(name, x, row=None):
            """A float32 buffer; ``row=True`` shapes a 1D table (1, n), False (n, 1)."""
            if x is not None and not torch.is_tensor(x):
                x = np.asarray(x, np.float64)
                if row is not None:
                    x = x[None, :] if row else x[:, None]
            self.register_buffer(name, None if x is None else torch.as_tensor(
                np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                dtype=torch.float32, device=device))

        buf("inv_hx", 1.0 / mx.h, row=True)
        buf("inv_hy", 1.0 / my.h, row=False)
        buf("inv_dcx", 1.0 / mx.dc, row=True)  # interior u-faces
        buf("inv_dcy", 1.0 / my.dc, row=False)  # interior v-faces
        buf("inv_dfx", 1.0 / mx.dfull, row=True)  # u-centre gaps with the ghosts
        buf("inv_dfy", 1.0 / my.dfull, row=False)
        # corner interpolation weights toward the upper row / right column
        buf("wcy", np.concatenate([[0.5], my.wf, [0.5]]), row=False)
        buf("wcx", np.concatenate([[0.5], mx.wf, [0.5]]), row=True)
        # upwind donor distances: face → centre, and centre (ghosts included) → face
        buf("dxl", mx.xc - xf[:-1], row=True)
        buf("dxr", xf[1:] - mx.xc, row=True)
        yg = np.concatenate([[my.xc[0] - my.h[0]], my.xc, [my.xc[-1] + my.h[-1]]])
        buf("dyl", yf - yg[:-1], row=False)
        buf("dyr", yg[1:] - yf, row=False)
        buf("dyl_c", my.xc - yf[:-1], row=False)
        buf("dyr_c", yf[1:] - my.xc, row=False)
        xg = np.concatenate([[mx.xc[0] - mx.h[0]], mx.xc, [mx.xc[-1] + mx.h[-1]]])
        buf("dxl_g", xf - xg[:-1], row=True)
        buf("dxr_g", xg[1:] - xf, row=True)
        # face control volumes (forces) and cell volumes (energy)
        buf("area_u", np.outer(my.h, mx.dfull))
        buf("area_v", np.outer(my.dfull, mx.h))
        buf("cell_w", np.outer(my.h, mx.h))
        self.volume = float(np.sum(np.outer(my.h, mx.h)))
        buf("mask_u", ibm_mask_u)
        buf("mask_v", ibm_mask_v)
        buf("dt_base", np.float32(cfg.dt_base))
        buf("warmup_dt", np.float32(cfg.warmup_dt))
        buf("zero", np.float32(0.0))
        if moving_body is not None:
            for names, (a, b) in ((("Xu", "Yu"), (xf, my.xc)), (("Xv", "Yv"), (mx.xc, yf))):
                for name, arr in zip(names, np.meshgrid(a, b, indexing="xy")):
                    buf(name, arr)

    def _adaptive_dt(self, u, v, step, cfl_scale):
        cfg = self.cfg
        if not cfg.adaptive_dt:
            return self.dt_base
        h = self.h_min
        vel_max = torch.maximum(u.abs().amax(), v.abs().amax()).clamp(min=1e-10)
        dt = cfg.cfl_target * cfl_scale * h / vel_max
        dt = dt.clamp(max=0.2 * h * h / cfg.nu).clamp(cfg.dt_min, cfg.dt_max)
        if cfg.warmup_steps > 0:
            dt = torch.where(step < cfg.warmup_steps, self.warmup_dt, dt)
        return dt

    def _advect(self, u, v, ue, ve):
        """Conservative advection on the stretched layout: (conv_u, conv_v)
        on the interior u-faces (ny, nx−1) and v-faces (ny−1, nx)."""
        scheme = self.cfg.scheme
        uc = 0.5 * (u[:, :-1] + u[:, 1:])
        vc = 0.5 * (v[:-1, :] + v[1:, :])
        u_y = (1.0 - self.wcy) * ue[:-1, :] + self.wcy * ue[1:, :]  # (ny+1, nx+1)
        v_x = (1.0 - self.wcx) * ve[:, :-1] + self.wcx * ve[:, 1:]  # (ny+1, nx+1)
        if scheme == "central":
            u_adv_c, u_adv_y, v_adv_c, v_adv_x = uc, u_y, vc, v_x
        else:
            if scheme == "tvd":
                gx = F.pad(vanleer_slope((u[:, 1:-1] - u[:, :-2]) * self.inv_hx[:, :-1],
                                         (u[:, 2:] - u[:, 1:-1]) * self.inv_hx[:, 1:]), (1, 1))
                gy_u = F.pad(vanleer_slope((ue[1:-1, :] - ue[:-2, :]) * self.inv_dfy[:-1, :],
                                           (ue[2:, :] - ue[1:-1, :]) * self.inv_dfy[1:, :]),
                             (0, 0, 1, 1))
                gy = F.pad(vanleer_slope((v[1:-1, :] - v[:-2, :]) * self.inv_hy[:-1, :],
                                         (v[2:, :] - v[1:-1, :]) * self.inv_hy[1:, :]),
                           (0, 0, 1, 1))
                gx_v = F.pad(vanleer_slope((ve[:, 1:-1] - ve[:, :-2]) * self.inv_dfx[:, :-1],
                                           (ve[:, 2:] - ve[:, 1:-1]) * self.inv_dfx[:, 1:]),
                             (1, 1))
            else:
                gx, gy_u, gy, gx_v = (torch.zeros_like(q) for q in (u, ue, v, ve))
            u_adv_c = torch.where(uc >= 0.0, u[:, :-1] + gx[:, :-1] * self.dxl,
                                  u[:, 1:] - gx[:, 1:] * self.dxr)
            u_adv_y = torch.where(v_x >= 0.0, ue[:-1, :] + gy_u[:-1, :] * self.dyl,
                                  ue[1:, :] - gy_u[1:, :] * self.dyr)
            v_adv_c = torch.where(vc >= 0.0, v[:-1, :] + gy[:-1, :] * self.dyl_c,
                                  v[1:, :] - gy[1:, :] * self.dyr_c)
            v_adv_x = torch.where(u_y >= 0.0, ve[:, :-1] + gx_v[:, :-1] * self.dxl_g,
                                  ve[:, 1:] - gx_v[:, 1:] * self.dxr_g)
        F_u = uc * u_adv_c
        G_u = v_x * u_adv_y
        G_v = vc * v_adv_c
        F_v = u_y * v_adv_x
        conv_u = (F_u[:, 1:] - F_u[:, :-1]) * self.inv_dcx + (
            G_u[1:, 1:-1] - G_u[:-1, 1:-1]) * self.inv_hy
        conv_v = (F_v[1:-1, 1:] - F_v[1:-1, :-1]) * self.inv_hx + (
            G_v[1:, :] - G_v[:-1, :]) * self.inv_dcy
        return conv_u, conv_v

    def _diffuse(self, ue, ve):
        """The Laplacians in flux form with the metric coefficients, on the
        interior u-faces and v-faces."""
        dudx = (ue[1:-1, 1:] - ue[1:-1, :-1]) * self.inv_hx
        lap_u_x = (dudx[:, 1:] - dudx[:, :-1]) * self.inv_dcx
        dudy = (ue[1:, :] - ue[:-1, :]) * self.inv_dfy
        lap_u_y = (dudy[1:, 1:-1] - dudy[:-1, 1:-1]) * self.inv_hy
        dvdy = (ve[1:, 1:-1] - ve[:-1, 1:-1]) * self.inv_hy
        lap_v_y = (dvdy[1:, :] - dvdy[:-1, :]) * self.inv_dcy
        dvdx = (ve[:, 1:] - ve[:, :-1]) * self.inv_dfx
        lap_v_x = (dvdx[1:-1, 1:] - dvdx[1:-1, :-1]) * self.inv_hx
        return lap_u_x + lap_u_y, lap_v_x + lap_v_y

    def divergence(self, u, v):
        return (u[:, 1:] - u[:, :-1]) * self.inv_hx + (v[1:, :] - v[:-1, :]) * self.inv_hy

    def _stage(self, state, u, v, p_warm, t_s, dt):
        """One projected Euler stage (``models/mac.py``'s pattern); leaves u,
        v and p_warm as they were."""
        cfg = self.cfg
        step = state.step
        set_normal = self.bcs.set_normal
        ue, ve = self.bcs.extend(u, v, step, t_s)
        conv_u, conv_v = self._advect(u, v, ue, ve)
        lap_u, lap_v = self._diffuse(ue, ve)
        u_star = _add_interior(u.clone(), 1, dt * (cfg.nu * lap_u - conv_u))
        v_star = _add_interior(v.clone(), 0, dt * (cfg.nu * lap_v - conv_v))
        if cfg.projection == "incremental":
            _add_interior(u_star, 1, -dt * (p_warm[:, 1:] - p_warm[:, :-1]) * self.inv_dcx)
            _add_interior(v_star, 0, -dt * (p_warm[1:, :] - p_warm[:-1, :]) * self.inv_dcy)
        u_star, v_star = set_normal(u_star, v_star, step, t_s)

        fx = fy = self.zero
        if self.mask_u is not None:
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            du_ibm = u_star * (strength * self.mask_u)
            dv_ibm = v_star * (strength * self.mask_v)
            u_star = u_star - du_ibm
            v_star = v_star - dv_ibm
            if cfg.compute_metrics:
                # the momentum sink weighted by the face control volumes
                fx = (du_ibm * self.area_u).sum() / dt
                fy = (dv_ibm * self.area_v).sum() / dt
        if self.moving_body is not None:
            ub, vb = self.moving_body.velocity(t_s)
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            # the taper is the smallest spacing (the body stays in the refined region)
            m_u, m_v = moving_body_masks(self.moving_body, self.Xu, self.Yu, self.Xv, self.Yv,
                                         self.h_min, t_s)
            du_mb = (u_star - ub) * (strength * m_u)
            dv_mb = (v_star - vb) * (strength * m_v)
            u_star = u_star - du_mb
            v_star = v_star - dv_mb
            if cfg.compute_metrics:
                fx = fx + (du_mb * self.area_u).sum() / dt
                fy = fy + (dv_mb * self.area_v).sum() / dt

        div_star = self.divergence(u_star, v_star)
        phi = self.fdm(div_star / dt)  # exact (four full-fp32 matmuls)
        u_new = _add_interior(u_star, 1, -dt * (phi[:, 1:] - phi[:, :-1]) * self.inv_dcx)
        v_new = _add_interior(v_star, 0, -dt * (phi[1:, :] - phi[:-1, :]) * self.inv_dcy)
        u_new, v_new = set_normal(u_new, v_new, step, t_s)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        if cfg.projection == "incremental":
            phi = p_warm + phi
        return u_new, v_new, phi, (fx, fy, div_star)

    def forward(self, state: MACState, cfl_scale):
        cfg = self.cfg
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        u, v = self.bcs.set_normal(state.u.clone(), state.v.clone(), state.step, state.t)
        dt = self._adaptive_dt(u, v, state.step, cfl_scale)
        u_new, v_new, p, (fx, fy, div_star) = self._stage(state, u, v, state.p, state.t, dt)
        if cfg.time_scheme == "rk2":
            # Heun: the average with a second projected stage
            t2 = state.t + dt
            u2, v2, p2, (fx2, fy2, div_star) = self._stage(state, u_new, v_new, p, t2, dt)
            u_new, v_new = self.bcs.set_normal(0.5 * (u + u2), 0.5 * (v + v2), state.step, t2)
            p = 0.5 * (p + p2)
            fx = 0.5 * (fx + fx2)
            fy = 0.5 * (fy + fy2)

        new_state = MACState(u=u_new, v=v_new, p=p, t=state.t + dt, step=state.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_state, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                          zero)
        div_post = self.divergence(u_new, v_new)
        ucc = 0.5 * (u_new[:, :-1] + u_new[:, 1:])
        vcc = 0.5 * (v_new[:-1, :] + v_new[1:, :])
        vort = ((v_new[:, 1:] - v_new[:, :-1]) * self.inv_dcx)[1:-1, :] - (
            (u_new[1:, :] - u_new[:-1, :]) * self.inv_dcy)[:, 1:-1]
        return new_state, StepMetrics(
            dt=dt,
            div_pre=div_star.abs().amax(),
            div_post=div_post.abs().amax(),
            max_vel=torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            # the cell-volume-weighted mean kinetic energy
            energy=(self.cell_w * 0.5 * (ucc * ucc + vcc * vcc)).sum() / self.volume,
            vort_max=vort.abs().amax(),
            poisson_res=zero,  # FDM is exact (full-fp32 matmuls)
            fx=fx,
            fy=fy,
            fz=zero,
        )


def make_step(cfg: StretchedMACConfig, bcs: MACBCs, x_faces, y_faces, ibm_mask_u=None,
              ibm_mask_v=None, ibm_ramp_steps: int = 0, moving_body=None, ibm_ghost=None,
              moving_scheme: str = "penalize", *, device) -> StretchedMACStep:
    """Build the stretched step module on ``device`` (see
    :class:`StretchedMACStep`): ``ibm_mask_u``/``ibm_mask_v`` are
    face-sampled penalization masks (forces weighted by the face control
    volumes); ``moving_body`` the moving-geometry IBM with a taper of the
    smallest grid spacing."""
    return StretchedMACStep(cfg, bcs, x_faces, y_faces, ibm_mask_u, ibm_mask_v,
                            ibm_ramp_steps, moving_body, ibm_ghost, moving_scheme, device=device)
