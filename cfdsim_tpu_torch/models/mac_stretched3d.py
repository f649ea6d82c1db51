"""3D incompressible MAC solver on stretched (tensor-product) grids
(``cfdsim_tpu.models.mac_stretched3d``): the 3D member of the stretched
tier.

Face velocities on a nonuniform tensor-product grid in the layout of
``models/mac3d.py`` (u (nz, ny, nx+1), v (nz, ny+1, nx), w (nz+1, ny, nx),
p (nz, ny, nx); its ``MAC3DState`` and ``MAC3DBCs``), conservative
advection in divergence form with metric-weighted interpolants (central,
or upwind / van Leer MUSCL donor values on the nonuniform metrics),
flux-form diffusion, and the exact projection by 3D fast diagonalization
(``solvers/fdm.py::FDMSolver3D``: six full-float32 products). LES with the
local filter width Δ = (hx hy hz)^{1/3}, static Smagorinsky or dynamic
Germano–Lilly (``ops/les_dynamic.py``, Δ² inside the identity, IBM body
cells left out of the contraction); ``chorin`` or ``incremental``
projection, ``euler`` or ``rk2``. Immersed bodies: face-sampled
penalization masks, the static ghost-cell IBM and a moving body (sharp
masks with a taper of the smallest spacing, or ghost stencils located by
``searchsorted``), forces weighted by the staggered control volumes. The
metric coefficients are float32 buffers built once in float64 numpy; the
step reads nothing on the host, so a chunk of steps captures into one
CUDA graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.ibm_ghost import GhostForcing3D, moving_ghost_forcing_3d_nonuniform
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac3d import (
    MAC3DBCs,
    MAC3DState,
    _BodyCoords,
    cavity3d_bcs,
    check_mac3d_options,
    diffuse_les_metric,
    face_coords_3d,
    mac3d_state,
    moving_body_masks_3d,
    strain_magnitude_metric,
)
from cfdsim_tpu_torch.models.mac_stretched import _metrics
from cfdsim_tpu_torch.ops.les_dynamic import dynamic_cs2_3d, ibm_fluid_mask_centers
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.solvers.fdm import make_fdm_solver_3d

__all__ = ["MAC3DState", "StretchedMAC3DConfig", "cavity3d_bcs", "init_state", "make_step",
           "smagorinsky_viscosity_stretched3d"]


def _muscl_axis(q, inv_sp, d_lo, d_hi, axis: int, tvd: bool):
    """(q_lo, q_hi) MUSCL donor values at the targets between consecutive
    samples of ``q`` along ``axis`` on a nonuniform grid: van Leer limited
    gradients of the one-sided divided differences (``inv_sp`` = 1/gap per
    interval), advanced by the donor→target distances ``d_lo``/``d_hi``;
    ``tvd=False`` gives the plain donor samples (first-order upwind)."""
    n = q.shape[axis]
    lo, hi = q.narrow(axis, 0, n - 1), q.narrow(axis, 1, n - 1)
    if not tvd:
        return lo, hi
    dq = (hi - lo) * inv_sp
    m = dq.shape[axis]
    g = vanleer_slope(dq.narrow(axis, 0, m - 1), dq.narrow(axis, 1, m - 1))
    pads = [0] * (2 * q.ndim)
    pads[2 * (q.ndim - 1 - axis)] = pads[2 * (q.ndim - 1 - axis) + 1] = 1
    g = F.pad(g, pads)  # zero gradient at the end samples
    return lo + g.narrow(axis, 0, n - 1) * d_lo, hi - g.narrow(axis, 1, n - 1) * d_hi


def smagorinsky_viscosity_stretched3d(u, v, w, ghosts, inv_hx, inv_hy, inv_hz, inv_dfx,
                                      inv_dfy, inv_dfz, cs2_delta2):
    """ν_t = (C_s Δ)²|S| at the cell centres on stretched metrics
    (``cs2_delta2`` = (C_s Δ_ijk)² precomputed; ``mac3d.
    strain_magnitude_metric``)."""
    return cs2_delta2 * strain_magnitude_metric(u, v, w, ghosts, (inv_hx, inv_hy, inv_hz),
                                                (inv_dfx, inv_dfy, inv_dfz))


@dataclasses.dataclass(frozen=True)
class StretchedMAC3DConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    nx: int
    ny: int
    nz: int
    nu: float
    scheme: str = "central"  # central | upwind | tvd
    use_les: bool = False
    smagorinsky_constant: float = 0.17
    les_model: str = "smagorinsky"  # smagorinsky | dynamic
    projection: str = "chorin"  # chorin | incremental
    time_scheme: str = "euler"  # euler | rk2
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def init_state(cfg: StretchedMAC3DConfig, u0=None, v0=None, w0=None, p0=None, *,
               device) -> MAC3DState:
    """A zero state (or the given fields) on ``device``."""
    return mac3d_state(cfg.nx, cfg.ny, cfg.nz, u0, v0, w0, p0, device=device)


class StretchedMAC3DStep(nn.Module):
    """``step(state, cfl_scale) -> (state, StepMetrics)`` on the stretched
    grid of face coordinates ``x_faces`` (nx+1,), ``y_faces``, ``z_faces``.
    Metric coefficients, the FDM matrices, the IBM masks, ghost stencils and
    control volumes are buffers on ``device``."""

    reads_host = False

    def __init__(self, cfg: StretchedMAC3DConfig, bcs: MAC3DBCs, x_faces, y_faces, z_faces,
                 ibm_mask_u=None, ibm_mask_v=None, ibm_mask_w=None, ibm_ramp_steps: int = 0,
                 moving_body=None, ibm_ghost=None, moving_scheme: str = "penalize", *, device):
        super().__init__()
        check_mac3d_options(cfg, ibm_ghost, ibm_mask_u, moving_body, moving_scheme)
        mx, my, mz = _metrics(x_faces), _metrics(y_faces), _metrics(z_faces)
        if (len(mx.h), len(my.h), len(mz.h)) != (cfg.nx, cfg.ny, cfg.nz):
            raise ValueError(f"faces for {len(mz.h)}×{len(my.h)}×{len(mx.h)} cells, config "
                             f"{cfg.nz}×{cfg.ny}×{cfg.nx}")
        self.cfg = cfg
        self.bcs = bcs
        self.device = torch.device(device)
        self.ibm_ramp_steps = ibm_ramp_steps
        self.moving_body = moving_body
        self.moving_scheme = moving_scheme
        self.h_min = float(min(mx.h.min(), my.h.min(), mz.h.min()))
        self.fdm = make_fdm_solver_3d(mx.h, my.h, mz.h, device=device)
        xf, yf, zf = (np.asarray(a, np.float64) for a in (x_faces, y_faces, z_faces))

        def buf(name, x, axis=None):
            """A float32 buffer; a 1D table along ``axis`` (0 z, 1 y, 2 x) is
            shaped to broadcast over (nz, ny, nx)."""
            if x is not None and not torch.is_tensor(x):
                x = np.asarray(x, np.float64)
                if axis is not None:
                    x = x.reshape([-1 if a == axis else 1 for a in range(3)])
            self.register_buffer(name, None if x is None else torch.as_tensor(
                np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                dtype=torch.float32, device=device))

        for m, a, ax in ((mx, "x", 2), (my, "y", 1), (mz, "z", 0)):
            buf(f"inv_h{a}", 1.0 / m.h, ax)  # cell widths
            buf(f"inv_dc{a}", 1.0 / m.dc, ax)  # interior faces
            buf(f"inv_df{a}", 1.0 / m.dfull, ax)  # centre gaps with the ghosts
            # interior-face interpolation weights (the ghost faces take 0.5)
            buf(f"wf{a}", np.concatenate([[0.5], m.wf, [0.5]]), ax)
        # MUSCL donor distances: face samples advected to the centres (_c),
        # ghost-extended centre samples advected to the faces (_f)
        for m, f, a, ax in ((mx, xf, "x", 2), (my, yf, "y", 1), (mz, zf, "z", 0)):
            g = np.concatenate([[m.xc[0] - m.h[0]], m.xc, [m.xc[-1] + m.h[-1]]])
            buf(f"d{a}l_c", m.xc - f[:-1], ax)
            buf(f"d{a}r_c", f[1:] - m.xc, ax)
            buf(f"d{a}l_f", f - g[:-1], ax)
            buf(f"d{a}r_f", g[1:] - f, ax)
        hz, hy, hx = mz.h[:, None, None], my.h[None, :, None], mx.h[None, None, :]
        buf("cell_vol", hz * hy * hx)
        self.volume = float(np.sum(mz.h) * np.sum(my.h) * np.sum(mx.h))
        if ibm_mask_u is not None or moving_body is not None or ibm_ghost is not None:
            # the staggered control volumes of the body force
            buf("cv_u", hz * hy * mx.dfull[None, None, :])
            buf("cv_v", hz * my.dfull[None, :, None] * hx)
            buf("cv_w", mz.dfull[:, None, None] * hy * hx)
        buf("mask_u", ibm_mask_u)
        buf("mask_v", ibm_mask_v)
        buf("mask_w", ibm_mask_w)
        self.ghost = None
        if ibm_ghost is not None:
            self.ghost = nn.ModuleList(GhostForcing3D(gs, device=device) for gs in ibm_ghost)
        if cfg.use_les:
            buf("delta2", (hz * hy * hx) ** (2.0 / 3.0))
            if cfg.les_model == "dynamic":

                def g2(xc):
                    xg = np.concatenate([[xc[0]], xc, [xc[-1]]])
                    return 1.0 / (xg[2:] - xg[:-2])

                buf("inv_g2x", g2(mx.xc), 2)
                buf("inv_g2y", g2(my.xc), 1)
                buf("inv_g2z", g2(mz.xc), 0)
                fluid = ibm_fluid_mask_centers(self.mask_u, self.mask_v, self.mask_w, ibm_ghost)
                self.register_buffer("les_fluid_mask",
                                     None if fluid is None else fluid.to(device))
            else:
                # (C_s Δ)² from the float32 Δ², as the JAX package rounds it
                buf("cs2_delta2", cfg.smagorinsky_constant ** 2 * self.delta2)
        self.body = None
        if moving_body is not None:
            self.body = _BodyCoords(face_coords_3d(xf, yf, zf, mx.xc, my.xc, mz.xc),
                                    device=device)
            # the sample coordinates the moving ghost forcing searches, float32
            for comp, samples in zip("uvw", ((xf, my.xc, mz.xc), (mx.xc, yf, mz.xc),
                                             (mx.xc, my.xc, zf))):
                for a, s in zip("xyz", samples):
                    buf(f"{a}s_{comp}", s)
        buf("dt_base", np.float32(cfg.dt_base))
        buf("zero", np.float32(0.0))

    def _nu_turb(self, u, v, w, ghosts):
        """ν_t at the cell centres (static, or dynamic: C_s² a device scalar)."""
        metrics = (self.inv_hx, self.inv_hy, self.inv_hz, self.inv_dfx, self.inv_dfy,
                   self.inv_dfz)
        if self.cfg.les_model == "dynamic":
            uc = 0.5 * (u[:, :, 1:] + u[:, :, :-1])
            vc = 0.5 * (v[:, 1:, :] + v[:, :-1, :])
            wc = 0.5 * (w[1:] + w[:-1])
            cs2 = dynamic_cs2_3d(uc, vc, wc, self.inv_g2x, self.inv_g2y, self.inv_g2z,
                                 self.delta2, mask=self.les_fluid_mask)
            return cs2 * smagorinsky_viscosity_stretched3d(u, v, w, ghosts, *metrics,
                                                           self.delta2)
        return smagorinsky_viscosity_stretched3d(u, v, w, ghosts, *metrics, self.cs2_delta2)

    def divergence(self, u, v, w):
        return ((u[:, :, 1:] - u[:, :, :-1]) * self.inv_hx
                + (v[:, 1:, :] - v[:, :-1, :]) * self.inv_hy
                + (w[1:] - w[:-1]) * self.inv_hz)

    def _advect(self, u, v, w, ghosts):
        """Conservative advection on the stretched layout: (conv_u, conv_v,
        conv_w) on the interior faces."""
        u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
        wfx, wfy, wfz = self.wfx, self.wfy, self.wfz
        # edge interpolants with the metric weights (0.5 at the ghosts)
        u_y = (1.0 - wfy) * u_gy[:, :-1, :] + wfy * u_gy[:, 1:, :]
        v_x = (1.0 - wfx) * v_gx[:, :, :-1] + wfx * v_gx[:, :, 1:]
        u_z = (1.0 - wfz) * u_gz[:-1] + wfz * u_gz[1:]
        w_x = (1.0 - wfx) * w_gx[:, :, :-1] + wfx * w_gx[:, :, 1:]
        v_z = (1.0 - wfz) * v_gz[:-1] + wfz * v_gz[1:]
        w_y = (1.0 - wfy) * w_gy[:, :-1, :] + wfy * w_gy[:, 1:, :]
        uc = 0.5 * (u[:, :, :-1] + u[:, :, 1:])
        vc = 0.5 * (v[:, :-1, :] + v[:, 1:, :])
        wc = 0.5 * (w[:-1] + w[1:])
        if self.cfg.scheme == "central":
            F_u, G_u, H_u = uc * uc, v_x * u_y, w_x * u_z
            F_v, G_v, H_v = u_y * v_x, vc * vc, w_y * v_z
            F_w, G_w, H_w = u_z * w_x, v_z * w_y, wc * wc
        else:
            tvd = self.cfg.scheme == "tvd"

            def flux(adv, q, inv_sp, d_lo, d_hi, axis):
                lo, hi = _muscl_axis(q, inv_sp, d_lo, d_hi, axis, tvd)
                return adv * torch.where(adv >= 0.0, lo, hi)

            F_u = flux(uc, u, self.inv_hx, self.dxl_c, self.dxr_c, 2)
            G_u = flux(v_x, u_gy, self.inv_dfy, self.dyl_f, self.dyr_f, 1)
            H_u = flux(w_x, u_gz, self.inv_dfz, self.dzl_f, self.dzr_f, 0)
            F_v = flux(u_y, v_gx, self.inv_dfx, self.dxl_f, self.dxr_f, 2)
            G_v = flux(vc, v, self.inv_hy, self.dyl_c, self.dyr_c, 1)
            H_v = flux(w_y, v_gz, self.inv_dfz, self.dzl_f, self.dzr_f, 0)
            F_w = flux(u_z, w_gx, self.inv_dfx, self.dxl_f, self.dxr_f, 2)
            G_w = flux(v_z, w_gy, self.inv_dfy, self.dyl_f, self.dyr_f, 1)
            H_w = flux(wc, w, self.inv_hz, self.dzl_c, self.dzr_c, 0)
        conv_u = ((F_u[:, :, 1:] - F_u[:, :, :-1]) * self.inv_dcx
                  + (G_u[:, 1:, 1:-1] - G_u[:, :-1, 1:-1]) * self.inv_hy
                  + (H_u[1:, :, 1:-1] - H_u[:-1, :, 1:-1]) * self.inv_hz)
        conv_v = ((F_v[:, 1:-1, 1:] - F_v[:, 1:-1, :-1]) * self.inv_hx
                  + (G_v[:, 1:, :] - G_v[:, :-1, :]) * self.inv_dcy
                  + (H_v[1:, 1:-1, :] - H_v[:-1, 1:-1, :]) * self.inv_hz)
        conv_w = ((F_w[1:-1, :, 1:] - F_w[1:-1, :, :-1]) * self.inv_hx
                  + (G_w[1:-1, 1:, :] - G_w[1:-1, :-1, :]) * self.inv_hy
                  + (H_w[1:, :, :] - H_w[:-1, :, :]) * self.inv_dcz)
        return conv_u, conv_v, conv_w

    def _diffuse(self, u, v, w, ghosts):
        """The constant-ν Laplacians in flux form on the metric gaps."""
        u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
        dux = (u[:, :, 1:] - u[:, :, :-1]) * self.inv_hx  # at centres
        duy = (u_gy[:, 1:, :] - u_gy[:, :-1, :]) * self.inv_dfy  # at y-edges
        duz = (u_gz[1:] - u_gz[:-1]) * self.inv_dfz  # at z-edges
        lap_u = ((dux[:, :, 1:] - dux[:, :, :-1]) * self.inv_dcx
                 + (duy[:, 1:, 1:-1] - duy[:, :-1, 1:-1]) * self.inv_hy
                 + (duz[1:, :, 1:-1] - duz[:-1, :, 1:-1]) * self.inv_hz)
        dvy = (v[:, 1:, :] - v[:, :-1, :]) * self.inv_hy
        dvx = (v_gx[:, :, 1:] - v_gx[:, :, :-1]) * self.inv_dfx
        dvz = (v_gz[1:] - v_gz[:-1]) * self.inv_dfz
        lap_v = ((dvx[:, 1:-1, 1:] - dvx[:, 1:-1, :-1]) * self.inv_hx
                 + (dvy[:, 1:, :] - dvy[:, :-1, :]) * self.inv_dcy
                 + (dvz[1:, 1:-1, :] - dvz[:-1, 1:-1, :]) * self.inv_hz)
        dwz = (w[1:] - w[:-1]) * self.inv_hz
        dwx = (w_gx[:, :, 1:] - w_gx[:, :, :-1]) * self.inv_dfx
        dwy = (w_gy[:, 1:, :] - w_gy[:, :-1, :]) * self.inv_dfy
        lap_w = ((dwx[1:-1, :, 1:] - dwx[1:-1, :, :-1]) * self.inv_hx
                 + (dwy[1:-1, 1:, :] - dwy[1:-1, :-1, :]) * self.inv_hy
                 + (dwz[1:] - dwz[:-1]) * self.inv_dcz)
        return lap_u, lap_v, lap_w

    def _moving_body(self, u_star, v_star, w_star, t_s, strength):
        body = self.moving_body
        ub, vb, wb = body.velocity(t_s)
        if self.moving_scheme == "ghost":
            ctr = body.center(t_s)
            out = [moving_ghost_forcing_3d_nonuniform(
                f, *self.body.component(c.upper()), getattr(self, f"xs_{c}"),
                getattr(self, f"ys_{c}"), getattr(self, f"zs_{c}"), ctr, body.radius,
                1.5 * self.h_min, b, strength)
                for f, c, b in zip((u_star, v_star, w_star), "uvw", (ub, vb, wb))]
            (u_star, du), (v_star, dv), (w_star, dw) = out
        else:
            # the taper is the smallest spacing (the body stays in the refined region)
            m_u, m_v, m_w = moving_body_masks_3d(body, self.body.all(), self.h_min, t_s)
            du = (u_star - ub) * (strength * m_u)
            dv = (v_star - vb) * (strength * m_v)
            dw = (w_star - wb) * (strength * m_w)
            u_star, v_star, w_star = u_star - du, v_star - dv, w_star - dw
        return u_star, v_star, w_star, du, dv, dw

    def _stage(self, state, u, v, w, p_warm, t_s, dt):
        """One projected Euler stage (``models/mac3d.py``'s pattern on the
        stretched metrics); leaves u, v, w and p_warm as they were."""
        cfg = self.cfg
        set_normal = self.bcs.set_normal
        ghosts = self.bcs.ghosts(u, v, w)
        conv_u, conv_v, conv_w = self._advect(u, v, w, ghosts)
        if cfg.use_les:
            # the variable-ν flux form replaces the molecular fluxes entirely
            visc_u, visc_v, visc_w = diffuse_les_metric(
                u, v, w, ghosts, cfg.nu + self._nu_turb(u, v, w, ghosts),
                (self.inv_hx, self.inv_hy, self.inv_hz), (self.inv_dcx, self.inv_dcy, self.inv_dcz),
                (self.inv_dfx, self.inv_dfy, self.inv_dfz))
        else:
            lap_u, lap_v, lap_w = self._diffuse(u, v, w, ghosts)
            visc_u, visc_v, visc_w = cfg.nu * lap_u, cfg.nu * lap_v, cfg.nu * lap_w
        u_star, v_star, w_star = u.clone(), v.clone(), w.clone()
        u_star[:, :, 1:-1] += dt * (visc_u - conv_u)
        v_star[:, 1:-1, :] += dt * (visc_v - conv_v)
        w_star[1:-1] += dt * (visc_w - conv_w)
        if cfg.projection == "incremental":
            u_star[:, :, 1:-1] += -dt * (p_warm[:, :, 1:] - p_warm[:, :, :-1]) * self.inv_dcx
            v_star[:, 1:-1, :] += -dt * (p_warm[:, 1:, :] - p_warm[:, :-1, :]) * self.inv_dcy
            w_star[1:-1] += -dt * (p_warm[1:] - p_warm[:-1]) * self.inv_dcz
        u_star, v_star, w_star = set_normal(u_star, v_star, w_star)

        fx = fy = fz = self.zero
        if self.mask_u is not None:
            strength = ibm_ramp(state.step, self.ibm_ramp_steps)
            du_ibm = u_star * (strength * self.mask_u)
            dv_ibm = v_star * (strength * self.mask_v)
            dw_ibm = w_star * (strength * self.mask_w)
            u_star, v_star, w_star = u_star - du_ibm, v_star - dv_ibm, w_star - dw_ibm
            if cfg.compute_metrics:
                # the momentum sink weighted by the face control volumes
                fx = (du_ibm * self.cv_u).sum() / dt
                fy = (dv_ibm * self.cv_v).sum() / dt
                fz = (dw_ibm * self.cv_w).sum() / dt
        if self.ghost is not None:
            strength = ibm_ramp(state.step, self.ibm_ramp_steps)
            gu, gv, gw = self.ghost
            u_star, du_g = gu(u_star, strength)
            v_star, dv_g = gv(v_star, strength)
            w_star, dw_g = gw(w_star, strength)
            if cfg.compute_metrics:
                fx = (du_g * self.cv_u).sum() / dt
                fy = (dv_g * self.cv_v).sum() / dt
                fz = (dw_g * self.cv_w).sum() / dt
        if self.moving_body is not None:
            strength = ibm_ramp(state.step, self.ibm_ramp_steps)
            u_star, v_star, w_star, du_mb, dv_mb, dw_mb = self._moving_body(
                u_star, v_star, w_star, t_s, strength)
            if cfg.compute_metrics:
                fx = fx + (du_mb * self.cv_u).sum() / dt
                fy = fy + (dv_mb * self.cv_v).sum() / dt
                fz = fz + (dw_mb * self.cv_w).sum() / dt

        # the exact projection (finite-volume divergence / centre-gap gradient)
        div_star = self.divergence(u_star, v_star, w_star)
        phi = self.fdm(div_star / dt)
        u_star[:, :, 1:-1] += -dt * (phi[:, :, 1:] - phi[:, :, :-1]) * self.inv_dcx
        v_star[:, 1:-1, :] += -dt * (phi[:, 1:, :] - phi[:, :-1, :]) * self.inv_dcy
        w_star[1:-1] += -dt * (phi[1:] - phi[:-1]) * self.inv_dcz
        u_new, v_new, w_new = set_normal(u_star, v_star, w_star)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        w_new = w_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        if cfg.projection == "incremental":
            phi = p_warm + phi
        return u_new, v_new, w_new, phi, (fx, fy, fz, div_star)

    def forward(self, state: MAC3DState, cfl_scale):
        cfg = self.cfg
        h = self.h_min
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        bcs = self.bcs
        u, v, w = bcs.set_normal(state.u.clone(), state.v.clone(), state.w.clone())
        if cfg.adaptive_dt:
            vel_max = torch.maximum(torch.maximum(u.abs().amax(), v.abs().amax()),
                                    w.abs().amax().clamp(min=1e-10))
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            if cfg.use_les:
                nu_stab = cfg.nu + self._nu_turb(u, v, w, bcs.ghosts(u, v, w)).mean()
                dt = torch.minimum(dt_cfl, 0.125 * h * h / nu_stab)
            else:
                dt = dt_cfl.clamp(max=0.125 * h * h / cfg.nu)
            dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        u_new, v_new, w_new, phi, (fx, fy, fz, div_star) = self._stage(
            state, u, v, w, state.p, state.t, dt)
        if cfg.time_scheme == "rk2":
            # Heun: the average with a second projected stage
            u2, v2, w2, phi2, (fx2, fy2, fz2, div_star) = self._stage(
                state, u_new, v_new, w_new, phi, state.t + dt, dt)
            u_new, v_new, w_new = bcs.set_normal(0.5 * (u + u2), 0.5 * (v + v2), 0.5 * (w + w2))
            phi = 0.5 * (phi + phi2)
            fx, fy, fz = 0.5 * (fx + fx2), 0.5 * (fy + fy2), 0.5 * (fz + fz2)

        new_state = MAC3DState(u=u_new, v=v_new, w=w_new, p=phi, t=state.t + dt,
                               step=state.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_state, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                          zero)
        div_post = self.divergence(u_new, v_new, w_new)
        ucc = 0.5 * (u_new[:, :, :-1] + u_new[:, :, 1:])
        vcc = 0.5 * (v_new[:, :-1, :] + v_new[:, 1:, :])
        wcc = 0.5 * (w_new[:-1] + w_new[1:])
        dwdy = ((w_new[:, 1:, :] - w_new[:, :-1, :]) * self.inv_dcy)[1:-1]
        dvdz = ((v_new[1:] - v_new[:-1]) * self.inv_dcz)[:, 1:-1, :]
        return new_state, StepMetrics(
            dt=dt,
            div_pre=div_star.abs().amax(),
            div_post=div_post.abs().amax(),
            max_vel=torch.maximum(torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                                  w_new.abs().amax()),
            # the cell-volume-weighted mean kinetic energy
            energy=(self.cell_vol * 0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)).sum()
            / self.volume,
            vort_max=(dwdy - dvdz).abs().amax(),
            poisson_res=zero,  # FDM is exact (full-fp32 products)
            fx=fx,
            fy=fy,
            fz=fz,
        )


def make_step(cfg: StretchedMAC3DConfig, bcs: MAC3DBCs, x_faces, y_faces, z_faces,
              ibm_mask_u=None, ibm_mask_v=None, ibm_mask_w=None, ibm_ramp_steps: int = 0,
              moving_body=None, ibm_ghost=None, moving_scheme: str = "penalize", *,
              device) -> StretchedMAC3DStep:
    """Build the stretched 3D step module on ``device`` (see
    :class:`StretchedMAC3DStep`): ``ibm_mask_{u,v,w}`` face-sampled
    penalization masks (forces weighted by the staggered control volumes);
    ``ibm_ghost`` (``ibm_ghost.GhostIBM3D``) the ghost-cell IBM of a static
    body, mutually exclusive with the masks; ``moving_body``
    (``ibm.MovingBody3D``) by sharp masks with a taper of the smallest
    spacing or, with ``moving_scheme="ghost"``, by ghost stencils located on
    the device by ``searchsorted``."""
    return StretchedMAC3DStep(cfg, bcs, x_faces, y_faces, z_faces, ibm_mask_u, ibm_mask_v,
                              ibm_mask_w, ibm_ramp_steps, moving_body, ibm_ghost,
                              moving_scheme, device=device)
