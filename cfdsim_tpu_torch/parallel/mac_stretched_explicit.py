"""The stretched MAC step on rank blocks (``cfdsim_tpu.parallel.mac_stretched_explicit``).

The boundary-layer tier of ``models/mac_stretched.py`` on the trimmed
blocks and width-2 halos of ``parallel/mac_explicit.py`` (the same
masked-write BCs): every metric coefficient (cell widths, centre gaps,
donor distances, corner weights, control volumes) is this rank's slice of
the whole-grid vector at clamped global indices, built once on the host
when the step is built (the JAX package's ``_lut`` slices, which work
around a gather miscompile of its backend, are plain index reads here).
The projection is the distributed fast diagonalization
(``transforms.make_fdm_poisson_local``), exact across the mesh; rk2 (Heun,
one projection per stage, the second at t + dt) and the incremental
projection (p = p_warm + φ) follow ``models/mac_stretched.py``.

A moving body is forced as in ``mac_explicit.py`` with the stretched
tier's taper and probe distance (the smallest spacing, 1.5 times it); its
moving ghost locates the probe's cell by ``torch.searchsorted`` into the
whole float32 sample vectors, through windows of ``moving_ghost_halo``
lines.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac import MACState
from cfdsim_tpu_torch.models.mac_stretched import StretchedMACConfig, _metrics
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.parallel.explicit import check_divisible, step_device
from cfdsim_tpu_torch.parallel.halo import global_indices, halo_exchange_edges
from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import MovingBodyLocal, clamped_line
from cfdsim_tpu_torch.parallel.mac_explicit import (
    MAC2DBlockStep,
    MACLocalBCs,
    cavity_mac_local_bcs,
    external_flow_mac_local_bcs,
    free_slip_mac_local_bcs,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum
from cfdsim_tpu_torch.parallel.transforms import make_fdm_poisson_local


class StretchedMACExplicitStep(MAC2DBlockStep):
    """``step(tstate, cfl_scale[, mask_u_t, mask_v_t]) -> (tstate,
    StepMetrics)`` on this rank's trimmed blocks; see
    :func:`make_stretched_mac_explicit_step`."""

    def __init__(self, cfg: StretchedMACConfig, mesh: GridMesh, bcs: MACLocalBCs, x_faces,
                 y_faces, use_ibm: bool = False, ibm_ramp_steps: int = 0, moving_body=None,
                 moving_scheme: str = "penalize", moving_ghost_halo: int = 5, *, device=None):
        super().__init__()
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown projection {cfg.projection!r}")
        if cfg.scheme not in ("central", "upwind", "tvd"):
            raise ValueError(f"unknown scheme {cfg.scheme!r}")
        if moving_scheme not in ("penalize", "ghost"):
            raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
        mx, my = _metrics(x_faces), _metrics(y_faces)
        if len(mx.h) != cfg.nx or len(my.h) != cfg.ny:
            raise ValueError(f"faces for {len(my.h)}×{len(mx.h)} cells, config {cfg.ny}×{cfg.nx}")
        self.local_shape = check_divisible(cfg, mesh, min_block=4)
        self.cfg, self.mesh, self.bcs = cfg, mesh, bcs
        self.use_ibm, self.ibm_ramp_steps = use_ibm, ibm_ramp_steps
        self.device = step_device(mesh, device)
        self.reads_host = False
        self.collectives = True
        ny_l, nx_l = self.local_shape
        gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
        self.h_min = float(min(mx.h.min(), my.h.min()))
        self.volume = float(np.sum(my.h) * np.sum(mx.h))
        for w in (0, 1, 2):
            gr, gc = global_indices(self.local_shape, mesh, w)
            self.register_buffer(f"gr{w}", gr.contiguous())
            self.register_buffer(f"gc{w}", gc.contiguous())

        def line(name, vec, start, length, axis):
            """``vec`` at this rank's global indices start … (a row for
            axis 1, a column for axis 0), clamped at the grid's ends."""
            self.register_buffer(name, clamped_line(vec, start, length, axis, 2,
                                                    device=self.device))

        xf, yf = np.asarray(x_faces, np.float64), np.asarray(y_faces, np.float64)
        # the advection window (W = 2): U/V entry (r, c) ↔ global (gy0−2+r, gx0−2+c);
        # UC/DUX columns and VC/DVY rows are cell-aligned with the lower face,
        # UY rows and VX columns corner-aligned at offset −1
        line("hx_cells", 1.0 / mx.h, gx0 - 2, nx_l + 3, 1)
        line("hy_cells", 1.0 / my.h, gy0 - 2, ny_l + 3, 0)
        line("wy", np.concatenate([[0.5], my.wf, [0.5]]), gy0 - 1, ny_l + 3, 0)
        line("wx", np.concatenate([[0.5], mx.wf, [0.5]]), gx0 - 1, nx_l + 3, 1)
        line("gxu_lo", 1.0 / mx.h, gx0 - 2, nx_l + 2, 1)  # TVD divided differences
        line("gxu_hi", 1.0 / mx.h, gx0 - 1, nx_l + 2, 1)
        line("gyu_lo", 1.0 / my.dfull, gy0 - 1, ny_l + 2, 0)
        line("gyu_hi", 1.0 / my.dfull, gy0, ny_l + 2, 0)
        line("gyv_lo", 1.0 / my.h, gy0 - 2, ny_l + 2, 0)
        line("gyv_hi", 1.0 / my.h, gy0 - 1, ny_l + 2, 0)
        line("gxv_lo", 1.0 / mx.dfull, gx0 - 1, nx_l + 2, 1)
        line("gxv_hi", 1.0 / mx.dfull, gx0, nx_l + 2, 1)
        line("dxl_c", mx.xc - xf[:-1], gx0 - 2, nx_l + 3, 1)  # TVD donor distances
        line("dxr_c", xf[1:] - mx.xc, gx0 - 2, nx_l + 3, 1)
        line("dyl_c", my.xc - yf[:-1], gy0 - 2, ny_l + 3, 0)
        line("dyr_c", yf[1:] - my.xc, gy0 - 2, ny_l + 3, 0)
        ygd = np.concatenate([[my.xc[0] - my.h[0]], my.xc, [my.xc[-1] + my.h[-1]]])
        line("dyl_k", yf - ygd[:-1], gy0 - 1, ny_l + 3, 0)
        line("dyr_k", ygd[1:] - yf, gy0 - 1, ny_l + 3, 0)
        xgd = np.concatenate([[mx.xc[0] - mx.h[0]], mx.xc, [mx.xc[-1] + mx.h[-1]]])
        line("dxl_k", xf - xgd[:-1], gx0 - 1, nx_l + 3, 1)
        line("dxr_k", xgd[1:] - xf, gx0 - 1, nx_l + 3, 1)
        line("dfy_w", 1.0 / my.dfull, gy0 - 1, ny_l + 3, 0)  # the diffusion's gaps
        line("dfx_w", 1.0 / mx.dfull, gx0 - 1, nx_l + 3, 1)
        # the owned faces and cells
        line("dcx_f", 1.0 / mx.dc, gx0 - 1, nx_l, 1)  # centre gap across owned face i
        line("dcy_f", 1.0 / my.dc, gy0 - 1, ny_l, 0)
        line("hx_own", 1.0 / mx.h, gx0, nx_l, 1)
        line("hy_own", 1.0 / my.h, gy0, ny_l, 0)

        def block(name, a):
            """This rank's block of a whole-grid float64 table, float32."""
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(a[gy0:gy0 + ny_l, gx0:gx0 + nx_l]).astype(np.float32),
                device=self.device))

        # face control volumes (forces), cell volumes (energy): the
        # single-device step's float64 products, cut
        block("area_u", np.outer(my.h, mx.dfull))
        block("area_v", np.outer(my.dfull, mx.h))
        block("cell_w", np.outer(my.h, mx.h))
        self.solve_p = make_fdm_poisson_local(mx.h, my.h, mesh)
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=self.device))
        self.register_buffer("warmup_dt", torch.tensor(cfg.warmup_dt, dtype=torch.float32,
                                                       device=self.device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=self.device))
        self.moving = None
        if moving_body is not None:
            self.moving = MovingBodyLocal(
                moving_body, moving_scheme, ((xf, my.xc), (mx.xc, yf)), None, self.h_min,
                1.5 * self.h_min, int(moving_ghost_halo), mesh, self.local_shape,
                device=self.device)

    def _stage(self, ts, u_t, v_t, a, U, V, p_warm, dt, extras):
        """One projected Euler stage (``models/mac_stretched.py``'s
        ``_stage``) from BC-consistent trimmed (u, v) and their width-2
        padding (U, V), the BCs and the body at ``ts``'s time: (u_new,
        v_new, a, p, body sums, div*)."""
        cfg = self.cfg
        mesh = self.mesh
        ny, nx = cfg.ny, cfg.nx
        ny_l, nx_l = self.local_shape
        gr0, gc0 = self.gr0, self.gc0
        grP, gcP = self.gr2, self.gc2

        # --- advecting velocities with the metric corner weights
        UC = 0.5 * (U[:, :-1] + U[:, 1:])
        VC = 0.5 * (V[:-1, :] + V[1:, :])
        UY = (1.0 - self.wy) * U[:-1, :] + self.wy * U[1:, :]
        VX = (1.0 - self.wx) * V[:, :-1] + self.wx * V[:, 1:]
        UYc = UY[:, 1:]  # the corners (gy0−1+a, gx0−1+b)
        VXc = VX[1:, :]
        if cfg.scheme == "central":
            FU = UC * UC
            GU = VXc * UYc
            FV = UYc * VXc
            GV = VC * VC
        else:
            if cfg.scheme == "tvd":
                # limited gradients, zero on the single-device arrays' boundary
                # lines (by global index here)
                GXU = torch.where((gcP <= 0) | (gcP >= nx), 0.0, F.pad(vanleer_slope(
                    (U[:, 1:-1] - U[:, :-2]) * self.gxu_lo,
                    (U[:, 2:] - U[:, 1:-1]) * self.gxu_hi), (1, 1)))
                GYU = torch.where((grP <= -1) | (grP >= ny), 0.0, F.pad(vanleer_slope(
                    (U[1:-1, :] - U[:-2, :]) * self.gyu_lo,
                    (U[2:, :] - U[1:-1, :]) * self.gyu_hi), (0, 0, 1, 1)))
                GYV = torch.where((grP <= 0) | (grP >= ny), 0.0, F.pad(vanleer_slope(
                    (V[1:-1, :] - V[:-2, :]) * self.gyv_lo,
                    (V[2:, :] - V[1:-1, :]) * self.gyv_hi), (0, 0, 1, 1)))
                GXV = torch.where((gcP <= -1) | (gcP >= nx), 0.0, F.pad(vanleer_slope(
                    (V[:, 1:-1] - V[:, :-2]) * self.gxv_lo,
                    (V[:, 2:] - V[:, 1:-1]) * self.gxv_hi), (1, 1)))
            else:
                GXU = GYU = torch.zeros_like(U)
                GYV = GXV = torch.zeros_like(V)
            FU = UC * torch.where(UC >= 0.0, U[:, :-1] + GXU[:, :-1] * self.dxl_c,
                                  U[:, 1:] - GXU[:, 1:] * self.dxr_c)
            GU = VXc * torch.where(VXc >= 0.0, U[:-1, 1:] + GYU[:-1, 1:] * self.dyl_k,
                                   U[1:, 1:] - GYU[1:, 1:] * self.dyr_k)
            GV = VC * torch.where(VC >= 0.0, V[:-1, :] + GYV[:-1, :] * self.dyl_c,
                                  V[1:, :] - GYV[1:, :] * self.dyr_c)
            FV = UYc * torch.where(UYc >= 0.0, V[1:, :-1] + GXV[1:, :-1] * self.dxl_k,
                                   V[1:, 1:] - GXV[1:, 1:] * self.dxr_k)

        dcx_f, dcy_f, hx_own, hy_own = self.dcx_f, self.dcy_f, self.hx_own, self.hy_own
        # --- the flux divergences at the owned faces (index maps of mac_explicit)
        conv_u = (FU[2:2 + ny_l, 2:2 + nx_l] - FU[2:2 + ny_l, 1:1 + nx_l]) * dcx_f + (
            GU[2:2 + ny_l, 1:1 + nx_l] - GU[1:1 + ny_l, 1:1 + nx_l]) * hy_own
        conv_v = (FV[1:1 + ny_l, 2:2 + nx_l] - FV[1:1 + ny_l, 1:1 + nx_l]) * hx_own + (
            GV[2:2 + ny_l, 2:2 + nx_l] - GV[1:1 + ny_l, 2:2 + nx_l]) * dcy_f

        # --- flux-form diffusion (mac_stretched._diffuse)
        DUX = (U[:, 1:] - U[:, :-1]) * self.hx_cells  # at the centres
        lap_u = (DUX[2:2 + ny_l, 2:2 + nx_l] - DUX[2:2 + ny_l, 1:1 + nx_l]) * dcx_f
        DUY = (U[1:, :] - U[:-1, :]) * self.dfy_w  # at the y-faces
        lap_u = lap_u + (DUY[2:2 + ny_l, 2:2 + nx_l] - DUY[1:1 + ny_l, 2:2 + nx_l]) * hy_own
        DVY = (V[1:, :] - V[:-1, :]) * self.hy_cells
        lap_v_y = (DVY[2:2 + ny_l, 2:2 + nx_l] - DVY[1:1 + ny_l, 2:2 + nx_l]) * dcy_f
        DVX = (V[:, 1:] - V[:, :-1]) * self.dfx_w  # at the x-faces
        lap_v = (DVX[2:2 + ny_l, 2:2 + nx_l] - DVX[2:2 + ny_l, 1:1 + nx_l]) * hx_own + lap_v_y

        u_star = u_t + torch.where(gc0 >= 1, dt * (cfg.nu * lap_u - conv_u), 0.0)
        v_star = v_t + torch.where(gr0 >= 1, dt * (cfg.nu * lap_v - conv_v), 0.0)
        if cfg.projection == "incremental":
            # the lagged pressure gradient; the projection solves for the increment
            PW = halo_exchange_edges(p_warm, mesh, 1)
            u_star = u_star + torch.where(
                gc0 >= 1, -dt * (PW[1:-1, 1:-1] - PW[1:-1, :-2]) * dcx_f, 0.0)
            v_star = v_star + torch.where(
                gr0 >= 1, -dt * (PW[1:-1, 1:-1] - PW[:-2, 1:-1]) * dcy_f, 0.0)
        u_star, v_star, a = self._set_normal(u_star, v_star, ts)

        # --- the bodies; their momentum sinks weighted by the face control volumes
        sums = []
        if self.use_ibm:
            mask_u_t, mask_v_t = extras
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            du_ibm = u_star * (strength * mask_u_t)
            dv_ibm = v_star * (strength * mask_v_t)
            u_star = u_star - du_ibm
            v_star = v_star - dv_ibm
            sums += [(du_ibm * self.area_u).sum(), (dv_ibm * self.area_v).sum()]
        if self.moving is not None:
            (u_star, v_star), (du_mb, dv_mb) = self.moving(
                (u_star, v_star), ts.t, ibm_ramp(ts.step, self.ibm_ramp_steps))
            sums += [(du_mb * self.area_u).sum(), (dv_mb * self.area_v).sum()]

        # --- the exact distributed FDM projection
        US, VS, _ = self._pad(u_star, v_star, a, 1, ts)
        div_star = (US[1:-1, 2:] - US[1:-1, 1:-1]) * hx_own + (
            VS[2:, 1:-1] - VS[1:-1, 1:-1]) * hy_own
        phi = self.solve_p(div_star / dt)
        PH = halo_exchange_edges(phi, mesh, 1)  # read by 5-point stencils only
        u_new = u_star - torch.where(gc0 >= 1, dt * (PH[1:-1, 1:-1] - PH[1:-1, :-2]) * dcx_f,
                                     0.0)
        v_new = v_star - torch.where(gr0 >= 1, dt * (PH[1:-1, 1:-1] - PH[:-2, 1:-1]) * dcy_f,
                                     0.0)
        u_new, v_new, a = self._set_normal(u_new, v_new, ts)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        p_out = p_warm + phi if cfg.projection == "incremental" else phi
        return u_new, v_new, a, p_out, sums, div_star

    def _restage(self, ts, fields, a, p_warm, dt, extras):
        U, V, _ = self._pad(*fields, a, 2, ts)
        u, v, _, p, sums, div_star = self._stage(ts, *fields, a, U, V, p_warm, dt, extras)
        return (u, v), p, sums, div_star


    def forward(self, tstate: MACState, cfl_scale, *extras):
        cfg = self.cfg
        mesh = self.mesh
        ny, nx = cfg.ny, cfg.nx
        if tstate.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {tstate.u.device}")
        if len(extras) != (2 if self.use_ibm else 0):
            raise ValueError(f"the step takes {2 if self.use_ibm else 0} extra blocks, got "
                             f"{len(extras)}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        gr0, gc0 = self.gr0, self.gc0
        dcx_f, dcy_f, hx_own, hy_own = self.dcx_f, self.dcy_f, self.hx_own, self.hy_own

        u_t, v_t, a = self._set_normal(tstate.u, tstate.v, tstate)
        U, V, (grP, gcP) = self._pad(u_t, v_t, a, 2, tstate)

        # --- adaptive dt (mac_stretched._adaptive_dt)
        h = self.h_min
        if cfg.adaptive_dt:
            real_u = (grP >= 0) & (grP < ny) & (gcP >= 0) & (gcP <= nx)
            real_v = (grP >= 0) & (grP <= ny) & (gcP >= 0) & (gcP < nx)
            vel_max = pmax(torch.maximum(torch.where(real_u, U.abs(), 0.0).amax(),
                                         torch.where(real_v, V.abs(), 0.0).amax()),
                           mesh).clamp(min=1e-10)
            dt = cfg.cfl_target * cfl_scale * h / vel_max
            dt = dt.clamp(max=0.2 * h * h / cfg.nu).clamp(cfg.dt_min, cfg.dt_max)
            if cfg.warmup_steps > 0:
                dt = torch.where(tstate.step < cfg.warmup_steps, self.warmup_dt, dt)
        else:
            dt = self.dt_base

        u_new, v_new, a, phi, sums, div_star = self._stage(tstate, u_t, v_t, a, U, V, tstate.p,
                                                           dt, extras)
        if cfg.time_scheme == "rk2":
            (u_new, v_new), a, phi, sums, div_star = self._heun(
                tstate, dt, (u_t, v_t), ((u_new, v_new), phi, sums), extras)

        new_tstate = MACState(u=u_new, v=v_new, p=phi, t=tstate.t + dt, step=tstate.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_tstate, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                           zero)
        UN, VN, (grn, gcn) = self._pad(u_new, v_new, a, 1, tstate)
        div_post = (UN[1:-1, 2:] - UN[1:-1, 1:-1]) * hx_own + (
            VN[2:, 1:-1] - VN[1:-1, 1:-1]) * hy_own
        ucc = 0.5 * (UN[1:-1, 1:-1] + UN[1:-1, 2:])
        vcc = 0.5 * (VN[1:-1, 1:-1] + VN[2:, 1:-1])
        dvdx = (VN[1:-1, 1:-1] - VN[1:-1, :-2]) * dcx_f
        dudy = (UN[1:-1, 1:-1] - UN[:-2, 1:-1]) * dcy_f
        vort = torch.where((gr0 >= 1) & (gc0 >= 1), dvdx - dudy, 0.0)
        real_un = (grn >= 0) & (grn < ny) & (gcn >= 0) & (gcn <= nx)
        real_vn = (grn >= 0) & (grn <= ny) & (gcn >= 0) & (gcn < nx)
        div_pre, div_post_m, max_vel, vort_max = pmax(torch.stack([
            div_star.abs().amax(),
            div_post.abs().amax(),
            torch.maximum(torch.where(real_un, UN.abs(), 0.0).amax(),
                          torch.where(real_vn, VN.abs(), 0.0).amax()),
            vort.abs().amax(),
        ]), mesh).unbind(0)
        totals = psum(torch.stack([(self.cell_w * 0.5 * (ucc * ucc + vcc * vcc)).sum(), *sums]),
                      mesh)
        fx = fy = zero
        for k in range(1, len(sums), 2):
            fx = fx + totals[k] / dt
            fy = fy + totals[k + 1] / dt
        return new_tstate, StepMetrics(
            dt=dt, div_pre=div_pre, div_post=div_post_m, max_vel=max_vel,
            energy=totals[0] / self.volume, vort_max=vort_max,
            poisson_res=zero,  # the FDM solve is exact
            fx=fx, fy=fy, fz=zero)


def make_stretched_mac_explicit_step(cfg: StretchedMACConfig, mesh: GridMesh, bcs: MACLocalBCs,
                                     x_faces, y_faces, use_ibm: bool = False,
                                     ibm_ramp_steps: int = 0, moving_body=None,
                                     moving_scheme: str = "penalize",
                                     moving_ghost_halo: int = 5, *,
                                     device=None) -> StretchedMACExplicitStep:
    """Build the explicit-communication stretched MAC step on the trimmed
    blocks: ``step(tstate, cfl_scale[, mask_u_t, mask_v_t])``. The optional
    masks are this rank's blocks of ``mac_explicit.trim_face_masks``, the
    body force weighted by the face control volumes. ``moving_body`` is
    forced by sharp masks (a taper of the smallest spacing) or, with
    ``moving_scheme="ghost"``, by the moving ghost through windows of
    ``moving_ghost_halo`` lines (5 covers δ = 1.5·h_min for a body in the
    refined region)."""
    return StretchedMACExplicitStep(cfg, mesh, bcs, x_faces, y_faces, use_ibm, ibm_ramp_steps,
                                    moving_body, moving_scheme, moving_ghost_halo, device=device)


def make_cavity_stretched_explicit_step(cfg: StretchedMACConfig, mesh: GridMesh, x_faces,
                                        y_faces, lid_velocity: float = 1.0, *,
                                        device=None) -> StretchedMACExplicitStep:
    """The explicit-communication stretched step of the wall-clustered cavity."""
    return make_stretched_mac_explicit_step(
        cfg, mesh, cavity_mac_local_bcs(cfg.ny, cfg.nx, lid_velocity), x_faces, y_faces,
        device=device)


def make_cylinder_stretched_explicit_step(cfg: StretchedMACConfig, mesh: GridMesh, x_faces,
                                          y_faces, v_inf: float = 1.0, perturb_amp: float = 0.01,
                                          perturb_ramp_steps: int = 1000,
                                          ibm_ramp_steps: int = 0, *,
                                          device=None) -> StretchedMACExplicitStep:
    """The explicit-communication stretched step of the body- and
    wake-refined cylinder: ``step(tstate, cfl_scale, mask_u_t, mask_v_t)``
    with this rank's blocks of ``mac_explicit.trim_face_masks``."""
    my = _metrics(y_faces)
    yf = np.asarray(y_faces, np.float64)
    bcs = external_flow_mac_local_bcs(cfg.ny, cfg.nx, dy=0.0, y_min=float(yf[0]),
                                      y_max=float(yf[-1]), v_inf=v_inf, perturb_amp=perturb_amp,
                                      perturb_ramp_steps=perturb_ramp_steps, y_centers=my.xc,
                                      mesh=mesh)
    return make_stretched_mac_explicit_step(cfg, mesh, bcs, x_faces, y_faces, use_ibm=True,
                                            ibm_ramp_steps=ibm_ramp_steps, device=device)


def make_moving_body_stretched_explicit_step(cfg: StretchedMACConfig, mesh: GridMesh, x_faces,
                                             y_faces, moving_body, ibm_ramp_steps: int = 0,
                                             moving_scheme: str = "penalize", *,
                                             device=None) -> StretchedMACExplicitStep:
    """The explicit-communication stretched step of a moving body in a
    quiescent free-slip box, the distributed twin of
    ``cylinder_oscillating(stretched=True)``: ``step(tstate, cfl_scale)``."""
    return make_stretched_mac_explicit_step(
        cfg, mesh, free_slip_mac_local_bcs(cfg.ny, cfg.nx), x_faces, y_faces,
        moving_body=moving_body, ibm_ramp_steps=ibm_ramp_steps, moving_scheme=moving_scheme,
        device=device)
