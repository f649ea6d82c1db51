"""The stretched 3D MAC step on rank blocks
(``cfdsim_tpu.parallel.mac_stretched3d_explicit``).

The layout of ``parallel/mac3d_explicit.py`` (the trimmed state, z local,
y and x halos, the masked-write BCs of ``MAC3DLocalBCs``) with the metrics
of ``models/mac_stretched3d.py``: every y and x coefficient is this rank's
slice of the whole-grid vector at clamped global indices, the z lines are
local, and the control volumes, cell volumes and LES filter widths are the
single-device step's float64 products cut to this rank's block. The
projection is the distributed 3D fast diagonalization
(``transforms.make_fdm_poisson3d_local``); rk2 (Heun, one projection per
stage, the body's second stage at t + dt) and the incremental projection
(p = p_warm + φ) follow ``models/mac_stretched3d.py``.

The central scheme runs on width-1 padded blocks. Upwind and TVD (the
sphere cases' default) run the single-device step's MUSCL donor fluxes on
the width-2 windows of the uniform tier (``mac3d_explicit.py``), with this
rank's window lines of the metric gaps, donor distances and interpolation
weights, the van Leer slopes zeroed on the global boundary lines that run
through a window (the single-device slopes end there), and crop to the
owned faces. The JAX package's explicit stretched step is central only.

LES (static Smagorinsky or dynamic Germano–Lilly) evaluates ν_t on the
width-2 windows of the uniform tier with window lines of the metrics and
feeds the flux-form variable-ν diffusion (``mac3d.diffuse_les_metric``) on
the window, cropped to the owned faces; the dynamic coefficient is
``mac3d_explicit.dynamic_cs2_local`` on the stretched gaps and Δ². A moving
body is penalized (the JAX package offers no moving ghost on this tier).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac3d import MAC3DState, diffuse_les_metric
from cfdsim_tpu_torch.models.mac_stretched import _metrics
from cfdsim_tpu_torch.models.mac_stretched3d import (
    StretchedMAC3DConfig,
    smagorinsky_viscosity_stretched3d,
)
from cfdsim_tpu_torch.ops.les_dynamic import ibm_fluid_mask_centers
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.parallel.explicit import check_divisible, step_device
from cfdsim_tpu_torch.parallel.halo import halo_exchange, halo_exchange_edges
from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import (
    MovingBodyLocal,
    apply_ghost_forcing_stack,
    clamped_line,
)
from cfdsim_tpu_torch.parallel.mac3d_explicit import (
    BoxIndices,
    MAC3DBlockStep,
    MAC3DLocalBCs,
    _roll_writes,
    cavity3d_local_bcs,
    check_dynamic_les,
    dynamic_cs2_local,
    dynamic_include,
    external_flow3d_local_bcs,
    fluid_from_masks_local,
    free_slip3d_local_bcs,
    ghost_tables,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum
from cfdsim_tpu_torch.parallel.transforms import make_fdm_poisson3d_local


class Stretched3DExplicitStep(MAC3DBlockStep):
    """``step(tstate, cfl_scale[, mask_u_t, mask_v_t, mask_w_t]) -> (tstate,
    StepMetrics)`` on this rank's trimmed blocks; see
    :func:`make_stretched3d_explicit_step`."""

    def __init__(self, cfg: StretchedMAC3DConfig, mesh: GridMesh, x_faces, y_faces, z_faces,
                 bcs: MAC3DLocalBCs, use_ibm: bool = False, ibm_ramp_steps: int = 0,
                 moving_body=None, ibm_ghost=None, *, device=None):
        super().__init__()
        if ibm_ghost is not None and use_ibm:
            raise ValueError("ghost_halo and use_ibm are mutually exclusive")
        if cfg.scheme not in ("central", "upwind", "tvd"):
            raise ValueError(f"unknown scheme {cfg.scheme!r}")
        if cfg.les_model not in ("smagorinsky", "dynamic"):
            raise ValueError(f"unknown les_model {cfg.les_model!r}")
        self.dynamic = cfg.use_les and cfg.les_model == "dynamic"
        if self.dynamic and moving_body is not None:
            raise ValueError("les_model='dynamic' does not support moving_body yet "
                             "(matches models/mac_stretched3d.py)")
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown projection {cfg.projection!r}")
        mx, my, mz = _metrics(x_faces), _metrics(y_faces), _metrics(z_faces)
        if (len(mx.h), len(my.h), len(mz.h)) != (cfg.nx, cfg.ny, cfg.nz):
            raise ValueError(f"faces for {len(mz.h)}×{len(my.h)}×{len(mx.h)} cells, config "
                             f"{cfg.nz}×{cfg.ny}×{cfg.nx}")
        nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
        self.local_shape = check_divisible(cfg, mesh, min_block=2)
        if self.dynamic:
            check_dynamic_les((nz, ny, nx), self.local_shape)
        self.cfg, self.mesh, self.bcs = cfg, mesh, bcs
        self.use_ibm, self.ibm_ramp_steps = use_ibm, ibm_ramp_steps
        self.device = step_device(mesh, device)
        self.reads_host = False
        self.collectives = True
        self.n_global = float(nx * ny * nz)
        self.idx = BoxIndices(self.local_shape, mesh)
        ny_l, nx_l = self.local_shape
        gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
        dev = self.device
        self.h_min = float(min(mx.h.min(), my.h.min(), mz.h.min()))
        self.volume = float(np.sum(mx.h) * np.sum(my.h) * np.sum(mz.h))
        self.solve_p = make_fdm_poisson3d_local(mx.h, my.h, mz.h, mesh)

        def line(name, vec, start, length, axis):
            """``vec`` at this rank's global indices along y (axis 1) or x (2)."""
            self.register_buffer(name, clamped_line(vec, start, length, axis, 3, device=dev))

        def zline(name, vec):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(vec, np.float64).astype(np.float32)[:, None, None], device=dev))

        wfx = np.concatenate([[0.5], mx.wf, [0.5]])
        wfy = np.concatenate([[0.5], my.wf, [0.5]])
        line("wy", wfy, gy0, ny_l + 1, 1)  # corner rows gy0 … gy0+ny_l
        line("wx", wfx, gx0, nx_l + 1, 2)
        line("dcx_f", 1.0 / mx.dc, gx0 - 1, nx_l, 2)  # centre gap across owned face i
        line("dcy_f", 1.0 / my.dc, gy0 - 1, ny_l, 1)
        line("hx_own", 1.0 / mx.h, gx0, nx_l, 2)
        line("hy_own", 1.0 / my.h, gy0, ny_l, 1)
        line("hx_m1", 1.0 / mx.h, gx0 - 1, nx_l + 1, 2)  # the diffusion's gaps
        line("hy_m1", 1.0 / my.h, gy0 - 1, ny_l + 1, 1)
        line("dfx_0", 1.0 / mx.dfull, gx0, nx_l + 1, 2)
        line("dfy_0", 1.0 / my.dfull, gy0, ny_l + 1, 1)
        zline("inv_hz", 1.0 / mz.h)
        zline("inv_dcz", 1.0 / mz.dc)
        zline("inv_dfz", 1.0 / mz.dfull)
        zline("wcz", np.concatenate([[0.5], mz.wf, [0.5]]))

        def block(name, a):
            """This rank's block of a whole-grid float64 (nz', ny, nx) table."""
            self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(
                a[:nz, gy0:gy0 + ny_l, gx0:gx0 + nx_l]).astype(np.float32), device=dev))

        hz, hy, hx = mz.h[:, None, None], my.h[None, :, None], mx.h[None, None, :]
        block("cell_vol", hz * hy * hx)
        # the staggered control volumes of the body force
        block("cv_u", hz * hy * mx.dfull[None, None, :])
        block("cv_v", hz * my.dfull[None, :, None] * hx)
        block("cv_w", mz.dfull[:, None, None] * hy * hx)
        if cfg.scheme != "central":
            # the window lines of the donor fluxes: window sample k along y
            # (x) is the single-device sample gy0 − 2 + k (gx0 − 2 + k) of
            # every array the fluxes read, faces, centres and ghost-extended
            # centres alike
            xf, yf, zf = (np.asarray(a, np.float64) for a in (x_faces, y_faces, z_faces))
            wn_y, wn_x = ny_l + 4, nx_l + 4
            for m, f, a, start, wn, ax in ((mx, xf, "x", gx0 - 2, wn_x, 2),
                                          (my, yf, "y", gy0 - 2, wn_y, 1)):
                gd = np.concatenate([[m.xc[0] - m.h[0]], m.xc, [m.xc[-1] + m.h[-1]]])
                line(f"w_inv_h{a}", 1.0 / m.h, start, wn, ax)
                line(f"w_inv_df{a}", 1.0 / m.dfull, start, wn + 1, ax)
                line(f"w_d{a}l_c", m.xc - f[:-1], start, wn, ax)
                line(f"w_d{a}r_c", f[1:] - m.xc, start, wn, ax)
                line(f"w_d{a}l_f", f - gd[:-1], start, wn + 1, ax)
                line(f"w_d{a}r_f", gd[1:] - f, start, wn + 1, ax)
                line(f"w_wf{a}", np.concatenate([[0.5], m.wf, [0.5]]), start, wn + 1, ax)
            gdz = np.concatenate([[mz.xc[0] - mz.h[0]], mz.xc, [mz.xc[-1] + mz.h[-1]]])
            zline("dzl_c", mz.xc - zf[:-1])
            zline("dzr_c", zf[1:] - mz.xc)
            zline("dzl_f", zf - gdz[:-1])
            zline("dzr_f", gdz[1:] - zf)
        if cfg.use_les:
            # the ±2-centre window's metric lines and Δ² (the single-device
            # float64 (hx hy hz)^{2/3} at clamped indices)
            line("hx_w", 1.0 / mx.h, gx0 - 2, nx_l + 4, 2)
            line("hy_w", 1.0 / my.h, gy0 - 2, ny_l + 4, 1)
            line("dfx_w", 1.0 / mx.dfull, gx0 - 2, nx_l + 5, 2)
            line("dfy_w", 1.0 / my.dfull, gy0 - 2, ny_l + 5, 1)
            line("dcx_w", 1.0 / mx.dc, gx0 - 2, nx_l + 3, 2)
            line("dcy_w", 1.0 / my.dc, gy0 - 2, ny_l + 3, 1)
            iy = np.clip(gy0 - 2 + np.arange(ny_l + 4), 0, ny - 1)
            ix = np.clip(gx0 - 2 + np.arange(nx_l + 4), 0, nx - 1)
            d2 = (hz * my.h[iy][None, :, None] * mx.h[ix][None, None, :]) ** (2.0 / 3.0)
            self.register_buffer("delta2_w", torch.as_tensor(d2.astype(np.float32), device=dev))
            if self.dynamic:

                def g2(xc):
                    xg = np.concatenate([[xc[0]], xc, [xc[-1]]])
                    return 1.0 / (xg[2:] - xg[:-2])

                line("g2x_w", g2(mx.xc), gx0 - 2, nx_l + 4, 2)
                line("g2y_w", g2(my.xc), gy0 - 2, ny_l + 4, 1)
                zline("g2z", g2(mz.xc))
            else:
                self.register_buffer("cs2_delta2", cfg.smagorinsky_constant ** 2 * self.delta2_w)
        self.ghost, self.ghost_width = None, None
        if ibm_ghost is not None:
            self.ghost, self.ghost_width = ghost_tables(ibm_ghost, nx, ny, nz, mesh, dev)
        self.register_buffer("les_include", dynamic_include(nz, ny, nx, self.idx)
                             if self.dynamic else None)
        fluid = None
        if self.dynamic and ibm_ghost is not None:
            fluid = ibm_fluid_mask_centers(ibm_ghost=ibm_ghost)[
                :, gy0:gy0 + ny_l, gx0:gx0 + nx_l].to(dev)
        self.register_buffer("les_fluid", fluid)
        self.moving = None
        if moving_body is not None:  # penalized, a taper of the smallest spacing
            xf, yf, zf = (np.asarray(a, np.float64) for a in (x_faces, y_faces, z_faces))
            self.moving = MovingBodyLocal(
                moving_body, "penalize", ((xf, my.xc, mz.xc), (mx.xc, yf, mz.xc),
                                          (mx.xc, my.xc, zf)), None, self.h_min, None, None,
                mesh, (nz, ny_l, nx_l), device=dev)
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=dev))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=dev))

    def _windows(self, u_t, v_t, w_t, a, ts):
        """The width-2 windows in the single-device layout (u (nz, NY,
        NX+1), v (nz, NY+1, NX), w (nz+1, NY, NX), NY = ny_l+4, NX = nx_l+4)
        and their ghost extensions; the zero lines appended feed only cropped
        positions or slopes that the fix zeroes."""
        idx = self.idx
        bcs = self.bcs
        U2, V2, W2 = halo_exchange(torch.stack([u_t, v_t, w_t]), self.mesh, 2).unbind(0)
        U2, V2, W2 = bcs.win(U2, V2, W2, idx.r2, idx.c2, ts, a)
        u_win = torch.cat([U2, torch.zeros_like(U2[:, :, :1])], 2)
        v_win = torch.cat([V2, torch.zeros_like(V2[:, :1, :])], 1)
        w_win = torch.cat([W2, torch.zeros_like(W2[:1])], 0)

        def zpad(q, axis):
            z = torch.zeros_like(q.narrow(axis, 0, 1))
            return torch.cat([z, q, z], axis)

        ghosts = (zpad(u_win, 1), bcs.zghost_u(u_win), zpad(v_win, 2), bcs.zghost_v(v_win),
                  zpad(w_win, 2), zpad(w_win, 1))
        return u_win, v_win, w_win, ghosts

    def _slope_fix(self, s, axis: int, first: int, ends):
        """Zero the slopes of a window sample array along ``axis`` (1 y, 2 x)
        whose sample k is global line ``first`` + k, on the global boundary
        lines ``ends``."""
        shape = [1, 1, 1]
        shape[axis] = s.shape[axis]
        i = first + torch.arange(s.shape[axis], device=s.device).reshape(shape)
        return torch.where((i == ends[0]) | (i == ends[1]), 0.0, s)

    def _muscl(self, q, inv_sp, d_lo, d_hi, axis: int, tvd: bool, fix=None):
        """``models/mac_stretched3d._muscl_axis`` on a window: the slopes,
        zero at the window's ends, also zeroed by ``fix`` = (first, ends) on
        the global boundary lines inside it."""
        n = q.shape[axis]
        lo, hi = q.narrow(axis, 0, n - 1), q.narrow(axis, 1, n - 1)
        if not tvd:
            return lo, hi
        dq = (hi - lo) * inv_sp
        m = dq.shape[axis]
        g = vanleer_slope(dq.narrow(axis, 0, m - 1), dq.narrow(axis, 1, m - 1))
        pads = [0] * 6
        pads[2 * (2 - axis)] = pads[2 * (2 - axis) + 1] = 1
        g = F.pad(g, pads)
        if fix is not None:
            g = self._slope_fix(g, axis, *fix)
        return lo + g.narrow(axis, 0, n - 1) * d_lo, hi - g.narrow(axis, 1, n - 1) * d_hi

    def _advect_donor(self, u_win, v_win, w_win, ghosts):
        """Upwind or TVD conservative advection (the single-device step's
        donor fluxes) on the windows, cropped to the owned faces: (conv_u,
        conv_v, conv_w), conv_w with a dummy z-face 0 as the central path
        returns it."""
        ny, nx = self.cfg.ny, self.cfg.nx
        ny_l, nx_l = self.local_shape
        gy0, gx0 = self.mesh.iy * ny_l, self.mesh.ix * nx_l
        tvd = self.cfg.scheme == "tvd"
        u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
        wfx, wfy, wfz = self.w_wfx, self.w_wfy, self.wcz
        u_y = (1.0 - wfy) * u_gy[:, :-1, :] + wfy * u_gy[:, 1:, :]
        v_x = (1.0 - wfx) * v_gx[:, :, :-1] + wfx * v_gx[:, :, 1:]
        u_z = (1.0 - wfz) * u_gz[:-1] + wfz * u_gz[1:]
        w_x = (1.0 - wfx) * w_gx[:, :, :-1] + wfx * w_gx[:, :, 1:]
        v_z = (1.0 - wfz) * v_gz[:-1] + wfz * v_gz[1:]
        w_y = (1.0 - wfy) * w_gy[:, :-1, :] + wfy * w_gy[:, 1:, :]
        uc = 0.5 * (u_win[:, :, :-1] + u_win[:, :, 1:])
        vc = 0.5 * (v_win[:, :-1, :] + v_win[:, 1:, :])
        wc = 0.5 * (w_win[:-1] + w_win[1:])
        # the global boundary lines of each sample array: its first window
        # sample's global line, and the two end samples of the single-device
        # array (faces 0, n; ghost centres −1, n)
        faces_x, cells_x = (gx0 - 2, (0, nx)), (gx0 - 3, (-1, nx))
        faces_y, cells_y = (gy0 - 2, (0, ny)), (gy0 - 3, (-1, ny))

        def flux(adv, q, inv_sp, d_lo, d_hi, axis, fix=None):
            lo, hi = self._muscl(q, inv_sp, d_lo, d_hi, axis, tvd, fix)
            return adv * torch.where(adv >= 0.0, lo, hi)

        F_u = flux(uc, u_win, self.w_inv_hx, self.w_dxl_c, self.w_dxr_c, 2, faces_x)
        G_u = flux(v_x, u_gy, self.w_inv_dfy, self.w_dyl_f, self.w_dyr_f, 1, cells_y)
        H_u = flux(w_x, u_gz, self.inv_dfz, self.dzl_f, self.dzr_f, 0)
        F_v = flux(u_y, v_gx, self.w_inv_dfx, self.w_dxl_f, self.w_dxr_f, 2, cells_x)
        G_v = flux(vc, v_win, self.w_inv_hy, self.w_dyl_c, self.w_dyr_c, 1, faces_y)
        H_v = flux(w_y, v_gz, self.inv_dfz, self.dzl_f, self.dzr_f, 0)
        F_w = flux(u_z, w_gx, self.w_inv_dfx, self.w_dxl_f, self.w_dxr_f, 2, cells_x)
        G_w = flux(v_z, w_gy, self.w_inv_dfy, self.w_dyl_f, self.w_dyr_f, 1, cells_y)
        H_w = flux(wc, w_win, self.inv_hz, self.dzl_c, self.dzr_c, 0)
        # owned crops: u rows are window centres (2 …), columns the x-faces
        # gx0 + i; v rows the y-faces gy0 + j; w every interior z-face
        conv_u = ((F_u[:, 2:2 + ny_l, 2:2 + nx_l] - F_u[:, 2:2 + ny_l, 1:1 + nx_l]) * self.dcx_f
                  + (G_u[:, 3:3 + ny_l, 2:2 + nx_l] - G_u[:, 2:2 + ny_l, 2:2 + nx_l])
                  * self.hy_own
                  + (H_u[1:, 2:2 + ny_l, 2:2 + nx_l] - H_u[:-1, 2:2 + ny_l, 2:2 + nx_l])
                  * self.inv_hz)
        conv_v = ((F_v[:, 2:2 + ny_l, 3:3 + nx_l] - F_v[:, 2:2 + ny_l, 2:2 + nx_l]) * self.hx_own
                  + (G_v[:, 2:2 + ny_l, 2:2 + nx_l] - G_v[:, 1:1 + ny_l, 2:2 + nx_l])
                  * self.dcy_f
                  + (H_v[1:, 2:2 + ny_l, 2:2 + nx_l] - H_v[:-1, 2:2 + ny_l, 2:2 + nx_l])
                  * self.inv_hz)
        conv_w = ((F_w[1:-1, 2:2 + ny_l, 3:3 + nx_l] - F_w[1:-1, 2:2 + ny_l, 2:2 + nx_l])
                  * self.hx_own
                  + (G_w[1:-1, 3:3 + ny_l, 2:2 + nx_l] - G_w[1:-1, 2:2 + ny_l, 2:2 + nx_l])
                  * self.hy_own
                  + (H_w[1:, 2:2 + ny_l, 2:2 + nx_l] - H_w[:-1, 2:2 + ny_l, 2:2 + nx_l])
                  * self.inv_dcz)
        return conv_u, conv_v, torch.cat([torch.zeros_like(conv_w[:1]), conv_w], 0)

    def _nu_t(self, windows, extras, u_t, v_t, w_t):
        """ν_t on the ±2-centre window (nz, ny_l+4, nx_l+4) of ``windows``
        (:meth:`_windows`)."""
        cfg = self.cfg
        mesh = self.mesh
        idx = self.idx
        ny, nx = cfg.ny, cfg.nx
        u_win, v_win, w_win, ghosts = windows
        metrics = (self.hx_w, self.hy_w, self.inv_hz, self.dfx_w, self.dfy_w, self.inv_dfz)
        if self.dynamic:
            fluid = self.les_fluid
            if self.use_ibm:
                fluid = fluid_from_masks_local(*extras, mesh)
            cs2 = dynamic_cs2_local(u_t, v_t, w_t, mesh, self.les_include, self.g2x_w,
                                    self.g2y_w, self.g2z, self.delta2_w, fluid)
            NUT = cs2 * smagorinsky_viscosity_stretched3d(u_win, v_win, w_win, ghosts, *metrics,
                                                          self.delta2_w)
        else:
            NUT = smagorinsky_viscosity_stretched3d(u_win, v_win, w_win, ghosts, *metrics,
                                                    self.cs2_delta2)
        return _roll_writes(NUT, idx.r2, idx.c2, ny, nx, 1.0, 1.0)  # the global edge clamp

    def _pad(self, u_t, v_t, w_t, a, corners: bool, ts):
        exchange = halo_exchange if corners else halo_exchange_edges
        U, V, W = exchange(torch.stack([u_t, v_t, w_t]), self.mesh, 1).unbind(0)
        return self.bcs.pad_writes(U, V, torch.cat([W, torch.zeros_like(W[:1])], 0),
                                   self.idx.rp, self.idx.cp, ts, a)

    def _inputs(self, u_t, v_t, w_t, a, ts, extras):
        """What a stage reads of BC-consistent trimmed (u, v, w): the width-1
        padded blocks with corners (the edge interpolants read them), their z
        ghosts, the width-2 windows where the donor fluxes or the LES read
        them, and ν_t."""
        cfg = self.cfg
        U, V, Wz = self._pad(u_t, v_t, w_t, a, True, ts)
        windows = NUT = None
        if cfg.use_les or cfg.scheme != "central":
            windows = self._windows(u_t, v_t, w_t, a, ts)
        if cfg.use_les:
            NUT = self._nu_t(windows, extras, u_t, v_t, w_t)
        return U, V, Wz, self.bcs.zghost_u(U), self.bcs.zghost_v(V), windows, NUT

    def _stage(self, ts, u_t, v_t, w_t, a, inputs, p_warm, dt, extras):
        """One projected Euler stage (``models/mac_stretched3d.py``'s) from
        BC-consistent trimmed (u, v, w) and :meth:`_inputs`, the body at
        ``ts``'s time: (u_new, v_new, w_new, a, p, body sums, div*)."""
        cfg = self.cfg
        mesh = self.mesh
        nz = cfg.nz
        ny_l, nx_l = self.local_shape
        ro, co = self.idx.ro, self.idx.co
        U, V, Wz, UZG, VZG, windows, NUT = inputs
        if cfg.use_les:
            u_win, v_win, w_win, ghosts = windows

        # --- the edge interpolants with the metric corner weights
        wy, wx, wcz = self.wy, self.wx, self.wcz
        dcx_f, dcy_f, hx_own, hy_own = self.dcx_f, self.dcy_f, self.hx_own, self.hy_own
        inv_hz, inv_dcz, inv_dfz = self.inv_hz, self.inv_dcz, self.inv_dfz
        if cfg.scheme != "central":
            conv_u, conv_v, conv_w = self._advect_donor(*windows)
        else:
            UC = 0.5 * (U[:, :, :-1] + U[:, :, 1:])
            VCC = 0.5 * (V[:, :-1, :] + V[:, 1:, :])
            WCC = 0.5 * (Wz[:-1] + Wz[1:])
            UY = (1.0 - wy) * U[:, :-1, :] + wy * U[:, 1:, :]
            VX = (1.0 - wx) * V[:, :, :-1] + wx * V[:, :, 1:]
            UZ = (1.0 - wcz) * UZG[:-1] + wcz * UZG[1:]
            WX = (1.0 - wx) * Wz[:, :, :-1] + wx * Wz[:, :, 1:]
            VZ = (1.0 - wcz) * VZG[:-1] + wcz * VZG[1:]
            WY = (1.0 - wy) * Wz[:, :-1, :] + wy * Wz[:, 1:, :]

            # --- the conservative central fluxes on the per-axis gaps
            FU = UC * UC
            GU = VX[:, 1:, :] * UY[:, :, 1:]
            HU = WX[:, 1:-1, :] * UZ[:, 1:-1, 1:]
            conv_u = ((FU[:, 1:1 + ny_l, 1:] - FU[:, 1:1 + ny_l, :-1]) * dcx_f
                      + ((GU[:, 1:, :] - GU[:, :-1, :]) * hy_own)[:, :, :nx_l]
                      + ((HU[1:] - HU[:-1]) * inv_hz)[:, :, :nx_l])
            GVC = VCC * VCC
            HV = WY[:, :ny_l, 1:1 + nx_l] * VZ[:, 1:1 + ny_l, 1:1 + nx_l]
            conv_v = (((GU[:, :, 1:] - GU[:, :, :-1]) * hx_own)[:, :ny_l, :]
                      + ((GVC[:, 1:, :] - GVC[:, :-1, :]) * dcy_f)[:, :ny_l, 1:1 + nx_l]
                      + (HV[1:] - HV[:-1]) * inv_hz)
            FW = UZ[:, 1:-1, 1:] * WX[:, 1:-1, :]
            GW = VZ[:, 1:, 1:1 + nx_l] * WY[:, :, 1:1 + nx_l]
            HWC = WCC * WCC
            dHW = F.pad((HWC[1:] - HWC[:-1]) * inv_dcz, (0, 0, 0, 0, 1, 0))
            conv_w = (((FW[:, :, 1:] - FW[:, :, :-1]) * hx_own)[:nz]
                      + ((GW[:, 1:, :] - GW[:, :-1, :]) * hy_own)[:nz]
                      + dHW[:, 1:1 + ny_l, 1:1 + nx_l])

        if cfg.use_les:
            # the variable-ν flux form replaces the molecular fluxes entirely
            visc_u, visc_v, visc_w = diffuse_les_metric(
                u_win, v_win, w_win, ghosts, cfg.nu + NUT, (self.hx_w, self.hy_w, inv_hz),
                (self.dcx_w, self.dcy_w, inv_dcz), (self.dfx_w, self.dfy_w, inv_dfz))
            du = visc_u[:, 2:2 + ny_l, 1:1 + nx_l] - conv_u
            dv = visc_v[:, 1:1 + ny_l, 2:2 + nx_l] - conv_v
            dw = visc_w[:, 2:2 + ny_l, 2:2 + nx_l] - conv_w[1:]
        else:
            # --- flux-form diffusion (mac_stretched3d._diffuse)
            dux = (U[:, 1:-1, 1:] - U[:, 1:-1, :-1]) * self.hx_m1
            duy = (U[:, 1:, 1:-1] - U[:, :-1, 1:-1]) * self.dfy_0
            duz = (UZG[1:, 1:-1, 1:-1] - UZG[:-1, 1:-1, 1:-1]) * inv_dfz
            lap_u = ((dux[:, :, 1:] - dux[:, :, :-1]) * dcx_f
                     + (duy[:, 1:, :] - duy[:, :-1, :]) * hy_own
                     + (duz[1:] - duz[:-1]) * inv_hz)
            dvy = (V[:, 1:, 1:-1] - V[:, :-1, 1:-1]) * self.hy_m1
            dvx = (V[:, 1:-1, 1:] - V[:, 1:-1, :-1]) * self.dfx_0
            dvz = (VZG[1:, 1:-1, 1:-1] - VZG[:-1, 1:-1, 1:-1]) * inv_dfz
            lap_v = ((dvx[:, :, 1:] - dvx[:, :, :-1]) * hx_own
                     + (dvy[:, 1:, :] - dvy[:, :-1, :]) * dcy_f
                     + (dvz[1:] - dvz[:-1]) * inv_hz)
            Wp = Wz[:nz]
            dwx = (Wp[:, 1:-1, 1:] - Wp[:, 1:-1, :-1]) * self.dfx_0
            dwy = (Wp[:, 1:, 1:-1] - Wp[:, :-1, 1:-1]) * self.dfy_0
            dwz = (Wz[1:, 1:-1, 1:-1] - Wz[:-1, 1:-1, 1:-1]) * inv_hz  # at the cells
            lap_w = ((dwx[:, :, 1:] - dwx[:, :, :-1]) * hx_own
                     + (dwy[:, 1:, :] - dwy[:, :-1, :]) * hy_own
                     + F.pad((dwz[1:] - dwz[:-1]) * inv_dcz, (0, 0, 0, 0, 1, 0)))
            du = cfg.nu * lap_u - conv_u
            dv = cfg.nu * lap_v - conv_v
            dw = (cfg.nu * lap_w - conv_w)[1:]
        u_star = u_t + torch.where(co >= 1, dt * du, 0.0)
        v_star = v_t + torch.where(ro >= 1, dt * dv, 0.0)
        w_star = torch.cat([w_t[:1], w_t[1:] + dt * dw], 0)
        if cfg.projection == "incremental":
            # the lagged pressure gradient; the projection solves for the increment
            PW = halo_exchange_edges(p_warm, mesh, 1)
            u_star = u_star + torch.where(
                co >= 1, -dt * (PW[:, 1:-1, 1:-1] - PW[:, 1:-1, :-2]) * dcx_f, 0.0)
            v_star = v_star + torch.where(
                ro >= 1, -dt * (PW[:, 1:-1, 1:-1] - PW[:, :-2, 1:-1]) * dcy_f, 0.0)
            w_star = torch.cat(
                [w_star[:1], w_star[1:] + -dt * (p_warm[1:] - p_warm[:-1]) * inv_dcz], 0)
        u_star, v_star, w_star, a = self._set_normal(u_star, v_star, w_star, ts)

        # --- the bodies; the momentum sinks weighted by the control volumes
        cv = (self.cv_u, self.cv_v, self.cv_w)
        sums = []
        if self.use_ibm:
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            d_ibm = [f * (strength * m) for f, m in zip((u_star, v_star, w_star), extras)]
            u_star, v_star, w_star = (f - d for f, d in zip((u_star, v_star, w_star), d_ibm))
            sums += [(d * c).sum() for d, c in zip(d_ibm, cv)]
        if self.ghost is not None:
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            outs = apply_ghost_forcing_stack(
                [u_star, v_star, w_star], [self.ghost.set(c) for c in "uvw"], mesh,
                self.ghost_width, strength)
            (u_star, du_g), (v_star, dv_g), (w_star, dw_g) = outs
            sums += [(d * c).sum() for d, c in zip((du_g, dv_g, dw_g), cv)]
        if self.moving is not None:
            (u_star, v_star, w_star), d_mb = self.moving(
                (u_star, v_star, w_star), ts.t, ibm_ramp(ts.step, self.ibm_ramp_steps))
            sums += [(d * c).sum() for d, c in zip(d_mb, cv)]

        # --- the exact distributed 3D FDM projection
        US, VS, WSz = self._pad(u_star, v_star, w_star, a, False, ts)
        div_star = ((US[:, 1:-1, 2:] - US[:, 1:-1, 1:-1]) * hx_own
                    + (VS[:, 2:, 1:-1] - VS[:, 1:-1, 1:-1]) * hy_own
                    + (WSz[1:, 1:-1, 1:-1] - WSz[:-1, 1:-1, 1:-1]) * inv_hz)
        phi = self.solve_p(div_star / dt)
        PH = halo_exchange_edges(phi, mesh, 1)
        u_new = u_star + torch.where(co >= 1, -dt * (PH[:, 1:-1, 1:-1] - PH[:, 1:-1, :-2]) * dcx_f,
                                     0.0)
        v_new = v_star + torch.where(ro >= 1, -dt * (PH[:, 1:-1, 1:-1] - PH[:, :-2, 1:-1]) * dcy_f,
                                     0.0)
        w_new = torch.cat([w_star[:1], w_star[1:] + -dt * (phi[1:] - phi[:-1]) * inv_dcz], 0)
        u_new, v_new, w_new, a = self._set_normal(u_new, v_new, w_new, ts)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        w_new = w_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        p_out = p_warm + phi if cfg.projection == "incremental" else phi
        return u_new, v_new, w_new, a, p_out, sums, div_star

    def _restage(self, ts, fields, a, p_warm, dt, extras):
        u, v, w, _, p, sums, div_star = self._stage(
            ts, *fields, a, self._inputs(*fields, a, ts, extras), p_warm, dt, extras)
        return (u, v, w), p, sums, div_star


    def forward(self, ts: MAC3DState, cfl_scale, *extras):
        cfg = self.cfg
        mesh = self.mesh
        bcs = self.bcs
        nz = cfg.nz
        ny_l, nx_l = self.local_shape
        ro = self.idx.ro
        h = self.h_min
        if ts.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {ts.u.device}")
        if len(extras) != (3 if self.use_ibm else 0):
            raise ValueError(f"the step takes {3 if self.use_ibm else 0} extra blocks, got "
                             f"{len(extras)}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)

        u_t, v_t, w_t, a = self._set_normal(ts.u, ts.v, ts.w, ts)
        inputs = self._inputs(u_t, v_t, w_t, a, ts, extras)
        if cfg.use_les:
            NUT = inputs[-1]
            nu_stab = cfg.nu + psum(NUT[:, 2:2 + ny_l, 2:2 + nx_l].sum(), mesh) / self.n_global
        if cfg.adaptive_dt:
            vel_max = pmax(torch.maximum(
                torch.maximum(u_t.abs().amax(), v_t.abs().amax()),
                torch.maximum(w_t.abs().amax(), bcs.velmax_extra(u_t, a)).clamp(min=1e-10)),
                mesh)
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            if cfg.use_les:
                dt = torch.minimum(dt_cfl, 0.125 * h * h / nu_stab)
            else:
                dt = dt_cfl.clamp(max=0.125 * h * h / cfg.nu)
            dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        u_new, v_new, w_new, a, phi, sums, div_star = self._stage(
            ts, u_t, v_t, w_t, a, inputs, ts.p, dt, extras)
        if cfg.time_scheme == "rk2":  # ν_t refreshed from the first stage
            (u_new, v_new, w_new), a, phi, sums, div_star = self._heun(
                ts, dt, (u_t, v_t, w_t), ((u_new, v_new, w_new), phi, sums), extras)

        dcy_f, hx_own, hy_own = self.dcy_f, self.hx_own, self.hy_own
        inv_hz, inv_dcz = self.inv_hz, self.inv_dcz
        new_ts = MAC3DState(u=u_new, v=v_new, w=w_new, p=phi, t=ts.t + dt, step=ts.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_ts, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero, zero)
        UN, VN, WNz = self._pad(u_new, v_new, w_new, a, False, ts)
        div_post = ((UN[:, 1:-1, 2:] - UN[:, 1:-1, 1:-1]) * hx_own
                    + (VN[:, 2:, 1:-1] - VN[:, 1:-1, 1:-1]) * hy_own
                    + (WNz[1:, 1:-1, 1:-1] - WNz[:-1, 1:-1, 1:-1]) * inv_hz)
        ucc = 0.5 * (UN[:, 1:-1, 1:-1] + UN[:, 1:-1, 2:])
        vcc = 0.5 * (VN[:, 1:-1, 1:-1] + VN[:, 2:, 1:-1])
        wcc = 0.5 * (WNz[:-1, 1:-1, 1:-1] + WNz[1:, 1:-1, 1:-1])
        dwdy = ((WNz[:, 1:1 + ny_l, 1:1 + nx_l] - WNz[:, :ny_l, 1:1 + nx_l]) * dcy_f)[1:nz]
        dvdz = (VN[1:, 1:1 + ny_l, 1:1 + nx_l] - VN[:-1, 1:1 + ny_l, 1:1 + nx_l]) * inv_dcz
        vort = torch.where(ro >= 1, dwdy - dvdz, 0.0)
        div_pre, div_post_m, max_vel, vort_max = pmax(torch.stack([
            div_star.abs().amax(), div_post.abs().amax(),
            torch.maximum(torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                          w_new.abs().amax()),
            vort.abs().amax()]), mesh).unbind(0)
        totals = psum(torch.stack([
            (self.cell_vol * 0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)).sum(), *sums]), mesh)
        f = [zero, zero, zero]
        for k in range(len(sums)):
            f[k % 3] = f[k % 3] + totals[1 + k] / dt
        return new_ts, StepMetrics(
            dt=dt, div_pre=div_pre, div_post=div_post_m, max_vel=max_vel,
            energy=totals[0] / self.volume, vort_max=vort_max,
            poisson_res=zero,  # the FDM solve is exact
            fx=f[0], fy=f[1], fz=f[2])


def make_stretched3d_explicit_step(cfg: StretchedMAC3DConfig, mesh: GridMesh, x_faces, y_faces,
                                   z_faces, bcs: MAC3DLocalBCs, use_ibm: bool = False,
                                   ibm_ramp_steps: int = 0, moving_body=None, ibm_ghost=None, *,
                                   device=None) -> Stretched3DExplicitStep:
    """Build the explicit-communication stretched 3D MAC step on the trimmed
    blocks: ``step(tstate, cfl_scale[, mask_u_t, mask_v_t, mask_w_t])``.
    ``bcs`` is a ``mac3d_explicit.MAC3DLocalBCs`` kit; the optional masks are
    this rank's blocks of ``mac3d_explicit.trim_face_masks3d``, the body
    force weighted by the staggered control volumes. ``ibm_ghost`` (the
    whole-grid ``GhostIBM3D``) gives the ghost-cell IBM, cut into this rank's
    tables here; ``moving_body`` a penalized moving sphere (a taper of the
    smallest spacing)."""
    return Stretched3DExplicitStep(cfg, mesh, x_faces, y_faces, z_faces, bcs, use_ibm,
                                   ibm_ramp_steps, moving_body, ibm_ghost, device=device)


def make_cavity3d_stretched_explicit_step(cfg: StretchedMAC3DConfig, mesh: GridMesh, x_faces,
                                          y_faces, z_faces, lid_velocity: float = 1.0, *,
                                          device=None) -> Stretched3DExplicitStep:
    """The explicit-communication stretched 3D step of the lid-driven cavity."""
    return make_stretched3d_explicit_step(cfg, mesh, x_faces, y_faces, z_faces,
                                          cavity3d_local_bcs(cfg.nx, cfg.ny, lid_velocity),
                                          device=device)


def sphere_stretched_local_bcs(cfg, y_faces, z_faces, v_inf: float, mesh: GridMesh,
                               inlet_profile=None):
    """The external flow of the stretched sphere: its outflow's mass balance
    weighted by the x-face areas h_y⊗h_z; ``inlet_profile`` the whole-grid
    (nz, ny) inflow modulation, or None."""
    fw = np.diff(np.asarray(z_faces))[:, None] * np.diff(np.asarray(y_faces))[None, :]
    return external_flow3d_local_bcs(cfg.nx, cfg.ny, cfg.nz, v_inf, face_weights=fw,
                                     inlet_profile=inlet_profile, mesh=mesh)


def make_sphere3d_stretched_explicit_step(cfg: StretchedMAC3DConfig, mesh: GridMesh, x_faces,
                                          y_faces, z_faces, v_inf: float = 1.0,
                                          ibm_ramp_steps: int = 0, inlet_profile=None, *,
                                          device=None) -> Stretched3DExplicitStep:
    """The explicit-communication stretched 3D step of the external flow past
    an immersed body (``sphere_stretched``): ``step(tstate, cfl_scale,
    mask_u_t, mask_v_t, mask_w_t)``."""
    return make_stretched3d_explicit_step(
        cfg, mesh, x_faces, y_faces, z_faces,
        sphere_stretched_local_bcs(cfg, y_faces, z_faces, v_inf, mesh, inlet_profile),
        use_ibm=True, ibm_ramp_steps=ibm_ramp_steps, device=device)


def make_sphere_ghost3d_stretched_explicit_step(cfg: StretchedMAC3DConfig, mesh: GridMesh,
                                                x_faces, y_faces, z_faces, ghost,
                                                v_inf: float = 1.0, ibm_ramp_steps: int = 0,
                                                inlet_profile=None, *,
                                                device=None) -> Stretched3DExplicitStep:
    """The stretched ghost-cell sphere (``sphere_stretched`` with
    ``ibm_scheme="ghost"``): ``ghost`` is the whole-grid ``GhostIBM3D``, cut
    into this rank's tables, which the step holds: ``step(tstate,
    cfl_scale)``."""
    return make_stretched3d_explicit_step(
        cfg, mesh, x_faces, y_faces, z_faces,
        sphere_stretched_local_bcs(cfg, y_faces, z_faces, v_inf, mesh, inlet_profile),
        ibm_ghost=ghost, ibm_ramp_steps=ibm_ramp_steps, device=device)


def make_moving_body3d_stretched_explicit_step(cfg: StretchedMAC3DConfig, mesh: GridMesh,
                                               x_faces, y_faces, z_faces, moving_body,
                                               ibm_ramp_steps: int = 0, *,
                                               device=None) -> Stretched3DExplicitStep:
    """The explicit-communication stretched 3D step of a penalized moving
    sphere in a quiescent free-slip box: ``step(tstate, cfl_scale)``."""
    return make_stretched3d_explicit_step(cfg, mesh, x_faces, y_faces, z_faces,
                                          free_slip3d_local_bcs(cfg.nx, cfg.ny),
                                          moving_body=moving_body,
                                          ibm_ramp_steps=ibm_ramp_steps, device=device)
