"""The 3D forced-convection step on rank blocks
(``cfdsim_tpu.parallel.transport3d_explicit``): the heated sphere.

The distributed external-flow momentum step (``mac3d_explicit.py``, or
``mac_stretched3d_explicit.py`` on the stretched grid) advances the
velocities; θ, cell-centred (nz, ny, nx) and cut like the pressure, then
takes the conservative finite-volume fluxes of the *projected* velocities
(the dropped outflow face rebuilt with the same masked writes and summed
shift as the momentum step's) and its open-domain ghosts as global-index
writes on a width-1 halo: the inflow's Dirichlet mirror, zero gradient at
the outflow and the lateral faces, adiabatic in z. ``theta_scheme="tvd"``
exchanges a width-2 halo instead and runs the single-device MUSCL face
values (``mac_stretched3d._muscl_axis``'s van Leer slopes) on it: the
slopes of the ghost lines are zeroed by global index, as the single-device
slopes end there, and on the stretched grid the window takes its own lines
of the face gaps and donor distances. The isothermal body's θ
penalization or ghost-cell forcing and its heat flux (the Nusselt number)
follow ``models/transport3d.py`` term for term, reduced over the mesh.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models import mac3d
from cfdsim_tpu_torch.models import mac_stretched3d as ms3
from cfdsim_tpu_torch.models.mac_stretched import _metrics
from cfdsim_tpu_torch.models.transport3d import (
    Transport3DConfig,
    Transport3DMetrics,
    Transport3DState,
    _flow_fields,
)
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.parallel.halo import halo_exchange_edges
from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import (
    GhostTables,
    apply_ghost_forcing_local,
    clamped_line,
    partition_ghost_ibm3d,
)
from cfdsim_tpu_torch.parallel.mac3d_explicit import (
    BoxIndices,
    MAC3DExplicitStep,
    external_flow3d_local_bcs,
)
from cfdsim_tpu_torch.parallel.mac_stretched3d_explicit import (
    Stretched3DExplicitStep,
    sphere_stretched_local_bcs,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum


def _check(cfg: Transport3DConfig, ghost, ghost_c):
    if (ghost is None) != (ghost_c is None):
        raise ValueError("ghost and ghost_c must be given together")
    if cfg.theta_scheme not in ("central", "upwind", "tvd"):
        raise ValueError(f"unknown theta_scheme {cfg.theta_scheme!r}")


def _donor_gaps(faces):
    """(1/gap, donor distance from below, donor distance from above) at every
    face of an axis: the single-device MUSCL tables (``mac_stretched3d``'s
    ``inv_df*``, ``d*l_f``, ``d*r_f``), float64."""
    f = np.asarray(faces, np.float64)
    m = _metrics(f)
    g = np.concatenate([[m.xc[0] - m.h[0]], m.xc, [m.xc[-1] + m.h[-1]]])
    return 1.0 / m.dfull, f - g[:-1], g[1:] - f


def _muscl_window(q, inv_sp, d_lo, d_hi, axis: int, gidx, n: int):
    """MUSCL (lo, hi) donor values at the faces between consecutive window
    samples of ``q`` along ``axis`` (``_muscl_axis`` on a window): the van
    Leer slopes of the samples whose global index ``gidx`` lies outside 0 …
    n − 1 (the ghost and beyond) are zero, as the single-device slopes are
    at the ghost-extended array's end samples."""
    m = q.shape[axis]
    lo, hi = q.narrow(axis, 0, m - 1), q.narrow(axis, 1, m - 1)
    dq = (hi - lo) * inv_sp
    k = dq.shape[axis]
    g = vanleer_slope(dq.narrow(axis, 0, k - 1), dq.narrow(axis, 1, k - 1))
    z = torch.zeros_like(g.narrow(axis, 0, 1))
    g = torch.where((gidx < 0) | (gidx >= n), 0.0, torch.cat([z, g, z], axis))
    return lo + g.narrow(axis, 0, m - 1) * d_lo, hi - g.narrow(axis, 1, m - 1) * d_hi


class HeatedSphereExplicitStep(nn.Module):
    """``step(tstate, cfl_scale[, mask_u_t, mask_v_t, mask_w_t, mask_c]) ->
    (tstate, Transport3DMetrics)`` on this rank's blocks: ``flow`` (a
    distributed external-flow momentum step) then θ. ``faces`` holds the
    stretched grid's face vectors (None: uniform); ``table_c`` and
    ``width`` are this rank's cell-centred ghost table (None: the θ
    penalization mask comes with the call)."""

    def __init__(self, cfg: Transport3DConfig, mesh: GridMesh, flow, bcs, ibm_ramp_steps: int,
                 faces=None, table_c=None, width=None, *, device):
        super().__init__()
        g = cfg.grid
        self.cfg, self.mesh, self.flow, self.bcs = cfg, mesh, flow, bcs
        self.ibm_ramp_steps = ibm_ramp_steps
        self.device = device
        self.reads_host = False
        self.collectives = True
        self.local_shape = flow.local_shape
        self.idx = BoxIndices(self.local_shape, mesh)
        self.alpha = cfg.nu / cfg.prandtl
        self.qscale = 1.0 / (np.pi * cfg.body_diameter * self.alpha
                             * max(abs(cfg.theta_body - cfg.theta_in), 1e-30))
        self.ghost_c, self.width = None, width
        if table_c is not None:
            self.ghost_c = GhostTables({"c": table_c}, device=device)
        self.stretched = faces is not None
        self.tvd = cfg.theta_scheme == "tvd"
        ny_l, nx_l = self.local_shape
        gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l

        def line(name, vec, start, axis, n=None):
            if n is None:
                n = nx_l if axis == 2 else ny_l
            self.register_buffer(name, clamped_line(vec, start, n, axis, 3, device=device))

        if self.tvd:
            # the window's sample indices: k ↔ cell g0 − 2 + k along x and y
            line("gx2", np.arange(g.nx + 4) - 2, gx0, 2, nx_l + 4)
            line("gy2", np.arange(g.ny + 4) - 2, gy0, 1, ny_l + 4)
            # the global x face index of each owned x face (the inflow's is 0)
            line("fx_own", np.arange(g.nx + 1), gx0, 2, nx_l + 1)
            if self.stretched:
                # the window faces k ↔ face g0 − 1 + k, clamped where only
                # zeroed slopes read them
                for a, f, start, n, ax in (("x", faces[0], gx0 - 1, nx_l + 3, 2),
                                           ("y", faces[1], gy0 - 1, ny_l + 3, 1)):
                    for name, vec in zip(("inv_df", "dl", "dr"), _donor_gaps(f)):
                        line(f"{name}{a}_win", vec, start, ax, n)
                for name, vec in zip(("inv_df", "dl", "dr"), _donor_gaps(faces[2])):
                    self.register_buffer(f"{name}z_line", torch.as_tensor(
                        vec.astype(np.float32)[:, None, None], device=device))
        if self.stretched:
            mx, my, mz = (_metrics(f) for f in faces)

            def zline(name, vec):
                self.register_buffer(name, torch.as_tensor(
                    np.asarray(vec, np.float64).astype(np.float32)[:, None, None],
                    device=device))

            line("inv_hx", 1.0 / mx.h, gx0, 2)
            line("inv_hy", 1.0 / my.h, gy0, 1)
            line("inv_dfx_w", 1.0 / mx.dfull, gx0, 2)  # the west/east face gaps
            line("inv_dfx_e", 1.0 / mx.dfull, gx0 + 1, 2)
            line("inv_dfy_s", 1.0 / my.dfull, gy0, 1)
            line("inv_dfy_n", 1.0 / my.dfull, gy0 + 1, 1)
            zline("inv_hz", 1.0 / mz.h)
            zline("inv_dfz_b", 1.0 / mz.dfull[:g.nz])
            zline("inv_dfz_t", 1.0 / mz.dfull[1:])
            cell_vol = mz.h[:, None, None] * my.h[None, :, None] * mx.h[None, None, :]
            self.register_buffer("cell_vol", torch.as_tensor(np.ascontiguousarray(
                cell_vol[:, gy0:gy0 + ny_l, gx0:gx0 + nx_l]).astype(np.float32), device=device))
        else:
            self.cell_vol = g.dx * g.dy * g.dz

    def _theta(self, theta, u_t, v_t, w_t, dt, step_i, mask_c):
        """θ advanced by the projected faces: (θ, q_body, Nu, θ_min, θ_max)."""
        cfg = self.cfg
        mesh = self.mesh
        bcs = self.bcs
        idx = self.idx
        g = cfg.grid
        nx, ny = g.nx, g.ny
        ro, co, rp, cp = idx.ro, idx.co, idx.rp, idx.cp
        # the velocity faces of the owned cells, with the momentum step's BC
        # writes (the outflow face needs its summed shift)
        a = bcs.aux(u_t, v_t, w_t, ro, co, None)
        U, V, W = halo_exchange_edges(torch.stack([u_t, v_t, w_t]), mesh, 1).unbind(0)
        U, V, Wz = bcs.pad_writes(U, V, torch.cat([W, torch.zeros_like(W[:1])], 0), rp, cp,
                                  None, a)
        u_w, u_e = U[:, 1:-1, 1:-1], U[:, 1:-1, 2:]
        v_s, v_n = V[:, 1:-1, 1:-1], V[:, 2:, 1:-1]
        w_b, w_t_ = Wz[:-1, 1:-1, 1:-1], Wz[1:, 1:-1, 1:-1]
        # θ's ghosts: the inflow mirror, zero gradient elsewhere, adiabatic z
        # (width 2 for the MUSCL slopes; the lines beyond the ghosts feed only
        # zeroed slopes)
        w = 2 if self.tvd else 1
        rw, cw = (idx.r2, idx.c2) if self.tvd else (rp, cp)
        TH = halo_exchange_edges(theta, mesh, w)
        TH = torch.where(cw == -1, 2.0 * cfg.theta_in - torch.roll(TH, -1, 2), TH)
        TH = torch.where(cw == nx, torch.roll(TH, 1, 2), TH)
        TH = torch.where(rw == -1, torch.roll(TH, -1, 1), TH)
        TH = torch.where(rw == ny, torch.roll(TH, 1, 1), TH)
        TH2, TH = TH, (TH[:, 1:-1, 1:-1] if self.tvd else TH)
        te = torch.cat([TH[:1], TH, TH[-1:]], 0)
        th_c = te[1:-1, 1:-1, 1:-1]
        th_wv, th_ev = te[1:-1, 1:-1, :-2], te[1:-1, 1:-1, 2:]
        th_sv, th_nv = te[1:-1, :-2, 1:-1], te[1:-1, 2:, 1:-1]
        th_bv, th_tv = te[:-2, 1:-1, 1:-1], te[2:, 1:-1, 1:-1]
        if self.tvd:
            fxa_w, fxa_e, fya_s, fya_n, fza_b, fza_t = self._tvd_fluxes(
                TH2, theta, U[:, 1:-1, 1:], V[:, 1:, 1:-1], Wz[:, 1:-1, 1:-1])
        elif cfg.theta_scheme == "upwind":
            # at the inflow face the advective donor is θ_in, not the mirror
            donor_w = torch.where(u_w >= 0.0, th_wv, th_c)
            donor_w = torch.where((co == 0) & (u_w >= 0.0), cfg.theta_in, donor_w)
            fxa_w = u_w * donor_w
            fxa_e = u_e * torch.where(u_e >= 0.0, th_c, th_ev)
            fya_s = v_s * torch.where(v_s >= 0.0, th_sv, th_c)
            fya_n = v_n * torch.where(v_n >= 0.0, th_c, th_nv)
            fza_b = w_b * torch.where(w_b >= 0.0, th_bv, th_c)
            fza_t = w_t_ * torch.where(w_t_ >= 0.0, th_c, th_tv)
        else:
            fxa_w, fxa_e = u_w * (0.5 * (th_wv + th_c)), u_e * (0.5 * (th_c + th_ev))
            fya_s, fya_n = v_s * (0.5 * (th_sv + th_c)), v_n * (0.5 * (th_c + th_nv))
            fza_b, fza_t = w_b * (0.5 * (th_bv + th_c)), w_t_ * (0.5 * (th_c + th_tv))
        if self.stretched:
            adv = ((fxa_e - fxa_w) * self.inv_hx + (fya_n - fya_s) * self.inv_hy
                   + (fza_t - fza_b) * self.inv_hz)
            lap_t = (((th_ev - th_c) * self.inv_dfx_e - (th_c - th_wv) * self.inv_dfx_w)
                     * self.inv_hx
                     + ((th_nv - th_c) * self.inv_dfy_n - (th_c - th_sv) * self.inv_dfy_s)
                     * self.inv_hy
                     + ((th_tv - th_c) * self.inv_dfz_t - (th_c - th_bv) * self.inv_dfz_b)
                     * self.inv_hz)
        else:
            dx, dy, dz = g.dx, g.dy, g.dz
            adv = ((fxa_e - fxa_w) * (1.0 / dx) + (fya_n - fya_s) * (1.0 / dy)
                   + (fza_t - fza_b) * (1.0 / dz))
            lap_t = ((th_ev - 2.0 * th_c + th_wv) * (1.0 / dx**2)
                     + (th_nv - 2.0 * th_c + th_sv) * (1.0 / dy**2)
                     + (th_tv - 2.0 * th_c + th_bv) * (1.0 / dz**2))
        theta_new = theta + dt * (self.alpha * lap_t - adv)

        strength = ibm_ramp(step_i, self.ibm_ramp_steps)
        if self.ghost_c is not None:
            # the ghost forcing of θ's excess over the body temperature
            shifted, dneg = apply_ghost_forcing_local(theta_new - cfg.theta_body,
                                                      self.ghost_c.set("c"), mesh, self.width,
                                                      strength)
            theta_new = shifted + cfg.theta_body
            dth = -dneg
        else:
            dth = (cfg.theta_body - theta_new) * (strength * mask_c)
            theta_new = theta_new + dth
        if torch.is_tensor(self.cell_vol):
            q_body = psum((dth * self.cell_vol).sum(), mesh) / dt
        else:
            q_body = psum(dth.sum(), mesh) * self.cell_vol / dt
        neg_min, th_max = pmax(torch.stack([(-theta_new).amax(), theta_new.amax()]),
                               mesh).unbind(0)
        return theta_new, q_body, q_body * self.qscale, -neg_min, th_max

    def _tvd_fluxes(self, TH2, theta, uf, vf, wf):
        """The MUSCL advective fluxes at the owned cells' west/east,
        south/north and bottom/top faces from the width-2 θ window ``TH2``
        and the owned faces' velocities ``uf`` (x faces gx0 … gx0+nx_l),
        ``vf``, ``wf`` (all nz+1 z faces)."""
        cfg = self.cfg
        g = cfg.grid
        ny_l, nx_l = self.local_shape
        if self.stretched:
            mx = (self.inv_dfx_win, self.dlx_win, self.drx_win)
            my = (self.inv_dfy_win, self.dly_win, self.dry_win)
            mz = (self.inv_dfz_line, self.dlz_line, self.drz_line)
        else:
            mx, my, mz = ((1.0 / d, 0.5 * d, 0.5 * d) for d in (g.dx, g.dy, g.dz))
        # window faces 1 … n_l + 1 are the owned ones
        lo, hi = _muscl_window(TH2[:, 2:-2, :], *mx, 2, self.gx2, g.nx)
        thx = torch.where(uf >= 0.0, lo[:, :, 1:nx_l + 2], hi[:, :, 1:nx_l + 2])
        # at the inflow face the advective donor is θ_in (or the cell's θ)
        thx = torch.where(self.fx_own == 0,
                          torch.where(uf >= 0.0, cfg.theta_in, TH2[:, 2:-2, 2:3 + nx_l]), thx)
        lo, hi = _muscl_window(TH2[:, :, 2:-2], *my, 1, self.gy2, g.ny)
        thy = torch.where(vf >= 0.0, lo[:, 1:ny_l + 2], hi[:, 1:ny_l + 2])
        lo, hi = ms3._muscl_axis(torch.cat([theta[:1], theta, theta[-1:]], 0), *mz, 0, True)
        thz = torch.where(wf >= 0.0, lo, hi)
        fx, fy, fz = uf * thx, vf * thy, wf * thz
        return fx[:, :, :-1], fx[:, :, 1:], fy[:, :-1], fy[:, 1:], fz[:-1], fz[1:]

    def forward(self, ts: Transport3DState, cfl_scale, *ibm_args):
        mac_ts = mac3d.MAC3DState(u=ts.u, v=ts.v, w=ts.w, p=ts.p, t=ts.t, step=ts.step)
        if self.ghost_c is not None:
            if ibm_args:
                raise ValueError("the ghost-cell heated sphere's step takes no masks")
            new_mac, fm = self.flow(mac_ts, cfl_scale)
            mask_c = None
        else:
            if len(ibm_args) != 4:
                raise ValueError("the step takes mask_u_t, mask_v_t, mask_w_t and mask_c")
            *masks, mask_c = ibm_args
            new_mac, fm = self.flow(mac_ts, cfl_scale, *masks)
        theta_new, q_body, nusselt, th_min, th_max = self._theta(
            ts.theta, new_mac.u, new_mac.v, new_mac.w, fm.dt, ts.step, mask_c)
        new_ts = Transport3DState(u=new_mac.u, v=new_mac.v, w=new_mac.w, p=new_mac.p,
                                  theta=theta_new, t=new_mac.t, step=new_mac.step)
        return new_ts, Transport3DMetrics(
            dt=fm.dt, div_post=fm.div_post, max_vel=fm.max_vel, energy=fm.energy, fx=fm.fx,
            fy=fm.fy, fz=fm.fz, q_body=q_body, nusselt=nusselt, theta_min=th_min,
            theta_max=th_max)


def _theta_table(ghost, ghost_c, cfg, mesh, device):
    """(this rank's cell-centred ghost table, its halo width) or (None,
    None): cut with the face sets, so that its width covers them all, as the
    JAX package's one pass does (the momentum step cuts its own)."""
    if ghost is None:
        return None, None
    g = cfg.grid
    _, width, table_c = partition_ghost_ibm3d(ghost, g.nx, g.ny, g.nz, mesh, extra=ghost_c,
                                              device=device)
    return table_c, width


def make_heated_sphere_explicit_step(cfg: Transport3DConfig, mesh: GridMesh, v_inf: float,
                                     ibm_ramp_steps: int = 0, ghost=None, ghost_c=None, *,
                                     device=None) -> HeatedSphereExplicitStep:
    """The distributed heated sphere (``models/transport3d.make_step``):
    ``step(tstate, cfl_scale, mask_u_t, mask_v_t, mask_w_t, mask_c)`` on the
    trimmed state (``mac3d_explicit.trim_state3d`` of a ``Transport3DState``,
    θ cut like the pressure), the face masks from
    ``mac3d_explicit.trim_face_masks3d`` and ``mask_c`` this rank's block of
    the (nz, ny, nx) cell mask. ``ghost``/``ghost_c`` (the whole-grid
    ``GhostIBM3D`` and cell-centred ``GhostFaceSet``) give the ghost-cell
    treatment of momentum and θ, cut into this rank's tables; the step then
    takes no masks: ``step(tstate, cfl_scale)``."""
    _check(cfg, ghost, ghost_c)
    g = cfg.grid
    device = mesh.device if device is None else torch.device(device)
    flow_cfg = mac3d.MAC3DConfig(grid=g, poisson=cfg.poisson,
                                 **_flow_fields(cfg, min(g.dx, g.dy, g.dz)))
    bcs = external_flow3d_local_bcs(g.nx, g.ny, g.nz, v_inf, mesh=mesh)
    flow = MAC3DExplicitStep(flow_cfg, mesh, bcs, use_ibm=ghost is None,
                             ibm_ramp_steps=ibm_ramp_steps, ibm_ghost=ghost, device=device)
    return HeatedSphereExplicitStep(cfg, mesh, flow, bcs, ibm_ramp_steps, None,
                                    *_theta_table(ghost, ghost_c, cfg, mesh, device),
                                    device=device)


def make_heated_sphere_stretched_explicit_step(cfg: Transport3DConfig, mesh: GridMesh, x_faces,
                                               y_faces, z_faces, v_inf: float,
                                               ibm_ramp_steps: int = 0, ghost=None,
                                               ghost_c=None, *,
                                               device=None) -> HeatedSphereExplicitStep:
    """The stretched heated sphere (``transport3d.make_stretched_step``,
    any momentum scheme): the distributed stretched momentum step (the
    FDM projection, the area-weighted outflow) and θ's metric-weighted
    fluxes; the call signatures of :func:`make_heated_sphere_explicit_step`."""
    _check(cfg, ghost, ghost_c)
    g = cfg.grid
    device = mesh.device if device is None else torch.device(device)
    h_min = float(min(np.diff(np.asarray(f, np.float64)).min()
                      for f in (x_faces, y_faces, z_faces)))
    flow_cfg = ms3.StretchedMAC3DConfig(nx=g.nx, ny=g.ny, nz=g.nz, **_flow_fields(cfg, h_min))
    bcs = sphere_stretched_local_bcs(flow_cfg, y_faces, z_faces, v_inf, mesh)
    flow = Stretched3DExplicitStep(flow_cfg, mesh, x_faces, y_faces, z_faces, bcs,
                                   use_ibm=ghost is None, ibm_ramp_steps=ibm_ramp_steps,
                                   ibm_ghost=ghost, device=device)
    return HeatedSphereExplicitStep(cfg, mesh, flow, bcs, ibm_ramp_steps,
                                    (x_faces, y_faces, z_faces),
                                    *_theta_table(ghost, ghost_c, cfg, mesh, device),
                                    device=device)
