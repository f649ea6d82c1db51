"""The 3D Boussinesq step on rank blocks (``cfdsim_tpu.parallel.boussinesq3d_explicit``):
the differentially heated cube.

The MAC faces ride the trimmed 3D blocks of ``parallel/mac3d_explicit.py``
(z local, width-1 y/x halos, the no-slip box of ``cavity3d_bc_kit``), the
temperature rides width-1 halos with its Dirichlet x walls and adiabatic y
walls as global-index writes and local z ghosts, and the projection is the
distributed 3D solve of ``incompressible3d_explicit.DistributedPoisson3D``
by the configured method (the pencil DCT by default, multigrid, SOR). The
central flow scheme (the validated heated-cube configuration) runs on the
width-1 padded blocks; upwind and TVD run the single-device
``mac3d.advect3d`` on the width-2 windows of ``mac3d_explicit.py`` (the
closed box's writes of ``cavity3d_local_bcs``, its no-slip reflection for
the tangential ghosts and the slopes zeroed on the global boundary lines,
where the single-device slopes end) and crop to the owned faces. Buoyancy,
the θ fluxes and the Nusselt numbers follow ``models/boussinesq3d.py`` term
for term.
"""

from __future__ import annotations

import torch
from torch import nn

from cfdsim_tpu_torch.models.boussinesq import BoussinesqMetrics
from cfdsim_tpu_torch.models.mac3d import advect3d
from cfdsim_tpu_torch.models.boussinesq3d import Boussinesq3DConfig, Boussinesq3DState
from cfdsim_tpu_torch.parallel.explicit import check_divisible, step_device
from cfdsim_tpu_torch.parallel.halo import halo_exchange_edges
from cfdsim_tpu_torch.parallel.incompressible3d_explicit import DistributedPoisson3D
from cfdsim_tpu_torch.parallel.mac3d_explicit import (
    cavity3d_bc_kit,
    cavity3d_local_bcs,
    flow_windows,
    shard_trimmed_state3d,
    trim_state3d,
    untrim_state3d,
    window_slope_fix,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum

# the trimmed-state helpers are generic over a state with u/v/w faces (θ and
# p are cell arrays, cut the same way)
trim_boussinesq3d_state = trim_state3d
untrim_boussinesq3d_state = untrim_state3d
shard_boussinesq3d_state = shard_trimmed_state3d


class HeatedCubeExplicitStep(nn.Module):
    """``step(tstate, cfl_scale) -> (tstate, BoussinesqMetrics)`` on this
    rank's trimmed blocks; see :func:`make_heated_cube_explicit_step`."""

    def __init__(self, cfg: Boussinesq3DConfig, mesh: GridMesh, *, device=None):
        super().__init__()
        g = cfg.grid
        self.local_shape = check_divisible(g, mesh, min_block=2)
        if cfg.flow_scheme not in ("central", "upwind", "tvd"):
            raise ValueError(f"unknown flow_scheme {cfg.flow_scheme!r}")
        if cfg.theta_scheme not in ("central", "upwind"):
            raise ValueError(f"unknown theta_scheme {cfg.theta_scheme!r}")
        self.cfg, self.mesh = cfg, mesh
        self.device = step_device(mesh, device)
        self.poisson = DistributedPoisson3D(g.shape, g.dx, g.dy, g.dz, cfg.poisson, mesh)
        self.n_global = float(g.nx * g.ny * g.nz)
        self.reads_host = False
        self.collectives = True
        self.idx, self.set_normal, self.pad = cavity3d_bc_kit(g.nx, g.ny, mesh, self.local_shape)
        self.box = cavity3d_local_bcs(g.nx, g.ny, 0.0)  # the windows' writes
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=self.device))

    def _theta_ghost(self, th):
        """(nz+2, ny_l+2, nx_l+2) padded θ: the y/x halos with the Dirichlet x
        walls and adiabatic y walls written, local adiabatic z ghosts."""
        cfg = self.cfg
        ny, nx = cfg.grid.ny, cfg.grid.nx
        rp, cp = self.idx.rp, self.idx.cp
        te = halo_exchange_edges(th, self.mesh, 1)
        te = torch.where(cp == -1, 2.0 * cfg.theta_hot - torch.roll(te, -1, 2), te)
        te = torch.where(cp == nx, 2.0 * cfg.theta_cold - torch.roll(te, 1, 2), te)
        te = torch.where(rp == -1, torch.roll(te, -1, 1), te)
        te = torch.where(rp == ny, torch.roll(te, 1, 1), te)
        return torch.cat([te[:1], te, te[-1:]], 0)

    def _central(self, U, V, Wz, UZG, VZG):
        """The central conservative advection on the width-1 padded blocks
        (corners included): (conv_u, conv_v, conv_w) at the owned faces."""
        g = self.cfg.grid
        nz, dx, dy, dz = g.nz, g.dx, g.dy, g.dz
        ny_l, nx_l = self.local_shape
        UC = 0.5 * (U[:, :, :-1] + U[:, :, 1:])
        VCC = 0.5 * (V[:, :-1, :] + V[:, 1:, :])
        WCC = 0.5 * (Wz[:-1] + Wz[1:])
        UY = 0.5 * (U[:, :-1, :] + U[:, 1:, :])
        VX = 0.5 * (V[:, :, :-1] + V[:, :, 1:])
        UZ = 0.5 * (UZG[:-1] + UZG[1:])
        WX = 0.5 * (Wz[:, :, :-1] + Wz[:, :, 1:])
        VZ = 0.5 * (VZG[:-1] + VZG[1:])
        WY = 0.5 * (Wz[:, :-1, :] + Wz[:, 1:, :])
        FU = UC * UC
        GU = VX[:, 1:, :] * UY[:, :, 1:]
        HU = WX[:, 1:-1, :] * UZ[:, 1:-1, 1:]
        conv_u = ((FU[:, 1:1 + ny_l, 1:] - FU[:, 1:1 + ny_l, :-1]) * (1.0 / dx)
                  + ((GU[:, 1:, :] - GU[:, :-1, :]) * (1.0 / dy))[:, :, :nx_l]
                  + ((HU[1:] - HU[:-1]) * (1.0 / dz))[:, :, :nx_l])
        GVC = VCC * VCC
        HV = WY[:, :ny_l, 1:1 + nx_l] * VZ[:, 1:1 + ny_l, 1:1 + nx_l]
        conv_v = (((GU[:, :, 1:] - GU[:, :, :-1]) * (1.0 / dx))[:, :ny_l, :]
                  + ((GVC[:, 1:, :] - GVC[:, :-1, :]) * (1.0 / dy))[:, :ny_l, 1:1 + nx_l]
                  + (HV[1:] - HV[:-1]) * (1.0 / dz))
        FW = UZ[:, 1:-1, 1:] * WX[:, 1:-1, :]
        GW = VZ[:, 1:, 1:1 + nx_l] * WY[:, :, 1:1 + nx_l]
        HWC = WCC * WCC
        # at the interior z-faces 1 … nz−1
        conv_w = (((FW[:, :, 1:] - FW[:, :, :-1]) * (1.0 / dx))[1:nz]
                  + ((GW[:, 1:, :] - GW[:, :-1, :]) * (1.0 / dy))[1:nz]
                  + ((HWC[1:] - HWC[:-1]) * (1.0 / dz))[:, 1:1 + ny_l, 1:1 + nx_l])
        return conv_u, conv_v, conv_w

    def _muscl(self, u_t, v_t, w_t):
        """The upwind or TVD advection of ``mac3d.advect3d`` on the width-2
        windows, cropped to the owned faces (u at its interior x faces, w at
        the interior z faces)."""
        g = self.cfg.grid
        ny_l, nx_l = self.local_shape
        windows = flow_windows(u_t, v_t, w_t, self.box, self.idx, self.mesh, None, ())
        conv_u, conv_v, conv_w = advect3d(
            *windows, g.dx, g.dy, g.dz, self.cfg.flow_scheme,
            slope_fix=lambda name, s: window_slope_fix(name, s, g.ny, g.nx, self.local_shape,
                                                       self.mesh))
        return (conv_u[:, 2:2 + ny_l, 1:1 + nx_l], conv_v[:, 1:1 + ny_l, 2:2 + nx_l],
                conv_w[:, 2:2 + ny_l, 2:2 + nx_l])

    def forward(self, ts: Boussinesq3DState, cfl_scale):
        cfg = self.cfg
        mesh = self.mesh
        g = cfg.grid
        nx, ny, nz = g.nx, g.ny, g.nz
        dx, dy, dz = g.dx, g.dy, g.dz
        nu = cfg.prandtl
        buoy = cfg.rayleigh * cfg.prandtl
        h = min(dx, dy, dz)
        ny_l, nx_l = self.local_shape
        ro, co = self.idx.ro, self.idx.co
        set_normal, pad = self.set_normal, self.pad
        if ts.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {ts.u.device}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)

        u_t, v_t, w_t = set_normal(ts.u, ts.v, ts.w)
        theta = ts.theta
        U, V, Wz = pad(u_t, v_t, w_t)  # the edge interpolants read corners
        UZG = torch.cat([-U[:1], U, -U[-1:]], 0)  # no-slip z walls
        VZG = torch.cat([-V[:1], V, -V[-1:]], 0)

        if cfg.adaptive_dt:
            vel_max = pmax(torch.maximum(torch.maximum(u_t.abs().amax(), v_t.abs().amax()),
                                         w_t.abs().amax().clamp(min=1e-10)), mesh)
            dt = (cfg.cfl_target * cfl_scale * h / vel_max).clamp(
                max=0.125 * h * h / max(nu, 1.0)).clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        if cfg.flow_scheme == "central":
            conv_u, conv_v, conv_w = self._central(U, V, Wz, UZG, VZG)
        else:
            conv_u, conv_v, conv_w = self._muscl(u_t, v_t, w_t)

        ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2

        def lap(Q, QZ):
            c = Q[:, 1:-1, 1:-1]
            return ((Q[:, 1:-1, 2:] - 2.0 * c + Q[:, 1:-1, :-2]) * ax
                    + (Q[:, 2:, 1:-1] - 2.0 * c + Q[:, :-2, 1:-1]) * ay
                    + (QZ[2:, 1:-1, 1:-1] - 2.0 * c + QZ[:-2, 1:-1, 1:-1]) * az)

        lap_u = lap(U, UZG)
        lap_v = lap(V, VZG)
        lap_w = lap(Wz[1:nz], Wz)  # the interior z-faces 1 … nz−1

        TE = self._theta_ghost(theta)
        # buoyancy at the interior w z-faces: the cells zf−1 and zf
        th_face = 0.5 * (TE[1:nz, 1:-1, 1:-1] + TE[2:nz + 1, 1:-1, 1:-1])
        u_star = u_t + torch.where(co >= 1, dt * (nu * lap_u - conv_u), 0.0)
        v_star = v_t + torch.where(ro >= 1, dt * (nu * lap_v - conv_v), 0.0)
        w_star = torch.cat([w_t[:1], w_t[1:] + dt * (nu * lap_w - conv_w + buoy * th_face)], 0)
        u_star, v_star, w_star = set_normal(u_star, v_star, w_star)

        # --- the distributed 3D projection, warm-started from the last pressure
        US, VS, WSz = pad(u_star, v_star, w_star, corners=False)
        div_star = ((US[:, 1:-1, 2:] - US[:, 1:-1, 1:-1]) * (1.0 / dx)
                    + (VS[:, 2:, 1:-1] - VS[:, 1:-1, 1:-1]) * (1.0 / dy)
                    + (WSz[1:, 1:-1, 1:-1] - WSz[:-1, 1:-1, 1:-1]) * (1.0 / dz))
        rhs = div_star / dt
        if cfg.poisson.method != "dct":
            rhs = rhs - psum(rhs.sum(), mesh) / self.n_global  # Neumann solvability
        phi = self.poisson(ts.p, rhs)
        PH = halo_exchange_edges(phi, mesh, 1)
        u_new = u_star + torch.where(
            co >= 1, -dt * (PH[:, 1:-1, 1:-1] - PH[:, 1:-1, :-2]) * (1.0 / dx), 0.0)
        v_new = v_star + torch.where(
            ro >= 1, -dt * (PH[:, 1:-1, 1:-1] - PH[:, :-2, 1:-1]) * (1.0 / dy), 0.0)
        w_new = torch.cat([w_star[:1], w_star[1:] + -dt * (phi[1:] - phi[:-1]) * (1.0 / dz)], 0)
        u_new, v_new, w_new = set_normal(u_new, v_new, w_new)

        # --- temperature: finite-volume fluxes of the projected faces
        UN, VN, WNz = pad(u_new, v_new, w_new, corners=False)
        uf = UN[:, 1:-1, 1:]  # x-faces gx0 … gx0+nx_l
        vf = VN[:, 1:, 1:-1]  # y-faces gy0 … gy0+ny_l
        wf = WNz[:, 1:-1, 1:-1]  # z-faces 0 … nz
        lo_x, hi_x = TE[1:-1, 1:-1, :-1], TE[1:-1, 1:-1, 1:]
        lo_y, hi_y = TE[1:-1, :-1, 1:-1], TE[1:-1, 1:, 1:-1]
        lo_z, hi_z = TE[:-1, 1:-1, 1:-1], TE[1:, 1:-1, 1:-1]
        if cfg.theta_scheme == "upwind":
            thx = torch.where(uf >= 0.0, lo_x, hi_x)
            thy = torch.where(vf >= 0.0, lo_y, hi_y)
            thz = torch.where(wf >= 0.0, lo_z, hi_z)
        else:
            thx, thy, thz = 0.5 * (lo_x + hi_x), 0.5 * (lo_y + hi_y), 0.5 * (lo_z + hi_z)
        fx, fy, fz = uf * thx, vf * thy, wf * thz
        adv = ((fx[:, :, 1:] - fx[:, :, :-1]) * (1.0 / dx)
               + (fy[:, 1:, :] - fy[:, :-1, :]) * (1.0 / dy)
               + (fz[1:] - fz[:-1]) * (1.0 / dz))
        lap_t = ((TE[1:-1, 1:-1, 2:] - 2.0 * theta + TE[1:-1, 1:-1, :-2]) * ax
                 + (TE[1:-1, 2:, 1:-1] - 2.0 * theta + TE[1:-1, :-2, 1:-1]) * ay
                 + (TE[2:, 1:-1, 1:-1] - 2.0 * theta + TE[:-2, 1:-1, 1:-1]) * az)
        theta_new = theta + dt * (lap_t - adv)

        new_ts = Boussinesq3DState(u=u_new, v=v_new, w=w_new, p=phi, theta=theta_new,
                                   t=ts.t + dt, step=ts.step + 1)

        # --- the diagnostics of boussinesq3d.make_step, reduced over the mesh
        div_post = ((UN[:, 1:-1, 2:] - UN[:, 1:-1, 1:-1]) * (1.0 / dx)
                    + (VN[:, 2:, 1:-1] - VN[:, 1:-1, 1:-1]) * (1.0 / dy)
                    + (WNz[1:, 1:-1, 1:-1] - WNz[:-1, 1:-1, 1:-1]) * (1.0 / dz))
        d_t = cfg.theta_hot - cfg.theta_cold
        lx = g.x_max - g.x_min
        hot = torch.where(co == 0, 2.0 * (cfg.theta_hot - theta_new) / dx, 0.0).sum()
        TEn = self._theta_ghost(theta_new)
        th_mid = 0.5 * (TEn[1:-1, 1:-1, :-1] + TEn[1:-1, 1:-1, 1:])  # at the x-faces
        dthdx = (TEn[1:-1, 1:-1, 1:] - TEn[1:-1, 1:-1, :-1]) * (1.0 / dx)
        col_sel = co[:, :1, :] == nx // 2
        mid = torch.where(col_sel, uf[:, :, :nx_l] * th_mid[:, :, :nx_l] - dthdx[:, :, :nx_l],
                          0.0).sum()
        ucc = 0.5 * (UN[:, 1:-1, 1:-1] + UN[:, 1:-1, 2:])
        vcc = 0.5 * (VN[:, 1:-1, 1:-1] + VN[:, 2:, 1:-1])
        wcc = 0.5 * (WNz[:-1, 1:-1, 1:-1] + WNz[1:, 1:-1, 1:-1])
        div_max, max_vel, neg_theta_max, theta_max = pmax(torch.stack([
            div_post.abs().amax(),
            torch.maximum(torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                          w_new.abs().amax()),
            (-theta_new).amax(), theta_new.amax()]), mesh).unbind(0)
        energy, hot, mid = psum(torch.stack([(0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)).sum(),
                                             hot, mid]), mesh).unbind(0)
        plane = (g.y_max - g.y_min) * (g.z_max - g.z_min)
        return new_ts, BoussinesqMetrics(
            dt=dt, div_post=div_max, max_vel=max_vel, energy=energy / float(nx * ny * nz),
            nu_hot_wall=hot * lx / (float(nz * ny) * d_t),
            nu_mid=mid * dy * dz * lx / (d_t * plane), theta_min=-neg_theta_max,
            theta_max=theta_max)


def make_heated_cube_explicit_step(cfg: Boussinesq3DConfig, mesh: GridMesh, *,
                                   device=None) -> HeatedCubeExplicitStep:
    """``step(tstate, cfl_scale) -> (tstate, BoussinesqMetrics)`` on this
    rank's trimmed blocks (``trim_boussinesq3d_state`` +
    ``shard_boussinesq3d_state``)."""
    return HeatedCubeExplicitStep(cfg, mesh, device=device)
