"""The 2D Boussinesq step on rank blocks (``cfdsim_tpu.parallel.boussinesq_explicit``):
the side-heated cavity and the bottom-heated Rayleigh–Bénard orientation.

The MAC faces ride the trimmed blocks of ``parallel/mac_explicit.py``
(width-2 halos, masked-write no-slip BCs, the exact pencil DCT projection)
and the cell-centred temperature rides width-1 halos, its Dirichlet and
adiabatic ghosts written by global-index masks. Buoyancy, the conservative
finite-volume θ advection and the Nusselt numbers follow
``models/boussinesq.py`` term for term.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.models.boussinesq import (
    BoussinesqConfig,
    BoussinesqMetrics,
    BoussinesqState,
)
from cfdsim_tpu_torch.parallel.explicit import check_divisible, step_device
from cfdsim_tpu_torch.parallel.halo import global_indices, halo_exchange, halo_exchange_edges
from cfdsim_tpu_torch.parallel.mac_explicit import (
    _advect_local,
    _laplacians,
    cavity_mac_local_bcs,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, block_state, pmax, psum
from cfdsim_tpu_torch.parallel.transforms import dct_inv_eigenvalues_local, dct_poisson_local


def trim_boussinesq_state(state: BoussinesqState) -> BoussinesqState:
    """Drop the last boundary face of u and v (every field (ny, nx))."""
    return state._replace(u=state.u[:, :-1], v=state.v[:-1, :])


def untrim_boussinesq_state(tstate: BoussinesqState) -> BoussinesqState:
    """The closed no-slip box: every dropped boundary face is zero."""
    return tstate._replace(u=F.pad(tstate.u, (0, 1)), v=F.pad(tstate.v, (0, 0, 0, 1)))


def shard_boussinesq_state(tstate: BoussinesqState, mesh: GridMesh) -> BoussinesqState:
    """This rank's blocks of a trimmed Boussinesq state."""
    return block_state(tstate, mesh)


class HeatedCavityExplicitStep(nn.Module):
    """``step(tstate, cfl_scale) -> (tstate, BoussinesqMetrics)`` on this
    rank's trimmed blocks; see :func:`make_heated_cavity_explicit_step`."""

    def __init__(self, cfg: BoussinesqConfig, mesh: GridMesh, *, device=None):
        super().__init__()
        g = cfg.grid
        self.local_shape = check_divisible(g, mesh, min_block=4)
        if cfg.poisson.method != "dct":
            raise ValueError("explicit heated-cavity step supports poisson 'dct'")
        if cfg.heated_axis not in ("x", "y"):
            raise ValueError(f"unknown heated_axis {cfg.heated_axis!r}")
        if cfg.theta_scheme not in ("central", "upwind"):
            raise ValueError(f"unknown theta_scheme {cfg.theta_scheme!r}")
        self.cfg, self.mesh = cfg, mesh
        self.device = step_device(mesh, device)
        self.reads_host = False
        self.collectives = True
        self.bcs = cavity_mac_local_bcs(g.ny, g.nx, lid_velocity=0.0)
        for w in (0, 1, 2):
            gr, gc = global_indices(self.local_shape, mesh, w)
            self.register_buffer(f"gr{w}", gr.contiguous())
            self.register_buffer(f"gc{w}", gc.contiguous())
        self.register_buffer("ilam", dct_inv_eigenvalues_local(self.local_shape, g.dx, g.dy,
                                                               mesh))
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=self.device))

    def _theta_ghost(self, th):
        """Width-1 padded θ with its ghosts written by global-index masks
        (``boussinesq._theta_ghost`` on blocks): Dirichlet on the heated pair
        of walls, adiabatic on the other."""
        cfg = self.cfg
        ny, nx = cfg.grid.ny, cfg.grid.nx
        te = halo_exchange(th, self.mesh, 1)
        gr, gc = self.gr1, self.gc1
        right = torch.roll(te, -1, 1)
        left = torch.roll(te, 1, 1)
        below = torch.roll(te, -1, 0)
        above = torch.roll(te, 1, 0)
        if cfg.heated_axis == "x":
            te = torch.where(gc == -1, 2.0 * cfg.theta_hot - right, te)
            te = torch.where(gc == nx, 2.0 * cfg.theta_cold - left, te)
            below = torch.roll(te, -1, 0)
            above = torch.roll(te, 1, 0)
            te = torch.where(gr == -1, below, te)  # adiabatic bottom
            te = torch.where(gr == ny, above, te)  # adiabatic top
        else:  # heated from below (Rayleigh–Bénard)
            te = torch.where(gr == -1, 2.0 * cfg.theta_hot - below, te)
            te = torch.where(gr == ny, 2.0 * cfg.theta_cold - above, te)
            right = torch.roll(te, -1, 1)
            left = torch.roll(te, 1, 1)
            te = torch.where(gc == -1, right, te)  # adiabatic left
            te = torch.where(gc == nx, left, te)  # adiabatic right
        return te

    def forward(self, ts: BoussinesqState, cfl_scale):
        cfg = self.cfg
        mesh = self.mesh
        bcs = self.bcs
        g = cfg.grid
        ny, nx = g.ny, g.nx
        dx, dy = g.dx, g.dy
        nu = cfg.prandtl
        buoy = cfg.rayleigh * cfg.prandtl
        h = min(dx, dy)
        ny_l, nx_l = self.local_shape
        if ts.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {ts.u.device}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        gr0, gc0 = self.gr0, self.gc0

        u_t, v_t = bcs.pre(ts.u, ts.v, gc0, gr0, ts)
        theta = ts.theta

        def pad_faces(u_t, v_t, w: int):
            U, V = halo_exchange(torch.stack([u_t, v_t]), mesh, w).unbind(0)
            gr, gc = getattr(self, f"gr{w}"), getattr(self, f"gc{w}")
            return bcs.post_u(U, gr, gc, ts, ()), bcs.post_v(V, gr, gc, ts, ()), (gr, gc)

        U, V, (grP, gcP) = pad_faces(u_t, v_t, 2)

        if cfg.adaptive_dt:
            real_u = (grP >= 0) & (grP < ny) & (gcP >= 0) & (gcP <= nx)
            real_v = (grP >= 0) & (grP <= ny) & (gcP >= 0) & (gcP < nx)
            vel_max = pmax(torch.maximum(torch.where(real_u, U.abs(), 0.0).amax(),
                                         torch.where(real_v, V.abs(), 0.0).amax()),
                           mesh).clamp(min=1e-10)
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            dt = dt_cfl.clamp(max=0.2 * h * h / max(nu, 1.0)).clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        # --- the momentum predictor, buoyancy at the owned v-faces
        conv_u, conv_v = _advect_local(U, V, grP, gcP, grP, gcP, ny, nx, dx, dy,
                                       cfg.flow_scheme)
        lap_u, lap_v = _laplacians(U, V, 1.0 / (dx * dx), 1.0 / (dy * dy))
        TE = self._theta_ghost(theta)
        # θ at the owned v-faces (gy0+j): cells gy0+j−1, gy0+j → TE rows j, j+1
        th_face = 0.5 * (TE[:-2, 1:-1] + TE[1:-1, 1:-1])
        u_star = u_t + torch.where(gc0 >= 1, dt * (nu * lap_u - conv_u), 0.0)
        v_star = v_t + torch.where(gr0 >= 1, dt * (nu * lap_v - conv_v + buoy * th_face), 0.0)
        u_star, v_star = bcs.pre(u_star, v_star, gc0, gr0, ts)

        # --- the exact distributed projection
        US, VS, _ = pad_faces(u_star, v_star, 1)
        div_star = (US[1:-1, 2:] - US[1:-1, 1:-1]) * (1.0 / dx) + (
            VS[2:, 1:-1] - VS[1:-1, 1:-1]) * (1.0 / dy)
        phi = dct_poisson_local(div_star / dt, dx, dy, mesh, self.ilam)
        PH = halo_exchange_edges(phi, mesh, 1)  # read by 5-point stencils only
        gx = (PH[1:-1, 1:-1] - PH[1:-1, :-2]) * (1.0 / dx)
        gy_ = (PH[1:-1, 1:-1] - PH[:-2, 1:-1]) * (1.0 / dy)
        u_new = u_star - torch.where(gc0 >= 1, dt * gx, 0.0)
        v_new = v_star - torch.where(gr0 >= 1, dt * gy_, 0.0)
        u_new, v_new = bcs.pre(u_new, v_new, gc0, gr0, ts)

        # --- temperature: conservative FV advection by the projected faces
        UN, VN, _ = pad_faces(u_new, v_new, 1)
        uf = UN[1:-1, 1:]  # (ny_l, nx_l+1): faces gx0 … gx0+nx_l
        vf = VN[1:, 1:-1]  # (ny_l+1, nx_l): row-faces gy0 … gy0+ny_l
        te_lo_x = TE[1:-1, :-1]  # the cell left of each face
        te_hi_x = TE[1:-1, 1:]
        te_lo_y = TE[:-1, 1:-1]
        te_hi_y = TE[1:, 1:-1]
        if cfg.theta_scheme == "upwind":
            thx = torch.where(uf >= 0.0, te_lo_x, te_hi_x)
            thy = torch.where(vf >= 0.0, te_lo_y, te_hi_y)
        else:
            thx = 0.5 * (te_lo_x + te_hi_x)
            thy = 0.5 * (te_lo_y + te_hi_y)
        fx_ = uf * thx
        fy_ = vf * thy
        adv = (fx_[:, 1:] - fx_[:, :-1]) * (1.0 / dx) + (fy_[1:, :] - fy_[:-1, :]) * (1.0 / dy)
        lap_t = (TE[1:-1, 2:] - 2.0 * theta + TE[1:-1, :-2]) * (1.0 / dx**2) + (
            TE[2:, 1:-1] - 2.0 * theta + TE[:-2, 1:-1]) * (1.0 / dy**2)
        theta_new = theta + dt * (lap_t - adv)

        new_ts = BoussinesqState(u=u_new, v=v_new, p=phi, theta=theta_new, t=ts.t + dt,
                                 step=ts.step + 1)

        # --- the diagnostics of boussinesq.make_step, reduced over the mesh
        div_post = (UN[1:-1, 2:] - UN[1:-1, 1:-1]) * (1.0 / dx) + (
            VN[2:, 1:-1] - VN[1:-1, 1:-1]) * (1.0 / dy)
        d_t = cfg.theta_hot - cfg.theta_cold
        lx = g.x_max - g.x_min
        ly = g.y_max - g.y_min
        TEn = self._theta_ghost(theta_new)
        if cfg.heated_axis == "x":
            hot = torch.where(gc0 == 0, 2.0 * (cfg.theta_hot - theta_new) / dx, 0.0).sum()
            th_mid = 0.5 * (TEn[1:-1, :-1] + TEn[1:-1, 1:])  # at the faces
            dthdx = (TEn[1:-1, 1:] - TEn[1:-1, :-1]) * (1.0 / dx)
            col_sel = (gc0[0, :] == nx // 2)[None, :]
            mid = torch.where(col_sel, uf[:, :nx_l] * th_mid[:, :nx_l] - dthdx[:, :nx_l],
                              0.0).sum()
        else:
            hot = torch.where(gr0 == 0, 2.0 * (cfg.theta_hot - theta_new) / dy, 0.0).sum()
            th_mid = 0.5 * (TEn[:-1, 1:-1] + TEn[1:, 1:-1])  # at the y-faces
            dthdy = (TEn[1:, 1:-1] - TEn[:-1, 1:-1]) * (1.0 / dy)
            row_sel = (gr0[:, 0] == ny // 2)[:, None]
            mid = torch.where(row_sel, vf[:ny_l, :] * th_mid[:ny_l, :] - dthdy[:ny_l, :],
                              0.0).sum()
        ucc = 0.5 * (UN[1:-1, 1:-1] + UN[1:-1, 2:])
        vcc = 0.5 * (VN[1:-1, 1:-1] + VN[2:, 1:-1])
        div_max, max_vel, neg_theta_max, theta_max = pmax(torch.stack([
            div_post.abs().amax(),
            torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            (-theta_new).amax(),
            theta_new.amax(),
        ]), mesh).unbind(0)
        energy, hot, mid = psum(torch.stack([(0.5 * (ucc * ucc + vcc * vcc)).sum(), hot, mid]),
                                mesh).unbind(0)
        if cfg.heated_axis == "x":
            nu_hot = hot * lx / (float(ny) * d_t)
            nu_mid = mid * dy * lx / (d_t * ly)
        else:
            nu_hot = hot * ly / (float(nx) * d_t)
            nu_mid = mid * dx * ly / (d_t * lx)
        return new_ts, BoussinesqMetrics(
            dt=dt, div_post=div_max, max_vel=max_vel, energy=energy / float(ny * nx),
            nu_hot_wall=nu_hot, nu_mid=nu_mid, theta_min=-neg_theta_max, theta_max=theta_max)


def make_heated_cavity_explicit_step(cfg: BoussinesqConfig, mesh: GridMesh, *,
                                     device=None) -> HeatedCavityExplicitStep:
    """``step(tstate, cfl_scale) -> (tstate, BoussinesqMetrics)`` on this
    rank's trimmed blocks (``trim_boussinesq_state`` +
    ``shard_boussinesq_state``)."""
    return HeatedCavityExplicitStep(cfg, mesh, device=device)
