"""The 3D compressible Euler step on rank blocks
(``models/compressible3d.py`` made multi-rank; the JAX package runs this
tier on a mesh only through the GSPMD placement of its state).

The conserved state (5, nz, ny, nx) is split over (y, x): each rank holds
(5, nz, ny/py, nx/px), z whole. A forward-Euler stage runs the
single-device ``euler_update`` (the dimension-split z, y and x flux
sweeps, MUSCL faces, floors) on the block's window
(``halo.interior_window``, width 2: the halo lines that the y and x
sweeps' MUSCL faces read, none on the global boundary), with the
interior mask of the window's global cells, so the global one-cell frame
stays the BCs'. One exchange per stage, with the corners. The BC writes
(``cases.py::blast3d``: reflective on all six faces, z, then y, then x,
each from the layer the previous axis wrote, the normal momentum negated)
go on global indices: z on every rank, y and x where a rank holds the
global face, on every line of its window.

The acoustic dt is one ``all_reduce`` MAX over the three sweeps' signal
speeds; the metrics one MAX and one SUM.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.models.compressible import CompressibleMetrics
from cfdsim_tpu_torch.models.compressible3d import (
    Compressible3DConfig,
    Compressible3DState,
    Compressible3DStep,
)
from cfdsim_tpu_torch.parallel.compressible_explicit import window_extent
from cfdsim_tpu_torch.parallel.explicit import step_device
from cfdsim_tpu_torch.parallel.halo import interior_window
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum
from cfdsim_tpu_torch.solvers.riemann import FLUXES_ND, cons_to_prim_nd, sound_speed

WIDTH = 2  # MUSCL reads two cells


class Compressible3DExplicitStep(nn.Module):
    """``step(state_b, cfl_scale) -> (state_b, CompressibleMetrics)`` on this
    rank's (5, nz, ny/py, nx/px) block of the reflective box."""

    reads_host = False
    collectives = True

    def __init__(self, cfg: Compressible3DConfig, mesh: GridMesh, *, device=None):
        super().__init__()
        if cfg.flux not in FLUXES_ND:
            raise ValueError(f"unknown flux {cfg.flux!r}; one of {sorted(FLUXES_ND)}")
        if cfg.reconstruction not in ("none", "muscl"):
            raise ValueError(f"unknown reconstruction {cfg.reconstruction!r}")
        g = cfg.grid
        if g.ny % mesh.py or g.nx % mesh.px:
            raise ValueError(f"grid {g.ny}x{g.nx} not divisible by mesh {mesh.py}x{mesh.px}")
        self.local_shape = (g.ny // mesh.py, g.nx // mesh.px)
        if min(self.local_shape) < WIDTH + 1:
            raise ValueError(f"blocks {self.local_shape} are narrower than the halo and a line")
        self.cfg, self.mesh = cfg, mesh
        self.device = step_device(mesh, device)
        self.flux_fn = FLUXES_ND[cfg.flux]
        self.hs = (g.dz, g.dy, g.dx)
        self.vaxes = (2, 1, 0)
        self.n_global = float(g.nz * g.ny * g.nx)
        ny_l, nx_l = self.local_shape
        r0, r1 = window_extent(ny_l, mesh.iy, mesh.py, WIDTH)
        c0, c1 = window_extent(nx_l, mesh.ix, mesh.px, WIDTH)
        rows, cols = np.arange(r0, r1), np.arange(c0, c1)
        inner = (((rows > 0) & (rows < g.ny - 1))[:, None]
                 & ((cols > 0) & (cols < g.nx - 1))[None, :])
        imask = np.zeros((1, g.nz, r1 - r0, c1 - c0), np.float32)
        imask[:, 1:-1] = inner
        # euler_update's name for the interior mask, here the window's
        self.register_buffer("imask", torch.from_numpy(imask).to(self.device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=self.device))

    euler_update = Compressible3DStep.euler_update

    def _bc(self, U):
        """Reflective faces on global indices (a new tensor): z, then y,
        then x, each copying the adjacent layer and negating the normal
        momentum."""
        mesh = self.mesh
        U = U.clone()
        holds = {1: (True, True), 2: (mesh.iy == 0, mesh.iy == mesh.py - 1),
                 3: (mesh.ix == 0, mesh.ix == mesh.px - 1)}
        for arr_axis, mom in ((1, 3), (2, 2), (3, 1)):  # z, y, x → ρw, ρv, ρu
            n_ax = U.shape[arr_axis]
            for held, (dst, src) in zip(holds[arr_axis], ((0, 1), (n_ax - 1, n_ax - 2))):
                if held:
                    U.select(arr_axis, dst).copy_(U.select(arr_axis, src))
                    U[mom].select(arr_axis - 1, dst).neg_()
        return U

    def _stage_window(self, U_b):
        win, off = interior_window(U_b, self.mesh, WIDTH)
        return self._bc(win), off

    def _crop(self, win, off):
        (oy, ox), (ny_l, nx_l) = off, self.local_shape
        return win[..., oy:oy + ny_l, ox:ox + nx_l]

    def _dt(self, U_b, cfl_scale):
        cfg, g = self.cfg, self.cfg.grid
        rho, vels, p = cons_to_prim_nd(U_b, cfg.gamma, cfg.eps, cfg.max_val)
        a = sound_speed(rho, p, cfg.gamma, cfg.eps)
        s = pmax(torch.stack([(vel.abs() + a).amax() for vel in vels]), self.mesh)
        dt = None
        for h, si in zip((g.dx, g.dy, g.dz), s.clamp(max=cfg.max_val).unbind(0)):
            d = h / si.clamp(min=cfg.eps)
            dt = d if dt is None else torch.minimum(dt, d)
        return (cfg.cfl * cfl_scale * dt).to(torch.float32)

    def forward(self, state: Compressible3DState, cfl_scale):
        cfg = self.cfg
        if state.U.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {state.U.device}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        win, off = self._stage_window(state.U)
        U = self._crop(win, off)
        dt = self._dt(U, cfl_scale)
        if cfg.time_order == 2:
            win1, off1 = self._stage_window(self._crop(self.euler_update(win, dt), off))
            U_new = 0.5 * U + 0.5 * self._crop(self.euler_update(win1, dt), off1)
        else:
            U_new = self._crop(self.euler_update(win, dt), off)
        U_new = self._bc(U_new).contiguous()
        new_state = Compressible3DState(U=U_new, t=state.t + dt, step=state.step + 1)
        if not cfg.compute_metrics:
            z = self.zero
            return new_state, CompressibleMetrics(dt, z, z, z, z, z)
        rho, vels, p = cons_to_prim_nd(U_new, cfg.gamma, cfg.eps, cfg.max_val)
        a = sound_speed(rho, p, cfg.gamma, cfg.eps)
        vel = sum(w * w for w in vels).sqrt()
        maxima = pmax(torch.stack([vel.amax(), -U_new[0].amin(), -p.amin(),
                                   (vel / a).amax()]), self.mesh)
        energy = psum((0.5 * rho * vel * vel).sum(), self.mesh) / self.n_global
        return new_state, CompressibleMetrics(
            dt=dt, max_vel=maxima[0], min_rho=-maxima[1], min_p=-maxima[2], energy=energy,
            max_mach=maxima[3])


def make_blast3d_explicit_step(cfg: Compressible3DConfig, mesh: GridMesh, *,
                               device=None) -> Compressible3DExplicitStep:
    """The explicit-communication step of ``cases.py::blast3d`` (the closed
    reflective box) on this rank's blocks."""
    return Compressible3DExplicitStep(cfg, mesh, device=device)
