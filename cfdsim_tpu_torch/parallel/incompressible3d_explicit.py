"""The collocated 3D Navier–Stokes step on rank blocks, with a distributed 3D
Poisson solve (``models/incompressible3d.py`` and ``solvers/poisson3d.py``
made multi-rank; the JAX package runs this tier on a mesh only through
GSPMD).

Each rank holds (nz, ny/py, nx/px) blocks of u, v, w and p: z whole, y and
x cut (the ``cavity3d`` layout of the 3D MAC tier). The upwind convection,
the Laplacian, the divergence and the gradient are the single-device
operators on the block padded by one halo line in y and x
(``halo_exchange_edges``: the 7-point operators read no corner), cropped,
with the global frame zeroed by a global-index mask (z's frame is the
operators' own). The lid-cavity BCs write the global faces a rank holds.
The adaptive dt and the metrics' maxima are one ``all_reduce`` MAX each
step, the rhs mean and the energy one SUM each.

The pressure (:class:`DistributedPoisson3D`), every method of
``Poisson3DSolver``:

- ``"mg"`` (the case default, two V-cycles): the red-black sweeps of every
  level with one edge exchange per colour (global parity), the residual
  with one; restriction 2×2×2 on the block while the next level's block
  stays at least two cells in y and x; prolongation with one exchange (the
  corners too: the trilinear (¾, ¼) stencil reads diagonal neighbours),
  clamped at the global faces. Below that the residual is gathered (one
  ``all_gather``), so every rank holds the level whole, restricts it and
  runs the remaining levels replicated with the single-device V-cycle, and
  prolongs back to its block;
- ``"dct"``: the exact 3D pencil DCT (``transforms.dct_poisson3d_local``);
- ``"rbsor"``: distributed 3D red-black SOR, one exchange per colour.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.models.incompressible3d import (
    Incompressible3DConfig,
    Incompressible3DState,
    Step3DMetrics,
    convection3_upwind,
    divergence3,
    gradient3,
    laplacian3,
)
from cfdsim_tpu_torch.parallel.explicit import step_device
from cfdsim_tpu_torch.parallel.halo import (
    clamp_global_edges,
    global_indices,
    global_interior_mask,
    halo_exchange,
    halo_exchange_edges,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, gather_blocks, pmax, psum
from cfdsim_tpu_torch.parallel.transforms import dct_poisson3d_local
from cfdsim_tpu_torch.solvers.poisson3d import (
    METHODS_3D,
    Poisson3DConfig,
    Poisson3DSolver,
    _level_shapes,
    _prolong,
    _restrict,
)


def _parity3d(nz: int, local_shape, mesh: GridMesh) -> torch.Tensor:
    """(z + y + x) % 2 == 0 on global indices for a (nz, ny_l, nx_l) block."""
    rows, cols = global_indices(local_shape, mesh)
    z = torch.arange(nz, dtype=torch.int32, device=mesh.device)[:, None, None]
    return ((z + rows[None] + cols[None]) % 2) == 0


class DistributedPoisson3D(nn.Module):
    """``solve(phi0_b, rhs_b) -> φ_b``: ∇²φ = rhs on the global (nz, ny, nx)
    grid, clamped-edge Neumann, on this rank's (nz, ny/py, nx/px) blocks;
    the methods and parameters of :class:`Poisson3DSolver` (see the module
    docstring for the layout of each)."""

    def __init__(self, shape, dx: float, dy: float, dz: float, cfg: Poisson3DConfig,
                 mesh: GridMesh):
        super().__init__()
        if cfg.method not in METHODS_3D:
            raise ValueError(f"unknown 3D poisson method {cfg.method!r}")
        nz, ny, nx = shape
        if ny % mesh.py or nx % mesh.px:
            raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
        self.cfg, self.mesh, self.d = cfg, mesh, (dx, dy, dz)
        self.local_shape = (nz, ny // mesh.py, nx // mesh.px)
        self.n_dist = 0
        if cfg.method == "dct":
            return
        shapes = _level_shapes(shape, cfg.mg_min_size) if cfg.method == "mg" else [shape]
        self.n_levels = len(shapes)
        # the levels whose blocks stay whole cells, at least two in y and x
        for s in shapes:
            if s[1] % mesh.py or s[2] % mesh.px or s[1] // mesh.py < 2 or s[2] // mesh.px < 2:
                break
            red = _parity3d(s[0], (s[1] // mesh.py, s[2] // mesh.px), mesh)
            self.register_buffer(f"red{self.n_dist}", red)
            self.register_buffer(f"black{self.n_dist}", ~red)
            self.n_dist += 1
        if self.n_dist == 0:
            raise ValueError(f"blocks of {self.local_shape} are too small for the distributed "
                             "solve")
        self.coarse = None
        if self.n_dist < self.n_levels:
            # the levels below run replicated: the single-device V-cycle from
            # the first of them on (its hierarchy is the global one's tail)
            f = 2.0 ** self.n_dist
            self.coarse = Poisson3DSolver(shapes[self.n_dist], f * dx, f * dy, f * dz, cfg,
                                          device=mesh.device)

    def _nb_sum(self, phi, ax: float, ay: float, az: float):
        """``poisson3d._nb_sum`` on a block: clamped global faces in y and x
        through one edge exchange, z clamped locally."""
        p = clamp_global_edges(halo_exchange_edges(phi, self.mesh, 1), self.mesh, 1)
        zm = torch.cat([phi[:1], phi[:-1]], 0)
        zp = torch.cat([phi[1:], phi[-1:]], 0)
        return (ax * (p[:, 1:-1, 2:] + p[:, 1:-1, :-2])
                + ay * (p[:, 2:, 1:-1] + p[:, :-2, 1:-1])
                + az * (zp + zm))

    def lap(self, phi, d):
        dx, dy, dz = d
        ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
        return self._nb_sum(phi, ax, ay, az) - 2.0 * (ax + ay + az) * phi

    def _sweep(self, phi, rhs, d, level: int, omega: float):
        dx, dy, dz = d
        ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
        denom_inv = 1.0 / (2.0 * (ax + ay + az))
        for color in (self.get_buffer(f"red{level}"), self.get_buffer(f"black{level}")):
            star = (self._nb_sum(phi, ax, ay, az) - rhs) * denom_inv
            phi = torch.where(color, (1.0 - omega) * phi + omega * star, phi)
        return phi

    def _prolong_local(self, e):
        """``poisson3d._prolong`` of a block, its y and x neighbours from one
        exchange with the corners, clamped at the global faces."""
        p = clamp_global_edges(halo_exchange(e, self.mesh, 1), self.mesh, 1)
        f = _prolong(p)
        return f[:, 2:2 + 2 * e.shape[1], 2:2 + 2 * e.shape[2]]

    def _block(self, full):
        """This rank's block of a replicated level."""
        ny_l, nx_l = full.shape[1] // self.mesh.py, full.shape[2] // self.mesh.px
        iy, ix = self.mesh.iy, self.mesh.ix
        return full[:, iy * ny_l:(iy + 1) * ny_l, ix * nx_l:(ix + 1) * nx_l]

    def _vcycle(self, phi, rhs, d, level: int):
        cfg = self.cfg
        for _ in range(cfg.mg_pre):
            phi = self._sweep(phi, rhs, d, level, 1.0)
        if level == self.n_levels - 1:
            for _ in range(cfg.mg_coarse):
                phi = self._sweep(phi, rhs, d, level, 1.0)
            return phi
        r = rhs - self.lap(phi, d)
        d2 = tuple(2 * h for h in d)
        if level + 1 < self.n_dist:
            r_c = _restrict(r)
            e = self._prolong_local(self._vcycle(torch.zeros_like(r_c), r_c, d2, level + 1))
        else:
            # the next level's blocks would fall below two cells: gather this
            # level whole and run the rest replicated
            r_c = _restrict(gather_blocks(r, self.mesh))
            e_c = self.coarse._vcycle(torch.zeros_like(r_c), r_c, d2, 0)
            e = self._block(_prolong(e_c))
        phi = phi + e
        for _ in range(cfg.mg_post):
            phi = self._sweep(phi, rhs, d, level, 1.0)
        return phi

    def forward(self, phi0, rhs):
        cfg = self.cfg
        if tuple(rhs.shape) != self.local_shape:
            raise ValueError(f"solver built for blocks {self.local_shape}, rhs "
                             f"{tuple(rhs.shape)}")
        if cfg.method == "dct":
            return dct_poisson3d_local(rhs, *self.d, self.mesh)
        phi = phi0
        if cfg.method == "mg":
            for _ in range(cfg.iters):
                phi = self._vcycle(phi, rhs, self.d, 0)
            return phi
        for _ in range(cfg.iters):
            phi = self._sweep(phi, rhs, self.d, 0, cfg.omega)
        return phi


class Incompressible3DExplicitStep(nn.Module):
    """``step(state_b, cfl_scale) -> (state_b, Step3DMetrics)`` on this
    rank's blocks of the 3D lid-driven cavity (the lid at z_hi moving in
    +x)."""

    reads_host = False
    collectives = True

    def __init__(self, cfg: Incompressible3DConfig, mesh: GridMesh, lid_velocity: float = 1.0,
                 *, device=None):
        super().__init__()
        g = cfg.grid
        self.cfg, self.mesh, self.lid = cfg, mesh, lid_velocity
        self.device = step_device(mesh, device)
        self.poisson = DistributedPoisson3D(g.shape, g.dx, g.dy, g.dz, cfg.poisson, mesh)
        nz, ny_l, nx_l = self.poisson.local_shape
        if ny_l < 2 or nx_l < 2:
            raise ValueError(f"blocks of {(ny_l, nx_l)} in y, x: at least 2 each")
        self.n_global = float(g.nz * g.ny * g.nx)
        self.register_buffer("frame1", global_interior_mask((ny_l, nx_l), mesh, 1)[None])
        frame2 = global_interior_mask((ny_l, nx_l), mesh, 2)[None].expand(nz, -1, -1).clone()
        frame2[:2] = False
        frame2[-2:] = False
        self.register_buffer("frame2", frame2)

    def _ops(self, fn, fields):
        """``fn`` (single-device, zero frame) on the stacked blocks padded by
        one edge-exchanged line in y and x; cropped, the global frame
        zeroed. ``fn(*padded) -> tuple``."""
        padded = halo_exchange_edges(torch.stack(fields), self.mesh, 1)
        out = fn(*padded.unbind(0))
        return tuple(torch.where(self.frame1, o[:, 1:-1, 1:-1], 0.0) for o in out)

    def _bc(self, u, v, w):
        """``models/incompressible3d.py::lid_cavity3d_bcs`` on the global
        faces this rank holds (in place on the step's own tensors)."""
        mesh = self.mesh
        for q in (u, v, w):
            q[0] = 0.0
            if mesh.iy == 0:
                q[:, 0, :] = 0.0
            if mesh.iy == mesh.py - 1:
                q[:, -1, :] = 0.0
            if mesh.ix == 0:
                q[:, :, 0] = 0.0
            if mesh.ix == mesh.px - 1:
                q[:, :, -1] = 0.0
        u[-1] = self.lid
        v[-1] = 0.0
        w[-1] = 0.0
        return u, v, w

    def forward(self, state: Incompressible3DState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        mesh = self.mesh
        if state.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {state.u.device}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        u, v, w = state.u, state.v, state.w
        h = min(dx, dy, dz)
        vel_max = pmax(torch.maximum(u.abs(), torch.maximum(v.abs(), w.abs())).amax(),
                       mesh).clamp(min=1e-10)
        dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
        dt = dt_cfl.clamp(max=0.15 * h * h / cfg.nu).clamp(cfg.dt_min, cfg.dt_max)

        def predictor_terms(pu, pv, pw):
            return tuple(cfg.nu * laplacian3(q, dx, dy, dz)
                         - convection3_upwind(pu, pv, pw, q, dx, dy, dz) for q in (pu, pv, pw))

        terms = self._ops(predictor_terms, (u, v, w))
        u_s, v_s, w_s = self._bc(*(q + dt * t for q, t in zip((u, v, w), terms)))

        (div,) = self._ops(lambda a, b, c: (divergence3(a, b, c, dx, dy, dz),),
                           (u_s, v_s, w_s))
        rhs = div / dt
        rhs = rhs - psum(rhs.sum(), mesh) / self.n_global
        phi = self.poisson(state.p, rhs)
        gx, gy, gz = self._ops(lambda a: gradient3(a, dx, dy, dz), (phi,))
        u_n, v_n, w_n = self._bc(u_s - dt * gx, v_s - dt * gy, w_s - dt * gz)
        u_n = u_n.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_n = v_n.clamp(-cfg.max_velocity, cfg.max_velocity)
        w_n = w_n.clamp(-cfg.max_velocity, cfg.max_velocity)
        new_state = Incompressible3DState(u=u_n, v=v_n, w=w_n, p=phi, t=state.t + dt,
                                          step=state.step + 1)
        if not cfg.compute_metrics:
            z = torch.zeros((), dtype=torch.float32, device=u.device)
            return new_state, Step3DMetrics(dt, z, z, z, z, z)
        (div_post,) = self._ops(lambda a, b, c: (divergence3(a, b, c, dx, dy, dz),),
                                (u_n, v_n, w_n))
        res = (self.poisson.lap(phi, (dx, dy, dz)) - rhs).abs().amax()
        maxima = pmax(torch.stack([div.abs().amax(),
                                   torch.where(self.frame2, div_post.abs(), 0.0).amax(), res]),
                      mesh)
        energy = psum((0.5 * (u_n**2 + v_n**2 + w_n**2)).sum(), mesh) / self.n_global
        return new_state, Step3DMetrics(dt=dt, div_pre=maxima[0], div_post=maxima[1],
                                         max_vel=vel_max, energy=energy, poisson_res=maxima[2])


def make_cavity3d_explicit_step(cfg: Incompressible3DConfig, mesh: GridMesh,
                                lid_velocity: float = 1.0, *,
                                device=None) -> Incompressible3DExplicitStep:
    """The explicit-communication step of ``cases.py::cavity3d`` on this
    rank's (nz, ny/py, nx/px) blocks, any 3D Poisson method."""
    return Incompressible3DExplicitStep(cfg, mesh, lid_velocity, device=device)
