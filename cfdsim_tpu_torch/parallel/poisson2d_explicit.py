"""The 2D pressure-Poisson solve on rank blocks: every method of
``solvers/poisson.py::PoissonSolver`` (``METHODS``) made multi-rank, the 2D
counterpart of ``incompressible3d_explicit.DistributedPoisson3D``.

Each rank holds one (ny/py, nx/px) block of φ and the right-hand side.

- ``"dct"``: the exact clamped-edge solve through the pencil DCT
  (``transforms.dct_poisson_local``);
- ``"fft"``: the periodic solve on the full complex spectrum through the
  pencil FFT2 (``transforms.fft2_pencil``), divided by this rank's block of
  the discrete symbol (the rfft tables' values: the symbol is even in kx);
- ``"jacobi"``, ``"rbsor"``: the distributed sweeps of
  ``sharded.rbsor_local`` (one edge exchange per colour half-sweep), the
  global checkerboard, a Dirichlet frame kept by global index, the solid
  cells frozen by this rank's block of the fluid mask;
- ``tol > 0`` on the sweeps (``jacobi``, ``rbsor``, the windowed
  ``rbsor_pallas``): the early exit, ``max(1, iters // check_every)``
  chunks of ``check_every`` sweeps, each run while the max residual over
  the mesh (one ``all_reduce`` MAX, read on the host: ``reads_host``) after
  the previous chunk is above ``tol``; ``chunks_run`` counts them on the
  device, the count the single-device solve gives;
- ``"hybrid"``: the pencil DCT, then, with a solid mask, the masked
  distributed sweeps that repair φ around the bodies;
- ``"rbsor_pallas"``, unmasked and Neumann: kernel B
  (``ops/kernels/poisson_rb.py::rbsor_blocked``) on a window of the block,
  ``halo.interior_window(φ, mesh, 2K)``. The kernel's K sweeps leave stale
  values only within 2K cells of the window's edge where that edge faces
  another block (one cell further per half-sweep), so the cropped block
  holds exactly K global sweeps; the window's edges on the global boundary
  are the domain's clamped edges. The colours take the window's global
  origin as ``parity0``. One exchange with corners per K sweeps (the
  right-hand side's window once per solve) where ``rbsor_local`` takes two
  exchanges per sweep. K is :data:`SWEEPS_PER_PASS` clipped when the solver
  is built, so that 2K never exceeds a neighbour's block (a halo takes its
  lines from one neighbour) and the kernel's staging stays in one TMA box
  (:data:`MAX_PASS_SWEEPS`); any K gives ``iters`` global sweeps;
- ``"rbsor_pallas"``, masked or with a Dirichlet frame: kernel A
  (``ops/kernels/poisson_rb.py::rbsor``), which runs a whole grid inside
  one launch and takes no halo, on the whole grid on every rank, as JAX's
  GSPMD runs the ``pallas_call``: φ, the right-hand side and the solid mask
  gathered once per solve (one ``all_gather``, none at world size 1), the
  solve with the single-device call's ``tol``, ``check_every`` and
  ``chunks_run`` (the early exit decided on the device), and this rank's
  block cut back out;
- ``"mg"``: the V-cycle of ``PoissonSolver`` on the blocks: the red-black
  smoother, the residual (one edge exchange, clamped global edges), the
  2×2 restriction on the block and the prolongation from a block padded by
  one line with corners. A level is kept on the blocks while its blocks
  keep at least 2K cells a side, K the smoother's sweeps per pass; the
  coarsest level always runs replicated (its ``mg_coarse`` sweeps on a few
  cells would cost an exchange each K sweeps). Below the last distributed
  level the residual is gathered once (one ``all_gather``), and every rank
  restricts it and runs the remaining levels with the single-device
  ``PoissonSolver`` V-cycle (its smoother routes as on one device), then
  prolongs back to its block. The smoother follows ``mg_pallas_smooth``:
  True or "auto", kernel B on windows with K = ``mg_pre``/``mg_post``
  (on a CPU tensor the kernel's plain twin, with the same windows and
  parities); False, ``rbsor_local``.

At world size 1 the window is the whole grid with ``parity0`` = 0, so the
kernel path launches kernel B where the single-device solve launches A or B
(the two give the same bits), and the masked or Dirichlet path launches
kernel A exactly as the single-device solve does.
"""

from __future__ import annotations

import torch
from torch import nn

from cfdsim_tpu_torch.ops.kernels import poisson_rb
from cfdsim_tpu_torch.parallel.halo import (
    clamp_global_edges,
    global_indices,
    global_interior_mask,
    halo_exchange,
    halo_exchange_edges,
    interior_window,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, gather_blocks, local_block, pmax
from cfdsim_tpu_torch.parallel.sharded import rbsor_local, sweep_colours
from cfdsim_tpu_torch.parallel.transforms import (
    _check_pencil,
    dct_inv_eigenvalues_local,
    dct_poisson_local,
    fft2_pencil,
)
from cfdsim_tpu_torch.solvers.poisson import (
    PoissonConfig,
    PoissonSolver,
    _mg_level_shapes,
    _prolong,
    _restrict,
    check_ported,
)

# kernel B's sweeps per pass for rbsor_pallas: ``rbsor_blocked``'s default,
# the K of the single-device solve
SWEEPS_PER_PASS = 8
# the most sweeps a pass of kernel B stages: a 128-column tile with a 2K
# halo of 4·⌈2K/4⌉ columns a side fits one 256-wide TMA box up to K = 32
MAX_PASS_SWEEPS = 32


class DistributedPoisson2D(nn.Module):
    """``solve(phi0_b, rhs_b[, fluid_b]) -> φ_b``: ∇²φ = rhs on the global
    (ny, nx) grid by ``cfg`` (a :class:`PoissonConfig`), on this rank's
    blocks; see the module docstring for each method's layout. ``masked``
    says that the solve takes this rank's block of the fluid mask (True in
    the fluid) at call time, as the single-device solver takes a solid
    mask; the direct methods ignore it, as there. ``reads_host``: whether a
    solve waits for the host (the early exit)."""

    def __init__(self, shape, dx: float, dy: float, cfg: PoissonConfig, mesh: GridMesh,
                 masked: bool = False):
        super().__init__()
        check_ported(cfg)
        ny, nx = shape
        if ny % mesh.py or nx % mesh.px:
            raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
        method = cfg.method
        if method == "mg" and masked:
            raise ValueError("multigrid is unmasked; use rbsor for masks")
        self.cfg, self.mesh, self.d = cfg, mesh, (dx, dy)
        self.local_shape = (ny // mesh.py, nx // mesh.px)
        self.masked = masked and method not in ("dct", "fft")
        # kernel B on windows: unmasked Neumann rbsor_pallas, the MG smoother;
        # kernel A on the gathered grid: the other rbsor_pallas solves
        self.windowed = (method == "rbsor_pallas" and not self.masked and cfg.bc == "neumann")
        self.gathered = method == "rbsor_pallas" and not self.windowed
        self.reads_host = cfg.tol > 0.0 and (method in ("jacobi", "rbsor") or self.windowed)
        self.register_buffer("chunks_run", torch.zeros((), dtype=torch.int32,
                                                       device=mesh.device))
        self.register_buffer("ilam", dct_inv_eigenvalues_local(self.local_shape, dx, dy, mesh)
                             if method in ("dct", "hybrid") else None)
        self.register_buffer("lam", self._periodic_symbol(shape, dx, dy)
                             if method == "fft" else None)
        # the sweeps of jacobi/rbsor and the hybrid repair
        red, black = sweep_colours(self.local_shape, mesh)
        if cfg.bc == "dirichlet":
            frame = global_interior_mask(self.local_shape, mesh, 1)
            red, black = red & frame, black & frame
        self.register_buffer("red", red)
        self.register_buffer("black", black)
        if method == "mg":
            self._build_mg(shape, dx, dy)
        elif self.windowed:
            self.k = self._pass_sweeps(self.local_shape, min(SWEEPS_PER_PASS, cfg.iters))

    def _periodic_symbol(self, shape, dx: float, dy: float):
        """This rank's block of the 5-point periodic symbol on the full
        spectrum, ``poisson._periodic_eigenvalues``' float32 expression at
        fftfreq's kx (cos is even: the rfft columns' values), 1 at k = 0."""
        ny, nx = shape
        dev = self.mesh.device
        rows, cols = global_indices(self.local_shape, self.mesh)
        kx = torch.fft.fftfreq(nx, device=dev)[cols[0].long()]
        ky = torch.fft.fftfreq(ny, device=dev)[rows[:, 0].long()]
        lam = (2.0 * torch.cos(2.0 * torch.pi * kx)[None, :] - 2.0) / (dx * dx) + (
            2.0 * torch.cos(2.0 * torch.pi * ky)[:, None] - 2.0) / (dy * dy)
        return torch.where((rows == 0) & (cols == 0), 1.0, lam)

    def _pass_sweeps(self, local_shape, want: int) -> int:
        """K for windows of blocks of ``local_shape``: ``want`` clipped so
        that 2K lines fit in a neighbour's block along every mesh axis with
        more than one block, and at :data:`MAX_PASS_SWEEPS`."""
        k = min(max(int(want), 1), MAX_PASS_SWEEPS)
        for n, axis in zip(local_shape, ("y", "x")):
            if self.mesh.axis_size(axis) > 1:
                k = min(k, n // 2)
        if k < 1:
            raise ValueError(f"blocks of {tuple(local_shape)} are too small for a window of "
                             "kernel B (at least 2 cells a side facing a neighbour)")
        return k

    def _build_mg(self, shape, dx: float, dy: float):
        cfg, mesh = self.cfg, self.mesh
        shapes = _mg_level_shapes(shape, cfg.mg_min_size)
        self.n_levels = len(shapes)
        flag = cfg.mg_pallas_smooth
        self.mg_windows = flag is True or flag == "auto"
        k_want = max(cfg.mg_pre, cfg.mg_post, cfg.mg_coarse if self.n_levels == 1 else 0)
        # level 0 is the blocks; a coarser level stays on them while its
        # blocks keep 2K cells a side, never the coarsest (replicated)
        self.level_k, self.level_shapes = [], []
        for level, s in enumerate(shapes):
            local = (s[0] // mesh.py, s[1] // mesh.px)
            if level > 0 and (level == self.n_levels - 1 or s[0] % mesh.py or s[1] % mesh.px
                              or min(local) < 2 * min(k_want, MAX_PASS_SWEEPS)):
                break
            self.level_k.append(self._pass_sweeps(local, k_want) if self.mg_windows else 0)
            self.level_shapes.append(local)
            red, black = sweep_colours(local, mesh)
            self.register_buffer(f"red{level}", red)
            self.register_buffer(f"black{level}", black)
        self.n_dist = len(self.level_shapes)
        self.coarse = None
        if self.n_dist < self.n_levels:
            f = 2.0 ** self.n_dist
            self.coarse = PoissonSolver(shapes[self.n_dist], f * dx, f * dy, cfg,
                                        device=mesh.device)

    # --- operators on blocks ------------------------------------------------

    def _nb_sum(self, phi, d):
        """ax(E+W) + ay(N+S) of a block, the global edges clamped (one edge
        exchange), in ``poisson.lap_neumann``'s order."""
        ax, ay = 1.0 / (d[0] * d[0]), 1.0 / (d[1] * d[1])
        p = clamp_global_edges(halo_exchange_edges(phi, self.mesh, 1), self.mesh, 1)
        return ax * (p[1:-1, 2:] + p[1:-1, :-2]) + ay * (p[2:, 1:-1] + p[:-2, 1:-1])

    def lap(self, phi, d=None):
        """``poisson.lap_neumann`` on a block."""
        d = self.d if d is None else d
        ax, ay = 1.0 / (d[0] * d[0]), 1.0 / (d[1] * d[1])
        return self._nb_sum(phi, d) - 2.0 * (ax + ay) * phi

    def residual(self, phi, rhs, fluid=None):
        """``poisson.poisson_residual`` over the mesh (one ``all_reduce``
        MAX): |∇²φ − rhs| over the updatable cells, a 0-dim tensor."""
        r = (self.lap(phi) - rhs).abs()
        if self.cfg.bc == "dirichlet":
            r = torch.where(global_interior_mask(self.local_shape, self.mesh, 1), r, 0.0)
        if fluid is not None:
            r = torch.where(fluid, r, 0.0)
        return pmax(r.amax(), self.mesh)

    def _colours(self, fluid, level: int | None = None):
        tag = "" if level is None else str(level)
        red, black = self.get_buffer(f"red{tag}"), self.get_buffer(f"black{tag}")
        if fluid is not None:
            red, black = red & fluid, black & fluid
        return red, black

    def _window(self, q, k: int):
        """(window, (oy, ox), parity0): ``q``'s block padded by 2K lines
        on the sides facing another block; ``parity0`` is the colour parity
        of the window's (0, 0) cell in global indices."""
        win, (oy, ox) = interior_window(q, self.mesh, 2 * k)
        ny_l, nx_l = q.shape
        parity0 = (self.mesh.iy * ny_l - oy + self.mesh.ix * nx_l - ox) & 1
        return win.contiguous(), (oy, ox), parity0

    def _window_sweeps(self, phi, rhs_win, n: int, k: int, omega: float, d):
        """``n`` global red-black sweeps of φ's block by kernel B on windows
        of width 2K, K sweeps a pass (the last pass the remainder)."""
        ny_l, nx_l = phi.shape
        done = 0
        while done < n:
            sweeps = min(k, n - done)
            win, (oy, ox), parity0 = self._window(phi, k)
            out = poisson_rb.rbsor_blocked(win, rhs_win, d[0], d[1], iters=sweeps,
                                           omega=omega, sweeps_per_pass=sweeps, parity0=parity0)
            phi = out[oy:oy + ny_l, ox:ox + nx_l]
            done += sweeps
        return phi

    # --- methods --------------------------------------------------------------

    def _smooth(self, phi, rhs, rhs_win, n: int, level: int, d):
        if n == 0:
            return phi
        if self.mg_windows:
            return self._window_sweeps(phi, rhs_win, n, self.level_k[level], 1.0, d)
        ax, ay = 1.0 / (d[0] * d[0]), 1.0 / (d[1] * d[1])
        return rbsor_local(phi, rhs, self.mesh, ax, ay, n, 1.0,
                           colours=self._colours(None, level))

    def _prolong_local(self, e):
        """``poisson._prolong`` of a block, its neighbours from one exchange
        with the corners (the bilinear stencil reads diagonal cells),
        clamped at the global edges."""
        p = clamp_global_edges(halo_exchange(e, self.mesh, 1), self.mesh, 1)
        return _prolong(p)[2:2 + 2 * e.shape[0], 2:2 + 2 * e.shape[1]]

    def _vcycle(self, phi, rhs, level: int, d):
        cfg = self.cfg
        rhs_win = self._window(rhs, self.level_k[level])[0] if self.mg_windows else None
        phi = self._smooth(phi, rhs, rhs_win, cfg.mg_pre, level, d)
        if level == self.n_levels - 1:
            return self._smooth(phi, rhs, rhs_win, cfg.mg_coarse, level, d)
        # every node is fluid (multigrid is unmasked), as on one device
        r = rhs - self.lap(phi, d)
        d2 = (2 * d[0], 2 * d[1])
        if level + 1 < self.n_dist:
            r_c = _restrict(r)
            e = self._prolong_local(self._vcycle(torch.zeros_like(r_c), r_c, level + 1, d2))
        else:
            # the next level leaves the blocks: gather this level's residual
            # once and run the rest replicated
            r_c = _restrict(gather_blocks(r, self.mesh))
            e_c = self.coarse._vcycle(torch.zeros_like(r_c), r_c, d2[0], d2[1], 0,
                                      self.coarse._use_kernels(r_c))
            ny_l, nx_l = phi.shape
            e = _prolong(e_c)[self.mesh.iy * ny_l:(self.mesh.iy + 1) * ny_l,
                              self.mesh.ix * nx_l:(self.mesh.ix + 1) * nx_l]
        phi = phi + e
        return self._smooth(phi, rhs, rhs_win, cfg.mg_post, level, d)

    def _kernel_a(self, phi, rhs, fluid):
        """The masked or Dirichlet ``rbsor_pallas`` solve: kernel A on the
        whole grid, gathered once (φ, rhs and the solid mask in one
        ``all_gather``), this rank's block cut back out."""
        mesh, cfg = self.mesh, self.cfg
        blocks = [phi, rhs] + ([] if fluid is None else [(~fluid).to(torch.float32)])
        if mesh.size > 1:
            blocks = gather_blocks(torch.stack(blocks), mesh).unbind(0)
        out = poisson_rb.rbsor(blocks[0], blocks[1], *self.d, iters=cfg.iters,
                               omega=cfg.omega, bc=cfg.bc,
                               solid_mask=blocks[2] if fluid is not None else None,
                               tol=cfg.tol, check_every=cfg.check_every,
                               chunks_run=self.chunks_run)
        return out if mesh.size == 1 else local_block(out, mesh)

    def _sweeps(self, phi, rhs, rhs_win, n: int, fluid, omega: float):
        if rhs_win is not None:
            return self._window_sweeps(phi, rhs_win, n, self.k, omega, self.d)
        colours = self._colours(fluid)
        if self.cfg.method == "jacobi":
            colours = (colours[0] | colours[1],)
        ax, ay = 1.0 / (self.d[0] ** 2), 1.0 / (self.d[1] ** 2)
        return rbsor_local(phi, rhs, self.mesh, ax, ay, n, omega, colours=colours)

    def forward(self, phi0, rhs, fluid=None):
        cfg, mesh = self.cfg, self.mesh
        if tuple(rhs.shape) != self.local_shape:
            raise ValueError(f"solver built for blocks {self.local_shape}, rhs "
                             f"{tuple(rhs.shape)}")
        if (fluid is not None) != self.masked and cfg.method not in ("dct", "fft"):
            raise ValueError(f"the solver was built with masked={self.masked}; "
                             f"fluid block {'given' if fluid is not None else 'missing'}")
        if cfg.method in ("dct", "fft"):
            fluid = None  # the direct solves ignore the mask, as on one device
        if cfg.method == "fft":
            _check_pencil(self.local_shape, mesh.py, mesh.px)
            phi_hat = fft2_pencil(rhs.to(torch.complex64), mesh) / self.lam
            rows, cols = global_indices(self.local_shape, mesh)
            phi_hat = torch.where((rows == 0) & (cols == 0), 0.0, phi_hat)
            return fft2_pencil(phi_hat, mesh, inverse=True).real.contiguous().to(rhs.dtype)
        if cfg.method in ("dct", "hybrid"):
            phi = dct_poisson_local(rhs, *self.d, mesh, self.ilam)
            if fluid is None:
                return phi
            phi = torch.where(fluid, phi, 0.0)
            ax, ay = 1.0 / (self.d[0] ** 2), 1.0 / (self.d[1] ** 2)
            return rbsor_local(phi, rhs, mesh, ax, ay, cfg.iters, cfg.omega,
                               colours=self._colours(fluid))
        if cfg.method == "mg":
            phi = phi0
            for _ in range(cfg.iters):
                phi = self._vcycle(phi, rhs, 0, self.d)
            return phi
        if self.gathered:
            return self._kernel_a(phi0, rhs, fluid)
        omega = 1.0 if cfg.method == "jacobi" else cfg.omega
        rhs_win = self._window(rhs, self.k)[0] if self.windowed else None
        if cfg.tol <= 0.0:
            return self._sweeps(phi0, rhs, rhs_win, cfg.iters, fluid, omega)
        check = max(1, cfg.check_every)
        phi = phi0
        for _ in range(max(1, cfg.iters // check)):
            phi = self._sweeps(phi, rhs, rhs_win, check, fluid, omega)
            self.chunks_run += 1
            if not bool(self.residual(phi, rhs, fluid) > cfg.tol):
                break
        return phi
