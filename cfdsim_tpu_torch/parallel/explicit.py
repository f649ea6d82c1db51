"""The collocated Navier–Stokes step on rank blocks, every exchange, boundary
write and reduction placed by hand (``cfdsim_tpu.parallel.explicit``).

Each rank holds one (ny/py, nx/px) block of u, v and p and runs the full
Chorin projection step of ``models/incompressible.py`` on it:

- stencils: a halo exchange per application (``parallel/halo.py``; the
  fields a stencil reads go through one exchange as a stack, of the edges
  only, since every operator here is plus-shaped), the
  single-device op on the padded blocks, the crop, and the zero frame of
  the *global* grid restored by a mask; width-2 halos with clamped global
  edges for the TVD scheme's 5-point faces;
- BCs: edge writes on the ranks that hold a global edge (the mesh
  coordinates decide; no collective is skipped);
- pressure: every method of the single-device solver through
  :class:`~cfdsim_tpu_torch.parallel.poisson2d_explicit.DistributedPoisson2D`
  (the pencil DCT, the cavity's default; distributed red-black SOR, masked
  in solids when ``masked_poisson``, with the ``tol`` early exit; Jacobi;
  the periodic FFT; the DCT + SOR hybrid; multigrid; ``rbsor_pallas``
  through kernel B on windows of the blocks);
- the fused predictor: ``ops/kernels/predictor.py``'s kernel on each
  rank's window ``halo.interior_window(·, mesh, 1)`` (edges only: the
  5-point stencil reads no corner), cropped. The kernel updates its array's
  interior only, so a global edge line passes through unchanged, as on one
  device, and the halo lines it leaves are cropped away;
- reductions (adaptive dt, the rhs mean, the metrics): a local reduction
  and an ``all_reduce`` over the world, the metrics' maxima in one MAX
  and their sums in one SUM (``mesh.pmax``/``mesh.psum``, differentiable).

Option for option the single-device step: bf16 storage (u and v upcast
once, rounded once at the end, the metrics read before the rounding),
every scheme, the fused predictor, every pressure solve, LES, implicit
diffusion (damped Jacobi, or the exact DST Helmholtz through the pencil
transforms, with "auto" falling back to Jacobi where the blocks are not
pencil-splittable), divergence cleanup, IBM damping, the masked Poisson
solve and the full metrics, the IBM body forces included. The step calls
collectives, so :func:`~cfdsim_tpu_torch.models.incompressible.make_chunk`
runs it on the loop route; ``reads_host`` is the solver's (the early
exit reads the residual on the host).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import (
    IncompressibleConfig,
    IncompressibleState,
    StepMetrics,
    _check_config,
)
from cfdsim_tpu_torch.ops.convection import (
    convection_central,
    convection_supg,
    convection_tvd,
    convection_upwind,
    supg_tau_field,
)
from cfdsim_tpu_torch.ops.kernels.predictor import fused_predictor_central
from cfdsim_tpu_torch.ops.les import smagorinsky_viscosity
from cfdsim_tpu_torch.ops.stencil import curl, divergence, gradient, laplacian_coeff
from cfdsim_tpu_torch.parallel.halo import (
    global_interior_mask,
    halo_exchange_edges,
    interior_window,
    sharded_stencil,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum
from cfdsim_tpu_torch.parallel.poisson2d_explicit import DistributedPoisson2D
from cfdsim_tpu_torch.parallel.transforms import dst_helmholtz_local


def step_device(mesh: GridMesh, device=None) -> torch.device:
    """The device a distributed step is built for: ``device`` or the mesh's;
    it must be the mesh's (a NCCL mesh takes CUDA tensors, gloo the CPU's)."""
    device = mesh.device if device is None else torch.device(device)
    mesh.check(torch.empty(0, device=device))
    return device


def check_divisible(grid, mesh: GridMesh, min_block: int = 1):
    """(ny_l, nx_l), raising unless the grid splits evenly into blocks of at
    least ``min_block`` lines per side (a width-w halo takes w lines from a
    neighbour's block)."""
    if grid.ny % mesh.py or grid.nx % mesh.px:
        raise ValueError(f"grid {grid.ny}x{grid.nx} not divisible by mesh {mesh.py}x{mesh.px}")
    ny_l, nx_l = grid.ny // mesh.py, grid.nx // mesh.px
    if ny_l < min_block or nx_l < min_block:
        raise ValueError(f"local blocks must be at least {min_block}x{min_block}; got "
                         f"{ny_l}x{nx_l}")
    return ny_l, nx_l


class ExplicitStep(nn.Module):
    """``step(state, cfl_scale[, ibm_b][, y_b][, fluid_b]) -> (state,
    StepMetrics)`` on this rank's blocks; see :func:`make_explicit_step`."""

    def __init__(self, cfg: IncompressibleConfig, mesh: GridMesh, bc_builder: Callable,
                 use_ibm: bool = False, needs_y: bool = False, *, device=None):
        super().__init__()
        _check_config(cfg)
        if cfg.fused_predictor and (cfg.scheme != "central" or cfg.diffusion != "explicit"
                                    or cfg.use_les):
            raise ValueError("fused_predictor requires scheme='central', explicit diffusion "
                             "and no LES")
        g = cfg.grid
        self.cfg, self.mesh, self.bc_builder = cfg, mesh, bc_builder
        self.use_ibm, self.needs_y = use_ibm, needs_y
        self.device = step_device(mesh, device)
        self.collectives = True
        self.local_shape = check_divisible(g, mesh, min_block=2 if cfg.scheme == "tvd" else 1)
        self.n_global = float(g.nx * g.ny)
        self.poisson = DistributedPoisson2D((g.ny, g.nx), g.dx, g.dy, cfg.poisson, mesh,
                                            masked=cfg.masked_poisson)
        self.reads_host = self.poisson.reads_host
        # the Neumann problem's solvability, as on one device: the direct
        # solvers drop the k = 0 mode in-spectrum, the others take a
        # mean-free rhs
        self.subtract_mean = cfg.poisson.bc == "neumann" and cfg.poisson.method not in (
            "dct", "fft")
        # the distributed DST needs pencil-splittable blocks; "auto" falls
        # back to Jacobi where they are not (an explicit "dst" still raises
        # the pencil error)
        ny_l, nx_l = self.local_shape
        pencil_ok = ny_l % mesh.px == 0 and nx_l % mesh.py == 0
        self.use_dst = cfg.diffusion == "implicit" and (
            cfg.implicit_solver == "dst"
            or (cfg.implicit_solver == "auto" and not cfg.use_les and pencil_ok))
        if self.use_dst and cfg.use_les:
            raise ValueError("implicit_solver='dst' needs scalar viscosity; use 'jacobi' "
                             "with LES")
        self.register_buffer("imask", global_interior_mask(self.local_shape, mesh, 1))
        self.register_buffer("imask2", global_interior_mask(self.local_shape, mesh, 2))
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=self.device))
        self.register_buffer("warmup_dt", torch.tensor(cfg.warmup_dt, dtype=torch.float32,
                                                       device=self.device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=self.device))
        # ν_eff and the viscous dt bound as the single-device step forms them
        nu_total = np.float32(cfg.nu) + np.float32(0.0) + np.float32(cfg.artificial_viscosity)
        self.nu_eff = float(nu_total)
        h = min(g.dx, g.dy)
        self.dt_visc = float(np.float32(0.2 * h * h) / nu_total)
        self.register_buffer("visc_num", torch.tensor(0.2 * h * h, dtype=torch.float32,
                                                      device=self.device))

    def _stencil(self, op, *fields, width: int = 1, clamp: bool = False):
        """:func:`~cfdsim_tpu_torch.parallel.halo.sharded_stencil` on the
        edges only (every operator of the collocated step is plus-shaped, so
        no corner reaches the cropped result); ``clamp`` gives the global
        edges the op's own edge padding (the TVD scheme's limited slopes)."""
        return sharded_stencil(op, fields, self.mesh, width, corners=False, clamp=clamp,
                               mask=self.imask)

    def _neighbour_sum(self, q):
        """ax(E+W) + ay(N+S) of a stack of blocks, zero on the global frame."""
        g = self.cfg.grid
        ax, ay = 1.0 / (g.dx * g.dx), 1.0 / (g.dy * g.dy)
        qp = halo_exchange_edges(q, self.mesh, 1)
        s = ax * (qp[..., 1:-1, 2:] + qp[..., 1:-1, :-2]) + ay * (
            qp[..., 2:, 1:-1] + qp[..., :-2, 1:-1])
        return torch.where(self.imask, s, 0.0)

    def _dt(self, u, v, nu_t, step, cfl_scale):
        cfg = self.cfg
        if not cfg.adaptive_dt:
            return self.dt_base
        mesh = self.mesh
        h = min(cfg.grid.dx, cfg.grid.dy)
        vel_max = pmax(torch.maximum(u.abs().amax(), v.abs().amax()), mesh).clamp(min=1e-10)
        dt = cfl_scale * cfg.cfl_target * h / vel_max
        if cfg.diffusion != "implicit":
            if nu_t is None:
                dt = dt.clamp(max=self.dt_visc)
            else:
                nu_total = cfg.nu + psum(nu_t.sum(), mesh) / self.n_global \
                    + cfg.artificial_viscosity
                dt = torch.minimum(dt, self.visc_num / nu_total)
        dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        if cfg.warmup_steps > 0:
            dt = torch.where(step < cfg.warmup_steps, self.warmup_dt, dt)
        return dt

    def _convection(self, u, v, dt, nu_eff):
        cfg = self.cfg
        dx, dy = cfg.grid.dx, cfg.grid.dy
        if cfg.scheme in ("supg", "supg_refparity"):
            # τ is pointwise: no halo, the global frame zeroed
            tau = torch.where(self.imask, supg_tau_field(u, v, dx, dy, dt, nu_eff), 0.0)
            parity = cfg.scheme == "supg_refparity"
            return self._stencil(
                lambda a, b, cu, cv, t_: (
                    convection_supg(a, b, cu, dx, dy, t_, ref_parity=parity),
                    convection_supg(a, b, cv, dx, dy, t_, ref_parity=parity)),
                u, v, u, v, tau)
        if cfg.scheme == "tvd":
            # width-2 halos, clamped global edges: the op's edge-mode slopes
            return self._stencil(
                lambda a, b, cu, cv: (convection_tvd(a, b, cu, dx, dy),
                                      convection_tvd(a, b, cv, dx, dy)),
                u, v, u, v, width=2, clamp=True)
        conv = {"upwind": convection_upwind, "central": convection_central}[cfg.scheme]
        return self._stencil(lambda a, b: (conv(a, b, a, dx, dy), conv(a, b, b, dx, dy)), u, v)

    def _fused_predictor(self, u, v, dt):
        """The fused kernel's u*, v* (before the BCs) on this rank's window
        (edges only: the 5-point stencil reads no corner), cropped."""
        cfg = self.cfg
        g = cfg.grid
        ny_l, nx_l = self.local_shape
        win, (oy, ox) = interior_window(torch.stack([u, v]), self.mesh, 1, corners=False)
        u_s, v_s = fused_predictor_central(win[0].contiguous(), win[1].contiguous(), dt,
                                           cfg.nu + cfg.artificial_viscosity, g.dx, g.dy)
        return (u_s[oy:oy + ny_l, ox:ox + nx_l].contiguous(),
                v_s[oy:oy + ny_l, ox:ox + nx_l].contiguous())

    def _predictor(self, u, v, dt, nu_t, nu_eff, bc):
        """u*, v*: convection and explicit or implicit diffusion, the BCs
        written."""
        cfg = self.cfg
        mesh = self.mesh
        dx, dy = cfg.grid.dx, cfg.grid.dy
        ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
        conv_u, conv_v = self._convection(u, v, dt, nu_eff)
        if self.use_dst:
            # exact distributed Dirichlet Helmholtz by the pencil DST
            bu = u - dt * conv_u
            bv = v - dt * conv_v
            coeff = dt * (cfg.nu + cfg.artificial_viscosity)
            bu, bv = bc(bu, bv)
            u_star, v_star = bc(dst_helmholtz_local(bu, coeff, dx, dy, mesh),
                                dst_helmholtz_local(bv, coeff, dx, dy, mesh))
        elif cfg.diffusion == "implicit":
            bu = u - dt * conv_u
            bv = v - dt * conv_v
            coeff = dt * nu_eff
            denom_inv = torch.reciprocal(1.0 + 2.0 * (ax + ay) * coeff)
            u_star, v_star = bc(bu.clone(), bv.clone())  # the BCs write in place
            for _ in range(cfg.implicit_iters):
                nb_u, nb_v = self._neighbour_sum(torch.stack([u_star, v_star])).unbind(0)
                u_star = (bu + coeff * nb_u) * denom_inv
                v_star = (bv + coeff * nb_v) * denom_inv
                u_star, v_star = bc(u_star, v_star)
        else:
            if nu_t is None:
                lap_u, lap_v = self._stencil(
                    lambda a, b: (laplacian_coeff(a, dx, dy, nu_eff),
                                  laplacian_coeff(b, dx, dy, nu_eff)), u, v)
            else:
                lap_u, lap_v = self._stencil(
                    lambda a, b, n_: (laplacian_coeff(a, dx, dy, n_),
                                      laplacian_coeff(b, dx, dy, n_)), u, v, nu_eff)
            u_star = u + dt * (lap_u - conv_u)
            v_star = v + dt * (lap_v - conv_v)
            u_star, v_star = bc(u_star, v_star)
        return u_star, v_star

    def forward(self, state: IncompressibleState, cfl_scale, *extras):
        cfg = self.cfg
        mesh = self.mesh
        g = cfg.grid
        dx, dy = g.dx, g.dy
        ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
        if state.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {state.u.device}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        n_extras = int(self.use_ibm) + int(self.needs_y) + int(cfg.masked_poisson)
        if len(extras) != n_extras:
            raise ValueError(f"the step takes {n_extras} extra blocks, got {len(extras)}")
        extras = list(extras)
        ibm_b = extras.pop(0) if self.use_ibm else None
        y_b = extras.pop(0) if self.needs_y else None
        fluid_b = ~extras.pop(0).to(torch.bool) if cfg.masked_poisson else None
        u, v, p = state.u, state.v, state.p
        if cfg.storage == "bf16":
            # upcast once; everything below runs in float32
            u, v = u.float(), v.float()
        bc = self.bc_builder(state, y_b, mesh)

        # --- LES eddy viscosity: ν_eff a field with it, a number without
        nu_t = None
        nu_eff = self.nu_eff
        if cfg.use_les:
            nu_t = self._stencil(
                lambda a, b: smagorinsky_viscosity(a, b, dx, dy, cfg.smagorinsky_constant), u, v)
            nu_eff = cfg.nu + nu_t + cfg.artificial_viscosity
        dt = self._dt(u, v, nu_t, state.step, cfl_scale)

        # --- convection, diffusion, predictor
        if cfg.fused_predictor:
            u_star, v_star = bc(*self._fused_predictor(u, v, dt))
        else:
            u_star, v_star = self._predictor(u, v, dt, nu_t, nu_eff, bc)

        # --- IBM on the predictor; the damped momentum is the force on the body
        sums = []
        if self.use_ibm:
            damp = 1.0 - ibm_b * ibm_ramp(state.step, cfg.ibm_ramp_steps)
            u_pre, v_pre = u_star, v_star
            u_star, v_star = u_star * damp, v_star * damp
            sums += [(u_pre - u_star).sum(), (v_pre - v_star).sum()]

        # --- pressure projection, warm-started from the last pressure
        div_star = self._stencil(lambda a, b: divergence(a, b, dx, dy), u_star, v_star)
        rhs = div_star / dt
        if self.subtract_mean:
            rhs = rhs - psum(rhs.sum(), mesh) / self.n_global
        phi = self.poisson(p, rhs, fluid_b if self.poisson.masked else None)
        gx, gy = self._stencil(lambda a: gradient(a, dx, dy), phi)
        u_new = u_star - dt * gx
        v_new = v_star - dt * gy

        # --- divergence cleanup: φ (zero on the global frame) persists
        if cfg.cleanup_iters > 0:
            clean_denom = 1.0 / (2.0 * (ax + ay))
            cphi = torch.zeros_like(u_new)
            for _ in range(cfg.cleanup_iters):
                cdiv = self._stencil(lambda a, b: divergence(a, b, dx, dy), u_new, v_new)
                cphi = torch.where(self.imask,
                                   (self._neighbour_sum(cphi[None])[0] - cdiv) * clean_denom,
                                   0.0)
                cgx, cgy = self._stencil(lambda a: gradient(a, dx, dy), cphi)
                u_new = u_new - cgx
                v_new = v_new - cgy

        u_new, v_new = bc(u_new, v_new)
        if self.use_ibm:
            u_pre2, v_pre2 = u_new, v_new
            u_new, v_new = u_new * damp, v_new * damp
            sums += [(u_pre2 - u_new).sum(), (v_pre2 - v_new).sum()]
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)

        u_out, v_out = u_new, v_new
        if cfg.storage == "bf16":
            # round once a step; the metrics below read the float32 fields
            u_out, v_out = u_new.to(torch.bfloat16), v_new.to(torch.bfloat16)
        new_state = IncompressibleState(u=u_out, v=v_out, p=phi, t=state.t + dt,
                                        step=state.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_state, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                          zero)

        # --- metrics: the maxima in one all_reduce, the sums in another
        div_post = self._stencil(lambda a, b: divergence(a, b, dx, dy), u_new, v_new)
        vort = self._stencil(lambda a, b: curl(a, b, dx, dy), u_new, v_new)
        res = (self.poisson.lap(phi) - rhs).abs()
        if fluid_b is not None:
            res = torch.where(fluid_b, res, 0.0)
        maxima = pmax(torch.stack([
            div_star.abs().amax(),
            torch.where(self.imask2, div_post.abs(), 0.0).amax(),
            torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            vort.abs().amax(),
            res.amax(),
        ]), mesh)
        totals = psum(torch.stack([(0.5 * (u_new * u_new + v_new * v_new)).sum(), *sums]), mesh)
        fx = fy = zero
        if self.use_ibm:
            fx = (totals[1] + totals[3]) * (dx * dy) / dt
            fy = (totals[2] + totals[4]) * (dx * dy) / dt
        div_pre, div_post_m, max_vel, vort_max, poisson_res = maxima.unbind(0)
        return new_state, StepMetrics(
            dt=dt, div_pre=div_pre, div_post=div_post_m, max_vel=max_vel,
            energy=totals[0] / self.n_global, vort_max=vort_max, poisson_res=poisson_res,
            fx=fx, fy=fy, fz=zero)


def make_explicit_step(cfg: IncompressibleConfig, mesh: GridMesh, bc_builder: Callable,
                       use_ibm: bool = False, needs_y: bool = False, *, device=None):
    """Build the explicit-communication step on this rank.

    ``bc_builder(state, y_b, mesh) -> bc(u, v) -> (u, v)`` returns the local
    BC closure: in-place writes of the global edges this rank holds. The
    step's signature grows with the enabled extras, in this order:

        step(state, cfl_scale[, ibm_b][, y_b][, fluid_b])

    - ``ibm_b``: this rank's block of the Gaussian-shell IBM mask (``use_ibm``)
    - ``y_b``: its rows of the global y coordinates (``needs_y``)
    - ``fluid_b``: its block of the solid mask (``cfg.masked_poisson``)

    ``device`` defaults to the mesh's."""
    return ExplicitStep(cfg, mesh, bc_builder, use_ibm, needs_y, device=device)


def make_cavity_explicit_step(cfg: IncompressibleConfig, mesh: GridMesh,
                              lid_velocity: float = 1.0, *, device=None):
    """The explicit-communication step of the lid-driven cavity (method
    "rbsor": the sweeps from ``cfg.poisson.iters``/``omega``; or "dct")."""
    iy, ix, py, px = mesh.iy, mesh.ix, mesh.py, mesh.px

    def bc_builder(state, y_b, mesh_):
        def bc(u, v):
            for f, top in ((u, lid_velocity), (v, 0.0)):
                if ix == 0:
                    f[:, 0] = 0.0
                if ix == px - 1:
                    f[:, -1] = 0.0
                if iy == 0:
                    f[0, :] = 0.0
                if iy == py - 1:
                    f[-1, :] = top
            return u, v

        return bc

    return make_explicit_step(cfg, mesh, bc_builder, device=device)


def make_cylinder_explicit_step(cfg: IncompressibleConfig, mesh: GridMesh, ibm_mask=None,
                                v_inf: float = 1.0, perturb_amp: float = 0.01,
                                perturb_ramp_steps: int = 1000, *, device=None):
    """The explicit-communication step of the IBM cylinder (any scheme, LES,
    implicit diffusion, cleanup, masked Poisson).

    Call as ``step(state, cfl_scale, ibm_b, y_b[, solid_b])`` with this
    rank's block of the global (ny, nx) Gaussian-shell mask, its rows of the
    global y coordinates and, iff ``cfg.masked_poisson``, its block of the
    solid mask (``mesh.local_block``, ``mesh.local_rows``). The pressure is
    the distributed rbsor, or the pencil DCT where ``masked_poisson`` is off
    (the case's default)."""
    del ibm_mask  # the mask is passed at call time as a block
    g = cfg.grid
    iy, ix, py, px = mesh.iy, mesh.ix, mesh.py, mesh.px

    def bc_builder(state, y_b, mesh_):
        step = state.step

        def bc(uu, vv):
            # the inflow perturbation ramp on x_lo
            scale = (step / perturb_ramp_steps).clamp(max=1.0) * perturb_amp
            pert = scale * torch.sin(2.0 * np.pi * y_b / g.y_max + 0.02 * step)
            if ix == 0:
                uu[:, 0] = v_inf * (1.0 + pert)
                vv[:, 0] = 0.0
            if ix == px - 1:
                uu[:, -1] = uu[:, -2]
                vv[:, -1] = vv[:, -2]
            for f in (uu, vv):
                if iy == 0:
                    f[0, :] = 0.0
                if iy == py - 1:
                    f[-1, :] = 0.0
            return uu, vv

        return bc

    return make_explicit_step(cfg, mesh, bc_builder, use_ibm=True, needs_y=True, device=device)


def make_channel_explicit_step(cfg: IncompressibleConfig, mesh: GridMesh, u_in: float = 1.0,
                               profile=None, *, device=None):
    """The explicit-communication step of the channel
    (``boundary.channel_bcs(u_in, profile)``): the inflow on x_lo, uniform
    ``u_in`` or this rank's rows of the global (ny,) ``profile`` (numpy or
    tensor), the zero-gradient outflow on x_hi, no slip on y.
    ``step(state, cfl_scale)``."""
    iy, ix, py, px = mesh.iy, mesh.ix, mesh.py, mesh.px
    dev = step_device(mesh, device)
    inflow = u_in
    if profile is not None:
        from cfdsim_tpu_torch.parallel.mesh import local_rows

        if torch.is_tensor(profile):
            profile = profile.detach().cpu().numpy()
        inflow = local_rows(np.asarray(profile, np.float32), mesh).to(dev)

    def bc_builder(state, y_b, mesh_):
        def bc(uu, vv):
            if ix == 0:
                uu[:, 0] = inflow
                vv[:, 0] = 0.0
            if ix == px - 1:
                uu[:, -1] = uu[:, -2]
                vv[:, -1] = vv[:, -2]
            for f in (uu, vv):
                if iy == 0:
                    f[0, :] = 0.0
                if iy == py - 1:
                    f[-1, :] = 0.0
            return uu, vv

        return bc

    return make_explicit_step(cfg, mesh, bc_builder, device=device)
