"""Incompressible Navier–Stokes: Chorin fractional-step projection
(``cfdsim_tpu.models.incompressible``, the collocated tier).

One call of :class:`IncompressibleStep` advances the state one step:
adaptive (or fixed, or warm-up) dt → Smagorinsky LES viscosity →
convection (central, upwind, TVD, SUPG) → explicit predictor, or the
implicit (backward-Euler) viscous solve: exact in one DST-I pair
(``solvers/helmholtz.py``) or damped Jacobi where ν varies in space → body
forcing → BCs → IBM penalization → pressure projection (any ported Poisson
method, warm-started from the last pressure, masked inside solids when
``masked_poisson``) → corrector → divergence cleanup → BCs → IBM →
clipping, plus on-device diagnostics and the body forces. dt stays a
0-dim float32 tensor on the device and the step reads nothing back to the
host, except the streaming ``jacobi``/``rbsor`` early exit, which checks its
residual on the host once per ``check_every`` sweeps. :func:`make_chunk`
runs a chunk of steps: on a CUDA device as one captured device program (a
CUDA graph, the counterpart of the JAX package's jitted ``lax.scan``),
else as a Python loop.

``storage="bf16"`` keeps u and v in bfloat16 between steps: the step
upcasts them to float32 once at its start, computes everything in float32
and rounds them once at its end; its metrics read the unrounded fields.
``fused_predictor`` runs the CUDA kernel of ``ops/kernels/predictor.py``
(on the upcast float32 fields, whatever the storage). States and metrics
may be nested NamedTuples (``models/transport.py``): the chunk works on
their leaves (``utils/tree.py``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ibm import apply_ibm, ibm_ramp
from cfdsim_tpu_torch.ops.convection import (
    convection_central,
    convection_supg,
    convection_tvd,
    convection_upwind,
    supg_tau,
)
from cfdsim_tpu_torch.ops.kernels.predictor import fused_predictor_central
from cfdsim_tpu_torch.ops.les import smagorinsky_viscosity
from cfdsim_tpu_torch.ops.stencil import (
    curl,
    divergence,
    gradient,
    interior_mask,
    laplacian_coeff,
)
from cfdsim_tpu_torch.solvers.autotune import resolve_poisson_config
from cfdsim_tpu_torch.solvers.helmholtz import DirichletHelmholtz
from cfdsim_tpu_torch.solvers.poisson import (
    PoissonConfig,
    PoissonSolver,
    _neighbor_sum_dirichlet,
    poisson_residual,
)
from cfdsim_tpu_torch.utils.tree import leaves, rebuild, tree_map

SCHEMES = ("central", "upwind", "tvd", "supg", "supg_refparity")
IMPLICIT_SOLVERS = ("auto", "dst", "jacobi")


class IncompressibleState(NamedTuple):
    """Projection-solver state; all tensors on one device."""

    u: torch.Tensor  # (ny, nx) float32 x-velocity (bfloat16 under storage="bf16")
    v: torch.Tensor  # (ny, nx) float32 y-velocity (likewise)
    p: torch.Tensor  # (ny, nx) float32 pressure (projection potential)
    t: torch.Tensor  # 0-dim float32 simulated time
    step: torch.Tensor  # 0-dim int32


class StepMetrics(NamedTuple):
    """Per-step diagnostics as 0-dim device tensors (stacked by the runner
    and read on the host once per chunk). ``fx``/``fy`` are the forces on
    the immersed body (the momentum the penalization removes, per unit
    density; 0 without a body); ``fz`` is the 3D bodies' and 0 here."""

    dt: torch.Tensor
    div_pre: torch.Tensor  # max |div u*| before projection
    div_post: torch.Tensor  # max |div u| after projection (2-node frame excluded)
    max_vel: torch.Tensor
    energy: torch.Tensor  # mean kinetic energy
    vort_max: torch.Tensor
    poisson_res: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor


@dataclasses.dataclass(frozen=True)
class IncompressibleConfig:
    """Static solver configuration: the JAX package's fields, with the same
    defaults."""

    grid: Grid
    nu: float
    scheme: str = "central"  # central | upwind | tvd | supg | supg_refparity
    # diffusion treatment: "explicit" (forward Euler, dt limited by the
    # viscous bound) or "implicit" (backward Euler on the viscous term,
    # which drops the viscous dt limit)
    diffusion: str = "explicit"
    implicit_iters: int = 12
    # implicit viscous back end: "dst" = exact Dirichlet Helmholtz in one
    # DST-I transform pair (solvers/helmholtz.py; needs scalar ν, so not
    # with LES); "jacobi" = damped Jacobi iteration (implicit_iters sweeps,
    # works with spatially varying ν_eff); "auto" = dst when possible,
    # else jacobi
    implicit_solver: str = "auto"
    use_les: bool = False
    smagorinsky_constant: float = 0.17
    artificial_viscosity: float = 0.0
    poisson: PoissonConfig = PoissonConfig(method="rbsor", iters=100, omega=1.7)
    # adaptive time stepping; else dt = dt_base. The first warmup_steps
    # steps take warmup_dt.
    adaptive_dt: bool = True
    cfl_target: float = 0.5
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    warmup_steps: int = 0
    warmup_dt: float = 0.0
    max_velocity: float = 1e3  # clip bound
    cleanup_iters: int = 0  # extra divergence-cleanup sweeps after the corrector
    ibm_ramp_steps: int = 0  # IBM force ramp over the first steps
    masked_poisson: bool = False  # φ frozen inside solids
    compute_metrics: bool = True
    # fuse the explicit central predictor (conv + lap + axpy for u AND v)
    # into one pass: the hand-written CUDA kernel on the card. Requires
    # scheme="central", explicit diffusion, no LES, no forcing.
    fused_predictor: bool = False
    # inter-step u/v storage: "bf16" halves the state's bytes, computes in
    # float32 and rounds u and v once a step (~4e-3 relative); p stays
    # float32, as it warm-starts the solve
    storage: str = "fp32"  # fp32 | bf16


def storage_dtype(storage: str) -> torch.dtype:
    """The dtype of u and v between steps for a config's ``storage``."""
    if storage not in ("fp32", "bf16"):
        raise ValueError(f"unknown storage {storage!r}")
    return torch.bfloat16 if storage == "bf16" else torch.float32


def init_state(cfg: IncompressibleConfig, u0=None, v0=None, p0=None, *, device):
    """Zero state (or the given fields) on ``device``; u and v in the
    storage dtype, p in float32."""
    g = cfg.grid
    vdt = storage_dtype(cfg.storage)

    def field(x, dtype):
        if x is None:
            return g.zeros(dtype, device=device)
        return torch.as_tensor(x, dtype=torch.float32, device=device).to(dtype).clone()

    return IncompressibleState(
        u=field(u0, vdt),
        v=field(v0, vdt),
        p=field(p0, torch.float32),
        t=torch.zeros((), dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _check_config(cfg: IncompressibleConfig) -> None:
    if cfg.scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {cfg.scheme!r}")
    if cfg.diffusion not in ("explicit", "implicit"):
        raise ValueError(f"unknown diffusion {cfg.diffusion!r}")
    if cfg.implicit_solver not in IMPLICIT_SOLVERS:
        raise ValueError(f"unknown implicit_solver {cfg.implicit_solver!r}")
    storage_dtype(cfg.storage)


def _cleanup_divergence(u, v, dx, dy, iters: int):
    """Extra projection sweeps after the corrector: φ (zero on the frame)
    persists across sweeps; each sweep does one Jacobi update of the
    interior, then subtracts ∇φ."""
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    denom_inv = 1.0 / (2.0 * (ax + ay))
    phi = torch.zeros_like(u)
    for _ in range(iters):
        # the neighbour sum and the divergence are zero on the frame
        phi = (_neighbor_sum_dirichlet(phi, ax, ay) - divergence(u, v, dx, dy)) * denom_inv
        gx, gy = gradient(phi, dx, dy)
        u = u - gx
        v = v - gy
    return u, v


class IncompressibleStep(nn.Module):
    """``step(state, cfl_scale) -> (state, StepMetrics)`` for one case.

    Constant tables live in registered buffers on the device the step was
    built for: the Poisson solver's (masks, 1/λ, level tables), the
    implicit step's DST eigen-table, the IBM mask, the body forcing, the
    width-2 interior mask of the post-projection divergence metric, and the
    fixed and warm-up dt. ``cfl_scale`` is a 0-dim float32 tensor (or a
    Python float): the host-controlled CFL back-off factor.
    """

    def __init__(self, cfg: IncompressibleConfig, bc_fn: Callable, solid_mask=None,
                 ibm_mask=None, forcing=None, *, device):
        super().__init__()
        if cfg.fused_predictor and (
            cfg.scheme != "central" or cfg.diffusion != "explicit" or cfg.use_les
            or forcing is not None
        ):
            raise ValueError(
                "fused_predictor requires scheme='central', explicit diffusion, "
                "no LES, and no forcing"
            )
        _check_config(cfg)
        g = cfg.grid
        # pin dct_variant="auto" now: the autotuner times on the device,
        # which a captured chunk must never do
        pois = resolve_poisson_config(cfg.poisson, (g.ny, g.nx), g.dx, g.dy, device=device)
        if pois is not cfg.poisson:
            cfg = dataclasses.replace(cfg, poisson=pois)
        self.cfg = cfg
        self.bc_fn = bc_fn
        self.device = torch.device(device)
        pois_mask = solid_mask if (cfg.masked_poisson and solid_mask is not None) else None
        self.poisson = PoissonSolver((g.ny, g.nx), g.dx, g.dy, cfg.poisson, pois_mask,
                                     device=device)
        # the residual metric excludes the frozen cells even where the
        # solver (dct, fft) ignores the mask
        self.register_buffer("pois_mask", None if pois_mask is None else torch.as_tensor(
            pois_mask, dtype=torch.bool, device=device))
        self.register_buffer("ibm_mask", None if ibm_mask is None else torch.as_tensor(
            ibm_mask, dtype=torch.float32, device=device))
        self.register_buffer("imask", interior_mask(g.shape, width=2, device=device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))
        self.register_buffer("dt_base", torch.tensor(
            cfg.dt_base, dtype=torch.float32, device=device))
        self.register_buffer("warmup_dt", torch.tensor(
            cfg.warmup_dt, dtype=torch.float32, device=device))
        # the optional (fx, fy) body force, numbers or (ny, nx) fields
        self.has_forcing = forcing is not None
        for name, f in zip(("force_x", "force_y"), forcing or (None, None)):
            self.register_buffer(name, None if f is None else torch.as_tensor(
                f, dtype=torch.float32, device=device))
        # Without LES ν_eff = (ν + ν_t) + ν_art with ν_t = 0, summed in float32
        # as the JAX package sums its float32 arrays; the viscous dt bound is
        # then a constant, evaluated once as its trace evaluates it per step.
        # With LES both follow ν_t, per step.
        nu_total = np.float32(cfg.nu) + np.float32(0.0) + np.float32(cfg.artificial_viscosity)
        self.nu_eff = float(nu_total)
        h = min(g.dx, g.dy)
        self.register_buffer("visc_num", torch.tensor(
            0.2 * h * h, dtype=torch.float32, device=device))
        self.dt_visc = float(np.float32(0.2 * h * h) / nu_total)
        # the implicit viscous back end
        self.use_dst = cfg.diffusion == "implicit" and (
            cfg.implicit_solver == "dst" or (cfg.implicit_solver == "auto" and not cfg.use_les))
        if self.use_dst and cfg.use_les:
            raise ValueError("implicit_solver='dst' needs scalar viscosity; use 'jacobi' "
                             "with LES")
        self.helmholtz = (DirichletHelmholtz((g.ny, g.nx), g.dx, g.dy, device=device)
                          if self.use_dst else None)
        # the Neumann problem's solvability: the direct solvers discard the
        # k=0 mode in-spectrum, the others take a mean-free rhs
        self.subtract_mean = cfg.poisson.bc == "neumann" and cfg.poisson.method not in (
            "dct", "fft")
        # whether a step waits for the host (then a chunk cannot be captured)
        self.reads_host = self.poisson.reads_host

    def _dt(self, u, v, nu_t, step, cfl_scale):
        """CFL + viscous dt with clipping and the fixed-dt warm-up (0-dim);
        implicit diffusion has no viscous bound."""
        cfg = self.cfg
        if not cfg.adaptive_dt:
            return self.dt_base
        h = min(cfg.grid.dx, cfg.grid.dy)
        vel_max = torch.maximum(u.abs().amax(), v.abs().amax()).clamp(min=1e-10)
        dt = cfl_scale * cfg.cfl_target * h / vel_max
        if cfg.diffusion != "implicit":
            if nu_t is None:
                dt = dt.clamp(max=self.dt_visc)
            else:
                nu_total = cfg.nu + nu_t.mean() + cfg.artificial_viscosity
                dt = torch.minimum(dt, self.visc_num / nu_total)
        dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        if cfg.warmup_steps > 0:
            dt = torch.where(step < cfg.warmup_steps, self.warmup_dt, dt)
        return dt

    def _convection(self, u, v, dt, nu_eff):
        cfg = self.cfg
        dx, dy = cfg.grid.dx, cfg.grid.dy
        if cfg.scheme in ("supg", "supg_refparity"):
            tau = supg_tau(u, v, dx, dy, dt, nu_eff)
            parity = cfg.scheme == "supg_refparity"
            return (convection_supg(u, v, u, dx, dy, tau, ref_parity=parity),
                    convection_supg(u, v, v, dx, dy, tau, ref_parity=parity))
        conv = {"upwind": convection_upwind, "tvd": convection_tvd,
                "central": convection_central}[cfg.scheme]
        return conv(u, v, u, dx, dy), conv(u, v, v, dx, dy)

    def _implicit(self, bu, bv, dt, nu_eff, step, t):
        """Backward-Euler viscous step: (I − dt ν_eff ∇²) u* = b."""
        cfg = self.cfg
        if self.use_dst:
            # exact: the Dirichlet-frame Helmholtz operator is diagonal in
            # the 2D DST-I basis; dt·ν stays a device scalar
            coeff = dt * (cfg.nu + cfg.artificial_viscosity)
            bu, bv = self.bc_fn(bu, bv, step, t)
            return self.bc_fn(self.helmholtz(bu, coeff), self.helmholtz(bv, coeff), step, t)
        # damped Jacobi, matrix-free, BCs re-imposed each iteration
        # (diagonally dominant: converges in ~10 sweeps)
        ax = 1.0 / (cfg.grid.dx * cfg.grid.dx)
        ay = 1.0 / (cfg.grid.dy * cfg.grid.dy)
        coeff = dt * nu_eff
        denom_inv = torch.reciprocal(1.0 + 2.0 * (ax + ay) * coeff)
        us, vs = self.bc_fn(bu.clone(), bv.clone(), step, t)  # the BCs write in place
        for _ in range(cfg.implicit_iters):
            us = (bu + coeff * _neighbor_sum_dirichlet(us, ax, ay)) * denom_inv
            vs = (bv + coeff * _neighbor_sum_dirichlet(vs, ax, ay)) * denom_inv
            us, vs = self.bc_fn(us, vs, step, t)
        return us, vs

    def forward(self, state: IncompressibleState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy = g.dx, g.dy
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        u, v, p = state.u, state.v, state.p
        if cfg.storage == "bf16":
            # upcast once; everything below runs in float32
            u, v = u.float(), v.float()

        # --- LES eddy viscosity: ν_eff is a field with it, a number without
        nu_t = None
        nu_eff = self.nu_eff
        if cfg.use_les:
            nu_t = smagorinsky_viscosity(u, v, dx, dy, cfg.smagorinsky_constant)
            nu_eff = cfg.nu + nu_t + cfg.artificial_viscosity
        dt = self._dt(u, v, nu_t, state.step, cfl_scale)

        # --- predictor
        if cfg.fused_predictor:
            u_star, v_star = fused_predictor_central(
                u, v, dt, cfg.nu + cfg.artificial_viscosity, dx, dy)
            u_star, v_star = self.bc_fn(u_star, v_star, state.step, state.t)
        else:
            conv_u, conv_v = self._convection(u, v, dt, nu_eff)
            if cfg.diffusion == "implicit":
                bu = u - dt * conv_u
                bv = v - dt * conv_v
                if self.has_forcing:
                    bu = bu + dt * self.force_x
                    bv = bv + dt * self.force_y
                u_star, v_star = self._implicit(bu, bv, dt, nu_eff, state.step, state.t)
            else:
                u_star = u + dt * (laplacian_coeff(u, dx, dy, nu_eff) - conv_u)
                v_star = v + dt * (laplacian_coeff(v, dx, dy, nu_eff) - conv_v)
                if self.has_forcing:
                    u_star = u_star + dt * self.force_x
                    v_star = v_star + dt * self.force_y
                u_star, v_star = self.bc_fn(u_star, v_star, state.step, state.t)

        # --- IBM on the predictor; the damped momentum is the force on the
        # body, summed over both IBM applications
        ibm = self.ibm_mask is not None
        forces = []
        if ibm:
            strength = ibm_ramp(state.step, cfg.ibm_ramp_steps)
            u_pre, v_pre = u_star, v_star
            u_star, v_star = apply_ibm(u_star, v_star, self.ibm_mask, strength)
            if cfg.compute_metrics:
                forces.append(((u_pre - u_star).sum(), (v_pre - v_star).sum()))

        # --- pressure projection, warm-started from the last pressure
        div_star = divergence(u_star, v_star, dx, dy)
        rhs = div_star / dt
        if self.subtract_mean:
            rhs = rhs - rhs.mean()
        phi = self.poisson(p, rhs)
        gx, gy = gradient(phi, dx, dy)
        u_new = u_star - dt * gx
        v_new = v_star - dt * gy

        # --- divergence cleanup, BCs, IBM, clipping
        if cfg.cleanup_iters > 0:
            u_new, v_new = _cleanup_divergence(u_new, v_new, dx, dy, cfg.cleanup_iters)
        u_new, v_new = self.bc_fn(u_new, v_new, state.step, state.t)
        if ibm:
            u_pre2, v_pre2 = u_new, v_new
            u_new, v_new = apply_ibm(u_new, v_new, self.ibm_mask, strength)
            if cfg.compute_metrics:
                forces.append(((u_pre2 - u_new).sum(), (v_pre2 - v_new).sum()))
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)

        u_out, v_out = u_new, v_new
        if cfg.storage == "bf16":
            # round once a step; the metrics below read the float32 fields
            u_out, v_out = u_new.to(torch.bfloat16), v_new.to(torch.bfloat16)
        new_state = IncompressibleState(
            u=u_out, v=v_out, p=phi, t=state.t + dt, step=state.step + 1)

        zero = self.zero
        if not cfg.compute_metrics:
            return new_state, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero,
                                          zero, zero)
        fx = fy = zero
        if forces:
            (fxa, fya), (fxb, fyb) = forces
            fx = (fxa + fxb) * (dx * dy) / dt
            fy = (fya + fyb) * (dx * dy) / dt
        div_post = divergence(u_new, v_new, dx, dy)
        vort = curl(u_new, v_new, dx, dy)
        metrics = StepMetrics(
            dt=dt,
            div_pre=div_star.abs().amax(),
            div_post=(div_post.abs() * self.imask).amax(),
            max_vel=torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            energy=(0.5 * (u_new * u_new + v_new * v_new)).mean(),
            vort_max=vort.abs().amax(),
            poisson_res=poisson_residual(phi, rhs, dx, dy, self.pois_mask, cfg.poisson.bc),
            fx=fx,
            fy=fy,
            fz=zero,
        )
        return new_state, metrics


def make_step(cfg: IncompressibleConfig, bc_fn: Callable, solid_mask=None, ibm_mask=None,
              forcing=None, *, device):
    """Build the step module for a case on ``device``: ``solid_mask``
    (bool) freezes φ in the pressure solve when ``cfg.masked_poisson``;
    ``ibm_mask`` (float) enables penalization forcing; ``forcing`` is an
    optional (fx, fy) body-force pair (numbers or (ny, nx) fields)."""
    return IncompressibleStep(cfg, bc_fn, solid_mask, ibm_mask, forcing, device=device)


CHUNK_ROUTES = ("graph", "loop")
# steps one captured graph holds (where it divides the chunk): the step's
# new fields are copied back into the static state once per replay, so the
# copies' share of a replay falls with the steps it holds
STEPS_PER_GRAPH = 10


def chunk_route(device, reads_host: bool, collectives: bool = False) -> tuple[str, str]:
    """(route, reason) of a chunk of steps on ``device``, from the device's
    type, whether the step waits for the host and whether it calls
    ``torch.distributed`` collectives (the steps of ``parallel/``):
    ``"graph"`` (one captured device program) on a CUDA device for a step
    that reads nothing on the host and calls no collective, else ``"loop"``
    (a Python loop of step calls). Decided before anything runs; nothing
    moves from one route to the other afterwards."""
    kind = torch.device(device).type
    if kind != "cuda":
        return "loop", f"the state is on {kind}: a CUDA graph needs a CUDA device"
    if reads_host:
        return "loop", ("the step reads the host (the streaming jacobi/rbsor early exit "
                        "checks its residual there), which a CUDA graph cannot capture")
    if collectives:
        return "loop", "the step calls torch.distributed collectives, which are not captured"
    return "graph", "a CUDA device and a step that reads nothing on the host"


def _row(metrics) -> torch.Tensor:
    """One step's metrics (every leaf a 0-dim float32 tensor) as one row."""
    return torch.stack(leaves(metrics))


def _stacked(rows, like):
    """(n_steps, leaves) → a metrics record of ``like``'s types whose every
    leaf is an (n_steps,) tensor."""
    return rebuild(like, rows.unbind(1))


class Chunk:
    """``chunk(state, cfl_scale) -> (state, StepMetrics)``: ``n_steps`` steps,
    the metrics stacked over the steps (each field a ``(n_steps,)`` tensor,
    as the JAX package's scan returns them). ``mode`` is the route
    (:func:`chunk_route`), ``reason`` why.

    On the ``"graph"`` route the steps are one captured device program
    (``utils/graphs.py::CapturedProgram``): a graph of ``steps_per_graph``
    steps, replayed ``n_steps / steps_per_graph`` times per call, its
    replays queued without a synchronisation. The program lives on static
    buffers: the state's leaves (u, v, p, t, step, and θ for a coupled
    state), ``cfl_scale`` (the caller's float
    or tensor is written into its buffer outside the graph, so a CFL
    back-off needs no new capture) and the stacked metrics, whose row a
    device-side counter picks. It is captured at the first call, after an
    eager warm-up of ``steps_per_graph`` steps on a copy of the state
    (kernel build and load, cuFFT plans, the allocator; the step's own
    buffers, such as the solver's chunk counter, are put back afterwards;
    the warm-up's kernel launches are launches, and stay counted). A
    capture that fails raises. ``keep_graph`` keeps the CUDA graph beside
    its executable so that ``program.nodes`` can count its nodes.

    A replay runs outside autograd, so the graph route refuses a state, a
    ``cfl_scale`` or a step module whose parameters or buffers require grad
    while grad mode is on, before anything is captured: a differentiated
    chunk runs on the loop route.

    The input state is the chunk's to use up, as the JAX chunk donates its
    argument (this implementation copies it into the static buffers). The
    returned state and metrics are copies out of the static buffers: they
    are the caller's, and later calls of the chunk do not change them.
    """

    def __init__(self, step_fn: Callable, n_steps: int, device, mode: str, reason: str,
                 keep_graph: bool = False):
        if n_steps < 1:
            raise ValueError(f"a chunk runs at least one step, got {n_steps}")
        self.step_fn = step_fn
        self.n_steps = n_steps
        self.device = torch.device(device)
        self.mode = mode
        self.reason = reason
        self.keep_graph = keep_graph
        # the most steps per graph, up to STEPS_PER_GRAPH, that divide the chunk
        self.steps_per_graph = max(k for k in range(1, min(STEPS_PER_GRAPH, n_steps) + 1)
                                   if n_steps % k == 0)
        self.program = None  # the CapturedProgram, from the first call on

    def __call__(self, state, cfl_scale):
        if self.mode == "loop":
            return self._loop(state, cfl_scale)
        if torch.is_grad_enabled() and self._carries_grad(state, cfl_scale):
            # a replay copies the state into static buffers outside autograd:
            # no gradient could come out of it
            raise ValueError("a chunk on the graph route cannot be differentiated: a state "
                             "or step that requires grad runs on the loop route "
                             "(make_chunk(..., route='loop'))")
        return self._replay(state, cfl_scale)

    def _carries_grad(self, state, cfl_scale) -> bool:
        """Whether the input or the step's own tensors (a forcing built from
        a control, say) require grad."""
        own = ()
        if isinstance(self.step_fn, nn.Module):
            own = (*self.step_fn.parameters(), *self.step_fn.buffers())
        return any(torch.is_tensor(x) and x.requires_grad
                   for x in (*leaves(state), cfl_scale, *own))

    def _loop(self, state, cfl_scale):
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.t.device)
        rows = []
        for _ in range(self.n_steps):
            state, m = self.step_fn(state, cfl_scale)
            rows.append(_row(m))
        return state, _stacked(torch.stack(rows), m)

    def _capture(self, state):
        from cfdsim_tpu_torch.utils.graphs import CapturedProgram

        self._state = tree_map(torch.empty_like, state)
        device = state.t.device
        self._cfl = torch.ones((), dtype=torch.float32, device=device)
        self._rows = None  # (n_steps, metric leaves), made at the first step
        self._row = torch.zeros(1, dtype=torch.int64, device=device)

        def steps():
            s = self._state
            for _ in range(self.steps_per_graph):
                s, m = self.step_fn(s, self._cfl)
                if self._rows is None:
                    self._like = m
                    self._rows = torch.zeros((self.n_steps, len(leaves(m))),
                                             dtype=torch.float32, device=device)
                self._rows.index_copy_(0, self._row, _row(m).reshape(1, -1))
                self._row += 1
            self._copy_in(s)

        # the warm-up steps run on a copy of the state, and leave the step's
        # own buffers (the solver's chunk counter) as they were
        self._copy_in(state)
        buffers = {}
        if isinstance(self.step_fn, nn.Module):
            buffers = {name: b.clone() for name, b in self.step_fn.named_buffers()}
        self.program = CapturedProgram(steps, keep_graph=self.keep_graph)
        for name, b in buffers.items():
            self.step_fn.get_buffer(name).copy_(b)

    def _copy_in(self, state):
        for dst, src in zip(leaves(self._state), leaves(state)):
            dst.copy_(src)

    def _replay(self, state, cfl_scale):
        if self.program is None:
            self._capture(state)
        if state.t.device != self._state.t.device:
            raise ValueError(f"chunk captured on {self._state.t.device}, state on "
                             f"{state.t.device}")
        self._copy_in(state)
        if torch.is_tensor(cfl_scale):
            self._cfl.copy_(cfl_scale)
        else:
            self._cfl.fill_(float(cfl_scale))
        self._row.zero_()
        for _ in range(self.n_steps // self.steps_per_graph):
            self.program.replay()
        return tree_map(torch.clone, self._state), _stacked(self._rows.clone(), self._like)


def make_chunk(cfg, step_fn: Callable, n_steps: int, *, device=None,
               route: str | None = None, keep_graph: bool = False) -> Chunk:
    """``chunk(state, cfl_scale) -> (state, stacked StepMetrics)`` running
    ``n_steps`` steps: the JAX package's jitted ``lax.scan`` chunk. ``cfg``
    is the case's configuration (``IncompressibleConfig``, ``MACConfig``,
    ``StretchedMACConfig``, ``BoussinesqConfig``, ``Incompressible3DConfig``,
    ``MAC3DConfig``, ``StretchedMAC3DConfig``, ``Transport3DConfig``,
    ``Boussinesq3DConfig``, or the transport pair); the chunk works on the
    state's leaves whatever their shapes and number (a ``MACState`` has three
    shapes, a ``MAC3DState`` four), and on any metrics record. A moving
    body's stencils are rebuilt inside each step from the device-side t, so
    its step captures like any other. On a
    CUDA device, for a step that reads nothing on the host, the steps are
    one captured device program and cost the host a constant; else a Python
    loop of step calls (:func:`chunk_route`; see :class:`Chunk`). The route
    is on the returned object (``mode``, ``reason``) and is logged.

    ``device`` defaults to the step's (``step_fn.device``). Whether the step
    reads the host is its ``reads_host`` (a step without that attribute is
    taken to read it), whether it calls collectives its ``collectives`` (the
    steps of ``parallel/`` set it: they take the loop). ``route="loop"``
    asks for the loop where the graph would be taken (to time the two side
    by side); ``route="graph"`` where :func:`chunk_route` says "loop" is
    refused. ``keep_graph`` is :class:`Chunk`'s."""
    if device is None:
        device = getattr(step_fn, "device", None)
        if device is None:
            raise ValueError("make_chunk needs device= for a step that has no .device")
    mode, reason = chunk_route(device, getattr(step_fn, "reads_host", True),
                               getattr(step_fn, "collectives", False))
    if route is not None and route != mode:
        if route not in CHUNK_ROUTES:
            raise ValueError(f"unknown chunk route {route!r}; one of {CHUNK_ROUTES}")
        if route == "graph":
            raise ValueError(f"the graph route is not open here: {reason}")
        mode, reason = "loop", "the caller asked for the loop"
    logging.getLogger("cfdsim_tpu_torch").info(
        "chunk of %d steps on %s: %s route (%s)", n_steps, device, mode, reason)
    return Chunk(step_fn, n_steps, device, mode, reason, keep_graph)
