"""Incompressible Navier–Stokes: Chorin fractional-step projection
(``cfdsim_tpu.models.incompressible``, the collocated main path).

One call of :class:`IncompressibleStep` advances the state one step:
adaptive dt → predictor → BCs → exact DCT pressure projection → corrector
→ BCs → clipping, plus on-device diagnostics. dt stays a 0-dim float32
tensor on the device and the step never reads a value back to the host, so
steps queue on the card without a synchronisation.

Ported so far: ``scheme="central"``, explicit diffusion, no LES, IBM,
forcing or divergence cleanup, ``storage="fp32"``, the DCT Poisson solve,
``compute_metrics`` on and off, and ``fused_predictor`` on (the CUDA kernel
of ``ops/kernels/predictor.py``) and off. Other values raise
``NotImplementedError`` at build time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ops.convection import convection_central
from cfdsim_tpu_torch.ops.kernels.predictor import fused_predictor_central
from cfdsim_tpu_torch.ops.stencil import (
    curl,
    divergence,
    gradient,
    interior_mask,
    laplacian_coeff,
)
from cfdsim_tpu_torch.solvers.poisson import (
    NeumannDCT,
    PoissonConfig,
    check_ported,
    poisson_residual,
)


class IncompressibleState(NamedTuple):
    """Projection-solver state; all tensors on one device."""

    u: torch.Tensor  # (ny, nx) float32 x-velocity
    v: torch.Tensor  # (ny, nx) float32 y-velocity
    p: torch.Tensor  # (ny, nx) float32 pressure (projection potential)
    t: torch.Tensor  # 0-dim float32 simulated time
    step: torch.Tensor  # 0-dim int32


class StepMetrics(NamedTuple):
    """Per-step diagnostics as 0-dim device tensors (stacked by the runner
    and read on the host once per chunk). ``fx``/``fy``/``fz`` are the
    immersed-body forces of the JAX package, 0 here (no IBM is ported)."""

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
    """Static solver configuration: the JAX package's fields that the ported
    path reads, with the same defaults. ``scheme``, ``diffusion``,
    ``use_les``, ``cleanup_iters`` and ``storage`` accept only their ported
    value (the step refuses others); the JAX package's other fields
    (fixed dt and fixed-dt warmup, implicit solver, LES constant, IBM ramp,
    masked Poisson) belong to paths that are not ported and are absent."""

    grid: Grid
    nu: float
    scheme: str = "central"
    diffusion: str = "explicit"
    use_les: bool = False
    artificial_viscosity: float = 0.0
    poisson: PoissonConfig = PoissonConfig()
    cfl_target: float = 0.5
    dt_min: float = 1e-7
    dt_max: float = 1.0
    max_velocity: float = 1e3
    cleanup_iters: int = 0
    compute_metrics: bool = True
    # fuse the explicit central predictor (conv + lap + axpy for u AND v)
    # into one pass: the hand-written CUDA kernel on the card. Requires
    # scheme="central", explicit diffusion, no LES, no forcing.
    fused_predictor: bool = False
    storage: str = "fp32"


def init_state(cfg: IncompressibleConfig, u0=None, v0=None, p0=None, *, device):
    """Zero state (or the given fields) on ``device``."""
    g = cfg.grid

    def field(x):
        if x is None:
            return g.zeros(device=device)
        return torch.as_tensor(x, dtype=torch.float32, device=device).clone()

    return IncompressibleState(
        u=field(u0),
        v=field(v0),
        p=field(p0),
        t=torch.zeros((), dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _check_ported(cfg: IncompressibleConfig) -> None:
    unported = {
        "scheme": (cfg.scheme, "central"),
        "diffusion": (cfg.diffusion, "explicit"),
        "use_les": (cfg.use_les, False),
        "cleanup_iters": (cfg.cleanup_iters, 0),
        "storage": (cfg.storage, "fp32"),
    }
    for name, (got, ported) in unported.items():
        if got != ported:
            raise NotImplementedError(
                f"{name}={got!r} is not ported yet (only {ported!r}); see "
                "ROADMAP.md queue 1 for the order in which the rest follows"
            )
    check_ported(cfg.poisson)


class IncompressibleStep(nn.Module):
    """``step(state, cfl_scale) -> (state, StepMetrics)`` for one case.

    Constant tables live in registered buffers on the device the step was
    built for: the Poisson solver's 1/λ table and twiddles, the width-2
    interior mask of the post-projection divergence metric, and a zero.
    ``cfl_scale`` is a 0-dim float32 tensor (or a Python float) — the
    host-controlled CFL back-off factor.
    """

    def __init__(self, cfg: IncompressibleConfig, bc_fn: Callable, *, device):
        super().__init__()
        if cfg.fused_predictor and (
            cfg.scheme != "central" or cfg.diffusion != "explicit" or cfg.use_les
        ):
            raise ValueError(
                "fused_predictor requires scheme='central', explicit diffusion, "
                "no LES, and no forcing"
            )
        _check_ported(cfg)
        g = cfg.grid
        self.cfg = cfg
        self.bc_fn = bc_fn
        self.poisson = NeumannDCT(
            (g.ny, g.nx), g.dx, g.dy, cfg.poisson.dct_variant, device=device)
        self.register_buffer("imask", interior_mask(g.shape, width=2, device=device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))
        # ν_total + mean(ν_t) with ν_t = 0 (no LES): the viscous dt bound is
        # a constant, evaluated once in float32 as the JAX package's trace
        # evaluates it every step
        nu_total = np.float32(cfg.nu) + np.float32(0.0) + np.float32(cfg.artificial_viscosity)
        h = min(g.dx, g.dy)
        self.dt_visc = float(np.float32(0.2 * h * h) / nu_total)

    def _adaptive_dt(self, u, v, cfl_scale):
        """CFL + viscous dt with clipping (0-dim tensor)."""
        cfg = self.cfg
        h = min(cfg.grid.dx, cfg.grid.dy)
        vel_max = torch.maximum(u.abs().amax(), v.abs().amax()).clamp(min=1e-10)
        dt_cfl = cfl_scale * cfg.cfl_target * h / vel_max
        return dt_cfl.clamp(max=self.dt_visc).clamp(cfg.dt_min, cfg.dt_max)

    def forward(self, state: IncompressibleState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy = g.dx, g.dy
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        u, v, p = state.u, state.v, state.p
        dt = self._adaptive_dt(u, v, cfl_scale)

        # --- predictor: ν_eff = ν + ν_t + ν_art with ν_t = 0, one scalar
        nu_eff = cfg.nu + cfg.artificial_viscosity
        if cfg.fused_predictor:
            u_star, v_star = fused_predictor_central(u, v, dt, nu_eff, dx, dy)
        else:
            conv_u = convection_central(u, v, u, dx, dy)
            conv_v = convection_central(u, v, v, dx, dy)
            u_star = u + dt * (laplacian_coeff(u, dx, dy, nu_eff) - conv_u)
            v_star = v + dt * (laplacian_coeff(v, dx, dy, nu_eff) - conv_v)
        u_star, v_star = self.bc_fn(u_star, v_star, state.step, state.t)

        # --- pressure projection; the direct solve discards the k=0 mode
        # in-spectrum, so rhs needs no mean subtraction
        div_star = divergence(u_star, v_star, dx, dy)
        rhs = div_star / dt
        phi = self.poisson(rhs)
        gx, gy = gradient(phi, dx, dy)
        u_new = u_star - dt * gx
        v_new = v_star - dt * gy
        u_new, v_new = self.bc_fn(u_new, v_new, state.step, state.t)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)

        new_state = IncompressibleState(
            u=u_new, v=v_new, p=phi, t=state.t + dt, step=state.step + 1)

        zero = self.zero
        if cfg.compute_metrics:
            div_post = divergence(u_new, v_new, dx, dy)
            vort = curl(u_new, v_new, dx, dy)
            metrics = StepMetrics(
                dt=dt,
                div_pre=div_star.abs().amax(),
                div_post=(div_post.abs() * self.imask).amax(),
                max_vel=torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                energy=(0.5 * (u_new * u_new + v_new * v_new)).mean(),
                vort_max=vort.abs().amax(),
                poisson_res=poisson_residual(phi, rhs, dx, dy, None, cfg.poisson.bc),
                fx=zero,
                fy=zero,
                fz=zero,
            )
        else:
            metrics = StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero, zero)
        return new_state, metrics


def make_step(cfg: IncompressibleConfig, bc_fn: Callable, *, device):
    """Build the step module for a case on ``device`` (body forcing, IBM and
    solid masks of the JAX ``make_step`` are not ported)."""
    return IncompressibleStep(cfg, bc_fn, device=device)


def make_chunk(cfg: IncompressibleConfig, step_fn: Callable, n_steps: int) -> Callable:
    """``chunk(state, cfl_scale) -> (state, [StepMetrics] * n_steps)``: a
    Python loop of step calls; the launches queue on the device without a
    host synchronisation."""

    def chunk(state, cfl_scale):
        metrics = []
        for _ in range(n_steps):
            state, m = step_fn(state, cfl_scale)
            metrics.append(m)
        return state, metrics

    return chunk
