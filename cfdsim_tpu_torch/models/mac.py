"""Incompressible Navier–Stokes on a staggered (MAC) grid
(``cfdsim_tpu.models.mac``): the accuracy tier.

Velocities live on cell faces (Harlow–Welch layout), the discrete
divergence and gradient are exactly adjoint, and the pressure solve makes
the corrected field divergence-free to solver precision; with the exact
DCT projection, to float32 roundoff.

Layout (ny × nx cells, a ``centering="cell"`` grid):

- ``u``: (ny, nx+1), x-velocity on vertical faces, u[j,i] at (i·dx, (j+½)dy)
- ``v``: (ny+1, nx), y-velocity on horizontal faces, v[j,i] at ((i+½)dx, j·dy)
- ``p``: (ny, nx), pressure at cell centres

Tangential wall values enter through one ghost line per side (``MACBCs.
extend``, a new array). ``MACBCs.set_normal`` writes the boundary faces IN
PLACE, as the collocated tier's BCs do: the step hands it only tensors it
allocated itself (the state's fields are copied first), so nothing the
caller holds changes. The cell-centred Neumann pressure operator is the
clamped-edge operator of ``solvers/poisson.py``, so every Poisson method
works unchanged; ``dct_variant="auto"`` is resolved when the step is
built. Convection: "central", "upwind", "tvd" (MUSCL, van Leer).

Immersed bodies: face-sampled penalization masks, the sharp-interface
ghost-cell IBM of ``ibm_ghost.py`` (a static body's stencils as buffers, or
a moving body's rebuilt on the device from ``center(t)`` with
``moving_scheme="ghost"``), and the moving body's penalization masks.

``storage="bf16"`` keeps u and v in bfloat16 between steps: the step
upcasts them once before ``set_normal``, computes in float32 and rounds
them once at its end; its metrics read the unrounded fields.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.ibm_ghost import GhostForcing2D, moving_ghost_forcing_2d
from cfdsim_tpu_torch.models.incompressible import StepMetrics, storage_dtype
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.solvers.autotune import resolve_poisson_config
from cfdsim_tpu_torch.solvers.helmholtz import make_mac_helmholtz
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, PoissonSolver, poisson_residual


class MACState(NamedTuple):
    """Staggered state; all tensors on one device."""

    u: torch.Tensor  # (ny, nx+1) float32 (bfloat16 under storage="bf16")
    v: torch.Tensor  # (ny+1, nx) float32 (likewise)
    p: torch.Tensor  # (ny, nx) float32
    t: torch.Tensor  # 0-dim float32
    step: torch.Tensor  # 0-dim int32


@dataclasses.dataclass(frozen=True)
class MACConfig:
    """Static configuration: the JAX package's fields and defaults.

    projection: "chorin" (solve for the full pressure) or "incremental"
        (the predictor carries ∇pⁿ, the solve yields the increment)
    diffusion: "explicit" or "implicit" (Crank–Nicolson, solved exactly by
        the MAC Helmholtz transforms; needs an implicit kit)
    time_scheme: "euler" or "rk2" (Heun, one projection per stage)
    """

    grid: Grid
    nu: float
    scheme: str = "central"  # central | upwind | tvd
    use_les: bool = False
    smagorinsky_constant: float = 0.17
    poisson: PoissonConfig = PoissonConfig(method="dct")
    projection: str = "chorin"
    diffusion: str = "explicit"
    time_scheme: str = "euler"
    # inter-step u/v storage (p stays float32: it warm-starts the solve);
    # see models/incompressible.py
    storage: str = "fp32"  # fp32 | bf16
    adaptive_dt: bool = True
    cfl_target: float = 0.5
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    warmup_steps: int = 0
    warmup_dt: float = 0.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def _field(x, shape, device, dtype=torch.float32):
    if x is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device).to(dtype).clone()


def mac_state(nx: int, ny: int, u0=None, v0=None, p0=None, *, device,
              velocity_dtype=torch.float32) -> MACState:
    """A zero state (or the given fields) of ny × nx cells on ``device``;
    u and v in ``velocity_dtype``, p in float32."""
    return MACState(
        u=_field(u0, (ny, nx + 1), device, velocity_dtype),
        v=_field(v0, (ny + 1, nx), device, velocity_dtype),
        p=_field(p0, (ny, nx), device),
        t=torch.zeros((), dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_state(cfg: MACConfig, u0=None, v0=None, p0=None, *, device) -> MACState:
    return mac_state(cfg.grid.nx, cfg.grid.ny, u0, v0, p0, device=device,
                     velocity_dtype=storage_dtype(cfg.storage))


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

class MACBCs(NamedTuple):
    """``set_normal(u, v, step, t) -> (u, v)`` writes the boundary faces
    (normal components) in place; ``extend(u, v, step, t) -> (ue, ve)``
    returns new arrays with one tangential ghost line per side (ue:
    (ny+2, nx+1), ve: (ny+1, nx+2)) encoding the tangential wall velocity by
    reflection."""

    set_normal: Callable
    extend: Callable


def _walls(u, v):
    u[:, 0] = 0.0
    u[:, -1] = 0.0
    v[0, :] = 0.0
    v[-1, :] = 0.0
    return u, v


def cavity_bcs(lid_velocity: float = 1.0) -> MACBCs:
    """Lid-driven cavity: no-slip walls, the lid moving at y_hi."""

    def set_normal(u, v, step=None, t=None):
        return _walls(u, v)

    def extend(u, v, step=None, t=None):
        ue = torch.cat([-u[:1], u, 2.0 * lid_velocity - u[-1:]], 0)
        ve = torch.cat([-v[:, :1], v, -v[:, -1:]], 1)
        return ue, ve

    return MACBCs(set_normal, extend)


def free_slip_bcs() -> MACBCs:
    """Free-slip box: zero normal velocity, zero tangential shear."""

    def set_normal(u, v, step=None, t=None):
        return _walls(u, v)

    def extend(u, v, step=None, t=None):
        ue = torch.cat([u[:1], u, u[-1:]], 0)
        ve = torch.cat([v[:, :1], v, v[:, -1:]], 1)
        return ue, ve

    return MACBCs(set_normal, extend)


def _outflow(u, v):
    """Zero-gradient outflow shifted so the outflow flux equals the inflow
    flux (the all-Neumann pressure problem's solvability), and
    no-penetration top and bottom."""
    u[:, -1] = u[:, -2] + (u[:, 0] - u[:, -2]).mean()
    v[0, :] = 0.0
    v[-1, :] = 0.0
    return u, v


def channel_bcs(u_in: float = 1.0, profile=None) -> MACBCs:
    """Channel: Dirichlet inflow at x_lo (uniform, or ``profile``, a (ny,)
    tensor on the state's device), mass-consistent zero-gradient outflow at
    x_hi, no-slip walls."""

    def set_normal(u, v, step=None, t=None):
        u[:, 0] = u_in if profile is None else profile
        return _outflow(u, v)

    def extend(u, v, step=None, t=None):
        ue = torch.cat([-u[:1], u, -u[-1:]], 0)
        ve = torch.cat([-v[:, :1], v, v[:, -1:]], 1)
        return ue, ve

    return MACBCs(set_normal, extend)


def external_flow_bcs(v_inf: float, y_face_centers, y_max: float, perturb_amp: float = 0.01,
                      perturb_ramp_steps: int = 1000, *, device) -> MACBCs:
    """External flow (the cylinder cases): perturbed inflow at x_lo (the
    shedding trigger), mass-consistent outflow at x_hi, free-slip top and
    bottom. The perturbation follows the device-side step count."""
    y = torch.as_tensor(np.asarray(y_face_centers, dtype=np.float32), device=device)

    def set_normal(u, v, step, t=None):
        s = step.to(torch.float32)
        scale = (s / perturb_ramp_steps).clamp(max=1.0) * perturb_amp
        pert = scale * torch.sin(2.0 * math.pi * y / y_max + 0.02 * s)
        u[:, 0] = v_inf * (1.0 + pert)
        return _outflow(u, v)

    def extend(u, v, step=None, t=None):
        ue = torch.cat([u[:1], u, u[-1:]], 0)  # free slip: ∂u/∂y = 0
        ve = torch.cat([-v[:, :1], v, v[:, -1:]], 1)  # inflow v = 0; outflow ∂v/∂x = 0
        return ue, ve

    return MACBCs(set_normal, extend)


class MACImplicitKit(NamedTuple):
    """Implicit-viscous solvers for one MACBCs family (``solve_u(b, c)``,
    ``solve_v(b, c)``: :class:`~cfdsim_tpu_torch.solvers.helmholtz.
    MacHelmholtz` modules) and the inhomogeneous-BC right-hand-side
    corrections ``rhs_fix_u(r, c, step, t)``, ``rhs_fix_v`` (which may write
    ``r`` in place)."""

    solve_u: Callable
    solve_v: Callable
    rhs_fix_u: Callable
    rhs_fix_v: Callable


def _no_fix(r, c, step, t):
    return r


def cavity_implicit_kit(grid: Grid, lid_velocity: float = 1.0, *, device) -> MACImplicitKit:
    """For ``cavity_bcs``: Dirichlet normal faces (DST-I), odd-mirror
    no-slip tangential ghosts (DST-II); the lid adds c·2·U_lid/dy² to the
    top u-row."""
    ny, nx, dx, dy = grid.ny, grid.nx, grid.dx, grid.dy
    solve_u = make_mac_helmholtz((ny, nx - 1), ("dst2", "dst1"), dx, dy, device=device)
    solve_v = make_mac_helmholtz((ny - 1, nx), ("dst1", "dst2"), dx, dy, device=device)
    ay = 1.0 / (dy * dy)

    def rhs_fix_u(r, c, step, t):
        r[-1, :] += c * 2.0 * lid_velocity * ay
        return r

    return MACImplicitKit(solve_u, solve_v, rhs_fix_u, _no_fix)


def free_slip_implicit_kit(grid: Grid, *, device) -> MACImplicitKit:
    """For ``free_slip_bcs``: Dirichlet normal faces (DST-I), even-mirror
    tangential ghosts (DCT-II); homogeneous."""
    ny, nx, dx, dy = grid.ny, grid.nx, grid.dx, grid.dy
    solve_u = make_mac_helmholtz((ny, nx - 1), ("dct2", "dst1"), dx, dy, device=device)
    solve_v = make_mac_helmholtz((ny - 1, nx), ("dst1", "dct2"), dx, dy, device=device)
    return MACImplicitKit(solve_u, solve_v, _no_fix, _no_fix)


# ---------------------------------------------------------------------------
# advection, diffusion, diagnostics
# ---------------------------------------------------------------------------

_limited_slope = vanleer_slope  # 2·dm·dp/(dm+dp) where the signs agree, else 0


def _face_value(q_lo, q_hi, adv, slope_lo, slope_hi):
    """MUSCL upwind-biased value between samples q_lo and q_hi for the
    advecting velocity ``adv`` there; zero slopes give first-order upwind."""
    return torch.where(adv >= 0.0, q_lo + 0.5 * slope_lo, q_hi - 0.5 * slope_hi)


def _slopes_x(q):
    """Limited slopes along axis 1, zero at the two boundary columns."""
    s = _limited_slope(q[:, 1:-1] - q[:, :-2], q[:, 2:] - q[:, 1:-1])
    return F.pad(s, (1, 1))


def _slopes_y(q):
    s = _limited_slope(q[1:-1, :] - q[:-2, :], q[2:, :] - q[1:-1, :])
    return F.pad(s, (0, 0, 1, 1))


def _advect(u, v, ue, ve, dx: float, dy: float, scheme: str):
    """Divergence-form MAC advection: (conv_u, conv_v) on the interior
    u-faces (ny, nx−1) and v-faces (ny−1, nx). x-fluxes of u live at cell
    centres, y-fluxes at corners (and symmetrically for v), so each
    momentum balance telescopes."""
    uc = 0.5 * (u[:, :-1] + u[:, 1:])  # u at centres (ny, nx)
    vc = 0.5 * (v[:-1, :] + v[1:, :])  # v at centres (ny, nx)
    u_y = 0.5 * (ue[:-1, :] + ue[1:, :])  # u at corners (ny+1, nx+1)
    v_x = 0.5 * (ve[:, :-1] + ve[:, 1:])  # v at corners (ny+1, nx+1)

    if scheme == "central":
        F_u = uc * uc
        G_u = v_x * u_y
        F_v = u_y * v_x
        G_v = vc * vc
    elif scheme in ("upwind", "tvd"):
        if scheme == "tvd":
            su_x, su_y, sv_y, sv_x = _slopes_x(u), _slopes_y(ue), _slopes_y(v), _slopes_x(ve)
        else:
            su_x, su_y, sv_y, sv_x = (torch.zeros_like(q) for q in (u, ue, v, ve))
        F_u = uc * _face_value(u[:, :-1], u[:, 1:], uc, su_x[:, :-1], su_x[:, 1:])
        G_u = v_x * _face_value(ue[:-1, :], ue[1:, :], v_x, su_y[:-1, :], su_y[1:, :])
        G_v = vc * _face_value(v[:-1, :], v[1:, :], vc, sv_y[:-1, :], sv_y[1:, :])
        F_v = u_y * _face_value(ve[:, :-1], ve[:, 1:], u_y, sv_x[:, :-1], sv_x[:, 1:])
    else:
        raise ValueError(f"unknown MAC scheme {scheme!r}")

    conv_u = (F_u[:, 1:] - F_u[:, :-1]) * (1.0 / dx) + (
        G_u[1:, 1:-1] - G_u[:-1, 1:-1]) * (1.0 / dy)
    conv_v = (F_v[1:-1, 1:] - F_v[1:-1, :-1]) * (1.0 / dx) + (
        G_v[1:, :] - G_v[:-1, :]) * (1.0 / dy)
    return conv_u, conv_v


def smagorinsky_viscosity_mac(u, v, ue, ve, dx: float, dy: float, cs: float):
    """ν_t = (C_s Δ)²|S| at cell centres: the normal strains at centres,
    the shear at corners averaged back to centres."""
    delta = (dx * dy) ** 0.5
    dudx = (u[:, 1:] - u[:, :-1]) * (1.0 / dx)
    dvdy = (v[1:, :] - v[:-1, :]) * (1.0 / dy)
    dudy = (ue[1:, :] - ue[:-1, :]) * (1.0 / dy)
    dvdx = (ve[:, 1:] - ve[:, :-1]) * (1.0 / dx)
    sh = dudy + dvdx  # 2·S12 at corners
    sh_c = 0.25 * (sh[:-1, :-1] + sh[:-1, 1:] + sh[1:, :-1] + sh[1:, 1:])
    s_mag = torch.sqrt(2.0 * (dudx * dudx + dvdy * dvdy) + sh_c * sh_c)
    return (cs * delta) ** 2 * s_mag


def _diffuse_les(ue, ve, nu_eff_c, dx: float, dy: float):
    """Flux-form ∇·(ν_eff ∇u) on the interior u-faces and v-faces; ν_eff at
    cell centres, corner-averaged (edge-clamped) for the cross fluxes."""
    nu_e = F.pad(nu_eff_c[None], (1, 1, 1, 1), mode="replicate")[0]
    nu_k = 0.25 * (nu_e[:-1, :-1] + nu_e[:-1, 1:] + nu_e[1:, :-1] + nu_e[1:, 1:])
    fux = nu_eff_c * (ue[1:-1, 1:] - ue[1:-1, :-1]) * (1.0 / dx)
    lap_u_x = (fux[:, 1:] - fux[:, :-1]) * (1.0 / dx)
    fuy = nu_k * (ue[1:, :] - ue[:-1, :]) * (1.0 / dy)
    lap_u_y = (fuy[1:, 1:-1] - fuy[:-1, 1:-1]) * (1.0 / dy)
    fvy = nu_eff_c * (ve[1:, 1:-1] - ve[:-1, 1:-1]) * (1.0 / dy)
    lap_v_y = (fvy[1:, :] - fvy[:-1, :]) * (1.0 / dy)
    fvx = nu_k * (ve[:, 1:] - ve[:, :-1]) * (1.0 / dx)
    lap_v_x = (fvx[1:-1, 1:] - fvx[1:-1, :-1]) * (1.0 / dx)
    return lap_u_x + lap_u_y, lap_v_x + lap_v_y


def _diffuse(ue, ve, dx: float, dy: float):
    """5-point Laplacians on the interior u-faces and v-faces, the
    tangential wall values from the ghost lines."""
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    lap_u = (ue[1:-1, 2:] - 2.0 * ue[1:-1, 1:-1] + ue[1:-1, :-2]) * ax + (
        ue[2:, 1:-1] - 2.0 * ue[1:-1, 1:-1] + ue[:-2, 1:-1]) * ay
    lap_v = (ve[1:-1, 2:] - 2.0 * ve[1:-1, 1:-1] + ve[1:-1, :-2]) * ax + (
        ve[2:, 1:-1] - 2.0 * ve[1:-1, 1:-1] + ve[:-2, 1:-1]) * ay
    return lap_u, lap_v


def divergence_mac(u, v, dx: float, dy: float):
    """Exact discrete cell divergence (u_E−u_W)/dx + (v_N−v_S)/dy, (ny, nx)."""
    return (u[:, 1:] - u[:, :-1]) * (1.0 / dx) + (v[1:, :] - v[:-1, :]) * (1.0 / dy)


def vorticity_mac(u, v, dx: float, dy: float):
    """z-vorticity at the interior corners, (ny−1, nx−1)."""
    dvdx = (v[:, 1:] - v[:, :-1]) * (1.0 / dx)
    dudy = (u[1:, :] - u[:-1, :]) * (1.0 / dy)
    return dvdx[1:-1, :] - dudy[:, 1:-1]


def center_velocities(u, v):
    """Cell-centred (u, v) averages, for diagnostics and pictures."""
    return 0.5 * (u[:, :-1] + u[:, 1:]), 0.5 * (v[:-1, :] + v[1:, :])


def _add_interior(q, axis: int, delta):
    """q with ``delta`` added to its interior lines along ``axis`` (the
    JAX package's ``q.at[:, 1:-1].add(delta)``), in place on ``q``."""
    if axis == 1:
        q[:, 1:-1] += delta
    else:
        q[1:-1, :] += delta
    return q


def check_mac_options(storage: str = "fp32", ibm_ghost=None, ibm_mask_u=None,
                      moving_scheme="penalize") -> None:
    """Refuse the options of the MAC tiers that the JAX package refuses."""
    if ibm_ghost is not None and ibm_mask_u is not None:
        raise ValueError("ibm_ghost and ibm_mask_* are mutually exclusive")
    if moving_scheme not in ("penalize", "ghost"):
        raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
    storage_dtype(storage)


def moving_body_masks(body, Xu, Yu, Xv, Yv, taper: float, t):
    """The body's sharp face masks at time ``t`` (a device tensor): 1 inside
    with a linear taper of width ``taper``, rebuilt on the device."""
    cx, cy = body.center(t)
    r = body.radius

    def mask(X, Y):
        ex, ey = X - cx, Y - cy
        return ((r + 0.5 * taper - torch.sqrt(ex * ex + ey * ey)) / taper).clamp(0.0, 1.0)

    return mask(Xu, Yu), mask(Xv, Yv)


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------

class MACStep(nn.Module):
    """``step(state, cfl_scale) -> (state, StepMetrics)`` on the uniform
    MAC grid. Constant tables are buffers on ``device``: the Poisson
    solver's, the implicit kit's eigen-tables, the IBM face masks, the
    moving body's face coordinates and the forcing. The step reads nothing
    on the host (unless its Poisson method's streaming early exit does:
    ``reads_host``), so a chunk of steps captures into one CUDA graph."""

    def __init__(self, cfg: MACConfig, bcs: MACBCs, ibm_mask_u=None, ibm_mask_v=None,
                 ibm_ramp_steps: int = 0, forcing=None, moving_body=None,
                 implicit_kit: Optional[MACImplicitKit] = None, ibm_ghost=None,
                 moving_scheme: str = "penalize", *, device):
        super().__init__()
        check_mac_options(cfg.storage, ibm_ghost, ibm_mask_u, moving_scheme)
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown MAC time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown MAC projection {cfg.projection!r}")
        if cfg.diffusion not in ("explicit", "implicit"):
            raise ValueError(f"unknown MAC diffusion {cfg.diffusion!r}")
        if cfg.diffusion == "implicit":
            if implicit_kit is None:
                raise ValueError("diffusion='implicit' needs an implicit_kit matching the BCs "
                                 "(mac.cavity_implicit_kit / free_slip_implicit_kit)")
            if cfg.use_les:
                raise ValueError("diffusion='implicit' needs constant ν (no LES): the "
                                 "variable-ν operator is not transform-diagonalizable")
            if cfg.time_scheme != "euler":
                raise ValueError("diffusion='implicit' is Crank–Nicolson within the euler "
                                 "step; combine with time_scheme='euler'")
        g = cfg.grid
        # pin dct_variant="auto" now: the autotuner times on the device
        pois = resolve_poisson_config(cfg.poisson, (g.ny, g.nx), g.dx, g.dy, device=device)
        if pois is not cfg.poisson:
            cfg = dataclasses.replace(cfg, poisson=pois)
        self.cfg = cfg
        self.bcs = bcs
        self.device = torch.device(device)
        self.ibm_ramp_steps = ibm_ramp_steps
        self.moving_body = moving_body
        self.moving_scheme = moving_scheme
        self.ghost_u = self.ghost_v = None
        if ibm_ghost is not None:
            self.ghost_u = GhostForcing2D(ibm_ghost.u, device=device)
            self.ghost_v = GhostForcing2D(ibm_ghost.v, device=device)
        self.poisson = PoissonSolver((g.ny, g.nx), g.dx, g.dy, cfg.poisson, device=device)
        self.reads_host = self.poisson.reads_host
        self.kit = implicit_kit
        if implicit_kit is not None:  # register the solvers' buffers with the step
            self.solve_u, self.solve_v = implicit_kit.solve_u, implicit_kit.solve_v

        def buf(name, x):
            self.register_buffer(name, None if x is None else torch.as_tensor(
                np.asarray(x) if not torch.is_tensor(x) else x, dtype=torch.float32,
                device=device))

        buf("mask_u", ibm_mask_u)
        buf("mask_v", ibm_mask_v)
        buf("force_u", None if forcing is None else forcing[0])
        buf("force_v", None if forcing is None else forcing[1])
        buf("dt_base", np.float32(cfg.dt_base))
        buf("warmup_dt", np.float32(cfg.warmup_dt))
        buf("visc_num", np.float32(0.2 * min(g.dx, g.dy) ** 2))
        buf("zero", np.float32(0.0))
        self.hb = min(g.dx, g.dy)  # the moving body's taper
        if moving_body is not None:
            xu = g.x_min + np.arange(g.nx + 1) * g.dx
            yu = g.y_min + (np.arange(g.ny) + 0.5) * g.dy
            xv = g.x_min + (np.arange(g.nx) + 0.5) * g.dx
            yv = g.y_min + np.arange(g.ny + 1) * g.dy
            for names, (a, b) in ((("Xu", "Yu"), (xu, yu)), (("Xv", "Yv"), (xv, yv))):
                for name, arr in zip(names, np.meshgrid(a, b, indexing="xy")):
                    buf(name, arr.astype(np.float32))

    def _adaptive_dt(self, u, v, step, cfl_scale, nu_total=None):
        """CFL and explicit-viscous dt (LES: ν + mean ν_t in the viscous
        bound; none under implicit diffusion), clipped, with the warm-up."""
        cfg = self.cfg
        if not cfg.adaptive_dt:
            return self.dt_base
        h = min(cfg.grid.dx, cfg.grid.dy)
        vel_max = torch.maximum(u.abs().amax(), v.abs().amax()).clamp(min=1e-10)
        dt = cfg.cfl_target * cfl_scale * h / vel_max
        if cfg.diffusion != "implicit":
            if nu_total is None:
                dt = dt.clamp(max=0.2 * h * h / cfg.nu)
            else:
                dt = torch.minimum(dt, self.visc_num / nu_total)
        dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        if cfg.warmup_steps > 0:
            dt = torch.where(step < cfg.warmup_steps, self.warmup_dt, dt)
        return dt

    def _stage(self, state, u, v, ue, ve, nu_t, p_warm, t_s, dt):
        """One projected Euler stage from BC-consistent (u, v), the BCs and
        the body at stage time ``t_s``: (u_new, v_new, p, (fx, fy, div_star,
        rhs, φ)). Leaves u, v and p_warm as they were."""
        cfg = self.cfg
        g = cfg.grid
        dx, dy = g.dx, g.dy
        step = state.step
        set_normal = self.bcs.set_normal
        conv_u, conv_v = _advect(u, v, ue, ve, dx, dy, cfg.scheme)
        if cfg.use_les:
            visc_u, visc_v = _diffuse_les(ue, ve, cfg.nu + nu_t, dx, dy)
        else:
            lap_u, lap_v = _diffuse(ue, ve, dx, dy)
            visc_u, visc_v = cfg.nu * lap_u, cfg.nu * lap_v
        forcing = self.force_u is not None

        if cfg.diffusion == "implicit":
            # Crank–Nicolson: (I − c∇²)u* = u + dt(−conv + ½ν∇²u) + c·(BC
            # values), c = ½dtν, solved exactly in the mixed transform basis
            c = 0.5 * dt * cfg.nu
            ru = u[:, 1:-1] + dt * (0.5 * visc_u - conv_u)
            rv = v[1:-1, :] + dt * (0.5 * visc_v - conv_v)
            if forcing:
                ru = ru + dt * self.force_u[:, 1:-1]
                rv = rv + dt * self.force_v[1:-1, :]
            if cfg.projection == "incremental":
                # the lagged pressure gradient belongs in the Helmholtz rhs
                ru = ru - dt * (p_warm[:, 1:] - p_warm[:, :-1]) * (1.0 / dx)
                rv = rv - dt * (p_warm[1:, :] - p_warm[:-1, :]) * (1.0 / dy)
            ru = self.kit.rhs_fix_u(ru, c, step, t_s)
            rv = self.kit.rhs_fix_v(rv, c, step, t_s)
            u_star = u.clone()
            v_star = v.clone()
            u_star[:, 1:-1] = self.solve_u(ru, c)
            v_star[1:-1, :] = self.solve_v(rv, c)
        else:
            u_star = _add_interior(u.clone(), 1, dt * (visc_u - conv_u))
            v_star = _add_interior(v.clone(), 0, dt * (visc_v - conv_v))
        if cfg.projection == "incremental" and cfg.diffusion != "implicit":
            # the predictor carries the lagged pressure gradient; the
            # projection then solves for the increment
            _add_interior(u_star, 1, -dt * (p_warm[:, 1:] - p_warm[:, :-1]) * (1.0 / dx))
            _add_interior(v_star, 0, -dt * (p_warm[1:, :] - p_warm[:-1, :]) * (1.0 / dy))
        if forcing and cfg.diffusion != "implicit":
            u_star = u_star + dt * self.force_u
            v_star = v_star + dt * self.force_v
        u_star, v_star = set_normal(u_star, v_star, step, t_s)

        fx = fy = self.zero
        cell = dx * dy
        if self.mask_u is not None:
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            du_ibm = u_star * (strength * self.mask_u)
            dv_ibm = v_star * (strength * self.mask_v)
            u_star = u_star - du_ibm
            v_star = v_star - dv_ibm
            if cfg.compute_metrics:
                # the force on the body: the penalization's momentum sink
                fx = du_ibm.sum() * cell / dt
                fy = dv_ibm.sum() * cell / dt
        if self.ghost_u is not None:
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            u_star, du_g = self.ghost_u(u_star, strength)
            v_star, dv_g = self.ghost_v(v_star, strength)
            if cfg.compute_metrics:
                fx = du_g.sum() * cell / dt
                fy = dv_g.sum() * cell / dt
        if self.moving_body is not None:
            ub, vb = self.moving_body.velocity(t_s)
            strength = ibm_ramp(step, self.ibm_ramp_steps)
            if self.moving_scheme == "ghost":
                ctr = self.moving_body.center(t_s)
                r, delta = self.moving_body.radius, 1.5 * self.hb
                u_star, du_mb = moving_ghost_forcing_2d(
                    u_star, self.Xu, self.Yu, g.x_min, dx, g.y_min + 0.5 * dy, dy, ctr, r, delta,
                    ub, strength)
                v_star, dv_mb = moving_ghost_forcing_2d(
                    v_star, self.Xv, self.Yv, g.x_min + 0.5 * dx, dx, g.y_min, dy, ctr, r, delta,
                    vb, strength)
            else:
                m_u, m_v = moving_body_masks(self.moving_body, self.Xu, self.Yu, self.Xv,
                                             self.Yv, self.hb, t_s)
                du_mb = (u_star - ub) * (strength * m_u)
                dv_mb = (v_star - vb) * (strength * m_v)
                u_star = u_star - du_mb
                v_star = v_star - dv_mb
            if cfg.compute_metrics:
                fx = fx + du_mb.sum() * cell / dt
                fy = fy + dv_mb.sum() * cell / dt

        # exact projection: the MAC divergence/gradient pair is adjoint
        div_star = divergence_mac(u_star, v_star, dx, dy)
        rhs = div_star / dt
        if cfg.poisson.method not in ("dct", "fft"):
            rhs = rhs - rhs.mean()  # Neumann solvability for the iterative solvers
        warm = torch.zeros_like(p_warm) if cfg.projection == "incremental" else p_warm
        phi = self.poisson(warm, rhs)
        u_new = _add_interior(u_star, 1, -dt * (phi[:, 1:] - phi[:, :-1]) * (1.0 / dx))
        v_new = _add_interior(v_star, 0, -dt * (phi[1:, :] - phi[:-1, :]) * (1.0 / dy))
        u_new, v_new = set_normal(u_new, v_new, step, t_s)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        p_out = p_warm + phi if cfg.projection == "incremental" else phi
        return u_new, v_new, p_out, (fx, fy, div_star, rhs, phi)

    def forward(self, state: MACState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy = g.dx, g.dy
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        bcs = self.bcs
        # float32 copies of the fields (under bf16 storage, the upcast)
        u, v = bcs.set_normal(state.u.to(torch.float32, copy=True),
                              state.v.to(torch.float32, copy=True), state.step, state.t)
        ue, ve = bcs.extend(u, v, state.step, state.t)
        nu_t = nu_total = None
        if cfg.use_les:
            nu_t = smagorinsky_viscosity_mac(u, v, ue, ve, dx, dy, cfg.smagorinsky_constant)
            nu_total = cfg.nu + nu_t.mean()
        dt = self._adaptive_dt(u, v, state.step, cfl_scale, nu_total)

        u_new, v_new, p, (fx, fy, div_star, rhs, phi_solve) = self._stage(
            state, u, v, ue, ve, nu_t, state.p, state.t, dt)
        if cfg.time_scheme == "rk2":
            # Heun: average the start state with a second projected stage from
            # the first one's result (both solenoidal, so is the average); ν_t
            # is refreshed from stage 1
            t2 = state.t + dt
            ue1, ve1 = bcs.extend(u_new, v_new, state.step, t2)
            if cfg.use_les:
                nu_t = smagorinsky_viscosity_mac(u_new, v_new, ue1, ve1, dx, dy,
                                                 cfg.smagorinsky_constant)
            u2, v2, p2, (fx2, fy2, div_star, rhs, phi_solve) = self._stage(
                state, u_new, v_new, ue1, ve1, nu_t, p, t2, dt)
            u_new, v_new = bcs.set_normal(0.5 * (u + u2), 0.5 * (v + v2), state.step, t2)
            p = 0.5 * (p + p2)
            fx = 0.5 * (fx + fx2)
            fy = 0.5 * (fy + fy2)

        u_out, v_out = u_new, v_new
        if cfg.storage == "bf16":
            # round once a step; the metrics below read the float32 fields
            u_out, v_out = u_new.to(torch.bfloat16), v_new.to(torch.bfloat16)
        new_state = MACState(u=u_out, v=v_out, p=p, t=state.t + dt, step=state.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_state, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                          zero)
        div_post = divergence_mac(u_new, v_new, dx, dy)
        ucc, vcc = center_velocities(u_new, v_new)
        vort = vorticity_mac(u_new, v_new, dx, dy)
        return new_state, StepMetrics(
            dt=dt,
            div_pre=div_star.abs().amax(),
            div_post=div_post.abs().amax(),  # no frame: the projection is exact to the wall
            max_vel=torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            energy=(0.5 * (ucc * ucc + vcc * vcc)).mean(),
            vort_max=vort.abs().amax(),
            poisson_res=poisson_residual(phi_solve, rhs, dx, dy, None, "neumann"),
            fx=fx,
            fy=fy,
            fz=zero,
        )


def make_step(cfg: MACConfig, bcs: MACBCs, ibm_mask_u=None, ibm_mask_v=None,
              ibm_ramp_steps: int = 0, forcing: Optional[tuple] = None, moving_body=None,
              implicit_kit: Optional[MACImplicitKit] = None, ibm_ghost=None,
              moving_scheme: str = "penalize", *, device) -> MACStep:
    """Build the step module on ``device``: ``ibm_mask_u``/``ibm_mask_v``
    are face-sampled penalization masks; ``forcing`` an optional (fu, fv)
    face-located body force; ``ibm_ghost`` (``ibm_ghost.GhostIBM2D``) the
    sharp-interface ghost-cell IBM of a static body (mutually exclusive
    with the masks; the same momentum-exchange forces); ``moving_body``
    (``ibm.MovingBody``) the moving-geometry IBM, its sharp face masks
    (or, with ``moving_scheme="ghost"``, its ghost-cell stencils) rebuilt
    on the device from ``center(t)`` every stage and the fluid driven
    toward the body's velocity, the exchanged momentum reported as (fx,
    fy); under rk2 the second stage takes the BCs and the body at t + dt."""
    return MACStep(cfg, bcs, ibm_mask_u, ibm_mask_v, ibm_ramp_steps, forcing, moving_body,
                   implicit_kit, ibm_ghost, moving_scheme, device=device)
