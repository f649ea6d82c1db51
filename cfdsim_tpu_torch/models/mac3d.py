"""3D incompressible Navier–Stokes on a staggered (MAC) grid
(``cfdsim_tpu.models.mac3d``): the 3D member of the accuracy tier.

Face velocities u (nz, ny, nx+1), v (nz, ny+1, nx), w (nz+1, ny, nx), cell
pressures (nz, ny, nx), an exactly adjoint divergence/gradient pair, and
the exact 3D DCT projection (``solvers/poisson3d.py``, ``method="dct"``):
divergence-free to float32 roundoff. Conservative advection in divergence
form (central, upwind, or TVD: MUSCL with van Leer slopes), the six
edge-centred flux interpolants shared pairwise between the momentum
equations; static Smagorinsky LES with flux-form variable-ν diffusion;
``chorin`` or ``incremental`` projection, ``euler`` or ``rk2`` (Heun)
time stepping; face-sampled penalization masks (``ibm_mask_{u,v,w}``). The
cavity's lid is at z_hi moving in +x (the ``cavity3d`` convention).

``MAC3DBCs.set_normal`` writes the boundary faces in place: the step hands
it only tensors it allocated itself (the state's fields are copied once),
so nothing the caller holds changes. ``ghosts`` returns new arrays. The
step reads nothing on the host, so a chunk of steps captures into one CUDA
graph.

Not ported (ROADMAP.md queue 1, item 17; they raise
``NotImplementedError``): ``les_model="dynamic"`` (``ops/les_dynamic.py``),
the 3D ghost-cell IBM (``ibm_ghost=``), the moving body (``moving_body=``)
and ``moving_scheme="ghost"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac import _face_value
from cfdsim_tpu_torch.ops.limiters import vanleer_slope
from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig, Poisson3DSolver, pad_edge_3d

ITEM_17 = "ROADMAP.md queue 1, item 17"


class MAC3DState(NamedTuple):
    u: torch.Tensor  # (nz, ny, nx+1)
    v: torch.Tensor  # (nz, ny+1, nx)
    w: torch.Tensor  # (nz+1, ny, nx)
    p: torch.Tensor  # (nz, ny, nx)
    t: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MAC3DConfig:
    """Static configuration (the JAX package's fields and defaults).
    ``les_model="dynamic"`` is accepted here and refused by the step."""

    grid: Grid3D
    nu: float
    scheme: str = "central"  # central | upwind | tvd
    use_les: bool = False
    smagorinsky_constant: float = 0.17
    les_model: str = "smagorinsky"  # smagorinsky | dynamic
    poisson: Poisson3DConfig = Poisson3DConfig(method="dct")
    projection: str = "chorin"  # chorin | incremental
    time_scheme: str = "euler"  # euler | rk2
    adaptive_dt: bool = True
    cfl_target: float = 0.4
    dt_base: float = 1e-3
    dt_min: float = 1e-7
    dt_max: float = 1.0
    max_velocity: float = 1e3
    compute_metrics: bool = True


def init_state(cfg: MAC3DConfig, u0=None, v0=None, w0=None, p0=None, *, device) -> MAC3DState:
    """A zero state (or the given fields) on ``device``."""
    g = cfg.grid
    nz, ny, nx = g.nz, g.ny, g.nx

    def field(x, shape):
        if x is None:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=device).clone()

    return MAC3DState(u=field(u0, (nz, ny, nx + 1)), v=field(v0, (nz, ny + 1, nx)),
                      w=field(w0, (nz + 1, ny, nx)), p=field(p0, (nz, ny, nx)),
                      t=torch.zeros((), dtype=torch.float32, device=device),
                      step=torch.zeros((), dtype=torch.int32, device=device))


class MAC3DBCs(NamedTuple):
    """``set_normal(u, v, w) -> (u, v, w)`` writes the boundary faces of
    each component in place; ``ghosts(u, v, w)`` returns the six one-sided
    ghost extensions (u_gy, u_gz, v_gx, v_gz, w_gx, w_gy), each padded by
    one layer in the named direction with the reflective tangential wall
    values."""

    set_normal: Callable
    ghosts: Callable


def _no_penetration(u, v, w):
    u[:, :, 0] = 0.0
    u[:, :, -1] = 0.0
    v[:, 0, :] = 0.0
    v[:, -1, :] = 0.0
    w[0] = 0.0
    w[-1] = 0.0
    return u, v, w


def cavity3d_bcs(lid_velocity: float = 1.0) -> MAC3DBCs:
    """Lid at z_hi moving in +x; no-slip on the other five faces."""

    def ghosts(u, v, w):
        return (torch.cat([-u[:, :1], u, -u[:, -1:]], 1),
                torch.cat([-u[:1], u, 2.0 * lid_velocity - u[-1:]], 0),
                torch.cat([-v[:, :, :1], v, -v[:, :, -1:]], 2),
                torch.cat([-v[:1], v, -v[-1:]], 0),
                torch.cat([-w[:, :, :1], w, -w[:, :, -1:]], 2),
                torch.cat([-w[:, :1], w, -w[:, -1:]], 1))

    return MAC3DBCs(_no_penetration, ghosts)


def free_slip_bcs3d() -> MAC3DBCs:
    """Free-slip (symmetry) box: zero normal velocity and zero tangential
    shear on all six faces."""

    def ghosts(u, v, w):
        return (torch.cat([u[:, :1], u, u[:, -1:]], 1),
                torch.cat([u[:1], u, u[-1:]], 0),
                torch.cat([v[:, :, :1], v, v[:, :, -1:]], 2),
                torch.cat([v[:1], v, v[-1:]], 0),
                torch.cat([w[:, :, :1], w, w[:, :, -1:]], 2),
                torch.cat([w[:, :1], w, w[:, -1:]], 1))

    return MAC3DBCs(_no_penetration, ghosts)


def external_flow_bcs3d(v_inf: float, inlet_profile=None, face_weights=None, *,
                        device) -> MAC3DBCs:
    """External flow along +x: Dirichlet inflow at x_lo (optionally scaled by
    a static (nz, ny) ``inlet_profile``), mass-consistent zero-gradient
    outflow at x_hi (the all-Neumann projection stays solvable), free slip
    on the four lateral faces. ``face_weights`` (the (nz, ny) x-face areas
    of a stretched grid) weights the outflow shift by area. Both tables go
    onto ``device``, the state's."""
    profile = fw = None
    if inlet_profile is not None:
        profile = torch.as_tensor(np.asarray(inlet_profile, np.float32), device=device)
    if face_weights is not None:
        fw = torch.as_tensor(np.asarray(face_weights, np.float32), device=device)
        fw = fw / fw.sum()

    def set_normal(u, v, w):
        u[:, :, 0] = v_inf if profile is None else v_inf * profile
        if fw is None:
            shift = (u[:, :, 0] - u[:, :, -2]).mean()
        else:
            shift = (fw * (u[:, :, 0] - u[:, :, -2])).sum()
        u[:, :, -1] = u[:, :, -2] + shift
        v[:, 0, :] = 0.0
        v[:, -1, :] = 0.0
        w[0] = 0.0
        w[-1] = 0.0
        return u, v, w

    def ghosts(u, v, w):
        return (torch.cat([u[:, :1], u, u[:, -1:]], 1),
                torch.cat([u[:1], u, u[-1:]], 0),
                torch.cat([-v[:, :, :1], v, v[:, :, -1:]], 2),
                torch.cat([v[:1], v, v[-1:]], 0),
                torch.cat([-w[:, :, :1], w, w[:, :, -1:]], 2),
                torch.cat([w[:, :1], w, w[:, -1:]], 1))

    return MAC3DBCs(set_normal, ghosts)


def _to_centres(e, ax1: int, ax2: int):
    """An edge-centred field averaged back to cell centres over its two
    staggered axes."""
    s = 0.5 * (e.narrow(ax1, 0, e.shape[ax1] - 1) + e.narrow(ax1, 1, e.shape[ax1] - 1))
    return 0.5 * (s.narrow(ax2, 0, s.shape[ax2] - 1) + s.narrow(ax2, 1, s.shape[ax2] - 1))


def strain_magnitude_mac3d(u, v, w, ghosts, dx: float, dy: float, dz: float):
    """|S| = √(2 S_ij S_ij) at cell centres: the normal strains at centres,
    each shear sum 2S_ij on its edge set averaged back to centres."""
    u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
    sxx = (u[:, :, 1:] - u[:, :, :-1]) * (1.0 / dx)
    syy = (v[:, 1:, :] - v[:, :-1, :]) * (1.0 / dy)
    szz = (w[1:] - w[:-1]) * (1.0 / dz)
    sh_xy = (u_gy[:, 1:, :] - u_gy[:, :-1, :]) * (1.0 / dy) + (
        v_gx[:, :, 1:] - v_gx[:, :, :-1]) * (1.0 / dx)  # z-edges (nz, ny+1, nx+1)
    sh_xz = (u_gz[1:] - u_gz[:-1]) * (1.0 / dz) + (
        w_gx[:, :, 1:] - w_gx[:, :, :-1]) * (1.0 / dx)  # y-edges (nz+1, ny, nx+1)
    sh_yz = (v_gz[1:] - v_gz[:-1]) * (1.0 / dz) + (
        w_gy[:, 1:, :] - w_gy[:, :-1, :]) * (1.0 / dy)  # x-edges (nz+1, ny+1, nx)
    s2 = (2.0 * (sxx * sxx + syy * syy + szz * szz)
          + _to_centres(sh_xy * sh_xy, 1, 2)
          + _to_centres(sh_xz * sh_xz, 0, 2)
          + _to_centres(sh_yz * sh_yz, 0, 1))
    return torch.sqrt(s2)


def smagorinsky_viscosity_mac3d(u, v, w, ghosts, dx: float, dy: float, dz: float, cs: float):
    """ν_t = (C_s Δ)²|S| at cell centres, Δ = (dx dy dz)^{1/3}."""
    delta = (dx * dy * dz) ** (1.0 / 3.0)
    return (cs * delta) ** 2 * strain_magnitude_mac3d(u, v, w, ghosts, dx, dy, dz)


def _diffuse_les3d(u, v, w, ghosts, nu_eff_c, dx: float, dy: float, dz: float):
    """Flux-form ∇·(ν_eff ∇·) on the interior u/v/w faces; ν_eff at cell
    centres, edge-averaged (edge-clamped) for the cross fluxes. With a
    constant ν it is ν·:func:`diffuse3d`."""
    u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
    nu_e = pad_edge_3d(nu_eff_c)
    nu_xy = 0.25 * (nu_e[1:-1, :-1, :-1] + nu_e[1:-1, :-1, 1:]
                    + nu_e[1:-1, 1:, :-1] + nu_e[1:-1, 1:, 1:])  # (nz, ny+1, nx+1)
    nu_xz = 0.25 * (nu_e[:-1, 1:-1, :-1] + nu_e[:-1, 1:-1, 1:]
                    + nu_e[1:, 1:-1, :-1] + nu_e[1:, 1:-1, 1:])  # (nz+1, ny, nx+1)
    nu_yz = 0.25 * (nu_e[:-1, :-1, 1:-1] + nu_e[:-1, 1:, 1:-1]
                    + nu_e[1:, :-1, 1:-1] + nu_e[1:, 1:, 1:-1])  # (nz+1, ny+1, nx)
    ax, ay, az = 1.0 / dx, 1.0 / dy, 1.0 / dz

    fux = nu_eff_c * (u[:, :, 1:] - u[:, :, :-1]) * ax
    fuy = nu_xy * (u_gy[:, 1:, :] - u_gy[:, :-1, :]) * ay
    fuz = nu_xz * (u_gz[1:] - u_gz[:-1]) * az
    lap_u = ((fux[:, :, 1:] - fux[:, :, :-1]) * ax
             + (fuy[:, 1:, 1:-1] - fuy[:, :-1, 1:-1]) * ay
             + (fuz[1:, :, 1:-1] - fuz[:-1, :, 1:-1]) * az)
    fvy = nu_eff_c * (v[:, 1:, :] - v[:, :-1, :]) * ay
    fvx = nu_xy * (v_gx[:, :, 1:] - v_gx[:, :, :-1]) * ax
    fvz = nu_yz * (v_gz[1:] - v_gz[:-1]) * az
    lap_v = ((fvx[:, 1:-1, 1:] - fvx[:, 1:-1, :-1]) * ax
             + (fvy[:, 1:, :] - fvy[:, :-1, :]) * ay
             + (fvz[1:, 1:-1, :] - fvz[:-1, 1:-1, :]) * az)
    fwz = nu_eff_c * (w[1:] - w[:-1]) * az
    fwx = nu_xz * (w_gx[:, :, 1:] - w_gx[:, :, :-1]) * ax
    fwy = nu_yz * (w_gy[:, 1:, :] - w_gy[:, :-1, :]) * ay
    lap_w = ((fwx[1:-1, :, 1:] - fwx[1:-1, :, :-1]) * ax
             + (fwy[1:-1, 1:, :] - fwy[1:-1, :-1, :]) * ay
             + (fwz[1:] - fwz[:-1]) * az)
    return lap_u, lap_v, lap_w


def divergence_mac3d(u, v, w, dx: float, dy: float, dz: float):
    """The exact discrete cell divergence, (nz, ny, nx)."""
    return ((u[:, :, 1:] - u[:, :, :-1]) * (1.0 / dx)
            + (v[:, 1:, :] - v[:, :-1, :]) * (1.0 / dy)
            + (w[1:, :, :] - w[:-1, :, :]) * (1.0 / dz))


def center_velocities_3d(u, v, w):
    return (0.5 * (u[:, :, :-1] + u[:, :, 1:]), 0.5 * (v[:, :-1, :] + v[:, 1:, :]),
            0.5 * (w[:-1] + w[1:]))


def _slopes_axis(q, axis: int):
    """Van Leer MUSCL slopes along ``axis``, zero at the boundary lines."""
    n = q.shape[axis]
    qm, q0, qp = q.narrow(axis, 0, n - 2), q.narrow(axis, 1, n - 2), q.narrow(axis, 2, n - 2)
    s = vanleer_slope(q0 - qm, qp - q0)
    pads = [0] * (2 * q.ndim)
    pads[2 * (q.ndim - 1 - axis)] = pads[2 * (q.ndim - 1 - axis) + 1] = 1
    return F.pad(s, pads)


def advect3d(u, v, w, ghosts, dx: float, dy: float, dz: float, scheme: str = "central"):
    """Conservative divergence-form 3D MAC advection (central, or upwind /
    van Leer MUSCL face values as the 2D ``mac._advect``): (conv_u, conv_v,
    conv_w) on the interior faces."""
    u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
    u_y = 0.5 * (u_gy[:, :-1, :] + u_gy[:, 1:, :])  # (nz, ny+1, nx+1)
    v_x = 0.5 * (v_gx[:, :, :-1] + v_gx[:, :, 1:])  # (nz, ny+1, nx+1)
    u_z = 0.5 * (u_gz[:-1] + u_gz[1:])  # (nz+1, ny, nx+1)
    w_x = 0.5 * (w_gx[:, :, :-1] + w_gx[:, :, 1:])  # (nz+1, ny, nx+1)
    v_z = 0.5 * (v_gz[:-1] + v_gz[1:])  # (nz+1, ny+1, nx)
    w_y = 0.5 * (w_gy[:, :-1, :] + w_gy[:, 1:, :])  # (nz+1, ny+1, nx)
    uc, vc, wc = center_velocities_3d(u, v, w)

    if scheme == "central":
        F_u, G_u, H_u = uc * uc, v_x * u_y, w_x * u_z
        F_v, G_v, H_v = u_y * v_x, vc * vc, w_y * v_z
        F_w, G_w, H_w = u_z * w_x, v_z * w_y, wc * wc
    elif scheme in ("upwind", "tvd"):
        if scheme == "tvd":
            sux, suy, suz = _slopes_axis(u, 2), _slopes_axis(u_gy, 1), _slopes_axis(u_gz, 0)
            svx, svy, svz = _slopes_axis(v_gx, 2), _slopes_axis(v, 1), _slopes_axis(v_gz, 0)
            swx, swy, swz = _slopes_axis(w_gx, 2), _slopes_axis(w_gy, 1), _slopes_axis(w, 0)
        else:
            sux, suy, suz, svx, svy, svz, swx, swy, swz = (
                torch.zeros_like(q) for q in (u, u_gy, u_gz, v_gx, v, v_gz, w_gx, w_gy, w))
        fv = _face_value
        F_u = uc * fv(u[:, :, :-1], u[:, :, 1:], uc, sux[:, :, :-1], sux[:, :, 1:])
        G_u = v_x * fv(u_gy[:, :-1, :], u_gy[:, 1:, :], v_x, suy[:, :-1, :], suy[:, 1:, :])
        H_u = w_x * fv(u_gz[:-1], u_gz[1:], w_x, suz[:-1], suz[1:])
        F_v = u_y * fv(v_gx[:, :, :-1], v_gx[:, :, 1:], u_y, svx[:, :, :-1], svx[:, :, 1:])
        G_v = vc * fv(v[:, :-1, :], v[:, 1:, :], vc, svy[:, :-1, :], svy[:, 1:, :])
        H_v = w_y * fv(v_gz[:-1], v_gz[1:], w_y, svz[:-1], svz[1:])
        F_w = u_z * fv(w_gx[:, :, :-1], w_gx[:, :, 1:], u_z, swx[:, :, :-1], swx[:, :, 1:])
        G_w = v_z * fv(w_gy[:, :-1, :], w_gy[:, 1:, :], v_z, swy[:, :-1, :], swy[:, 1:, :])
        H_w = wc * fv(w[:-1], w[1:], wc, swz[:-1], swz[1:])
    else:
        raise ValueError(f"unknown MAC3D scheme {scheme!r}")
    conv_u = ((F_u[:, :, 1:] - F_u[:, :, :-1]) * (1.0 / dx)
              + (G_u[:, 1:, 1:-1] - G_u[:, :-1, 1:-1]) * (1.0 / dy)
              + (H_u[1:, :, 1:-1] - H_u[:-1, :, 1:-1]) * (1.0 / dz))
    conv_v = ((F_v[:, 1:-1, 1:] - F_v[:, 1:-1, :-1]) * (1.0 / dx)
              + (G_v[:, 1:, :] - G_v[:, :-1, :]) * (1.0 / dy)
              + (H_v[1:, 1:-1, :] - H_v[:-1, 1:-1, :]) * (1.0 / dz))
    conv_w = ((F_w[1:-1, :, 1:] - F_w[1:-1, :, :-1]) * (1.0 / dx)
              + (G_w[1:-1, 1:, :] - G_w[1:-1, :-1, :]) * (1.0 / dy)
              + (H_w[1:, :, :] - H_w[:-1, :, :]) * (1.0 / dz))
    return conv_u, conv_v, conv_w


def diffuse3d(u, v, w, ghosts, dx: float, dy: float, dz: float):
    """7-point Laplacians on the interior faces with the ghost extensions:
    (lap_u, lap_v, lap_w)."""
    u_gy, u_gz, v_gx, v_gz, w_gx, w_gy = ghosts
    ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
    uc, vc, wc = u[:, :, 1:-1], v[:, 1:-1, :], w[1:-1]
    lap_u = ((u[:, :, 2:] - 2 * uc + u[:, :, :-2]) * ax
             + (u_gy[:, 2:, 1:-1] - 2 * uc + u_gy[:, :-2, 1:-1]) * ay
             + (u_gz[2:, :, 1:-1] - 2 * uc + u_gz[:-2, :, 1:-1]) * az)
    lap_v = ((v_gx[:, 1:-1, 2:] - 2 * vc + v_gx[:, 1:-1, :-2]) * ax
             + (v[:, 2:, :] - 2 * vc + v[:, :-2, :]) * ay
             + (v_gz[2:, 1:-1, :] - 2 * vc + v_gz[:-2, 1:-1, :]) * az)
    lap_w = ((w_gx[1:-1, :, 2:] - 2 * wc + w_gx[1:-1, :, :-2]) * ax
             + (w_gy[1:-1, 2:, :] - 2 * wc + w_gy[1:-1, :-2, :]) * ay
             + (w[2:] - 2 * wc + w[:-2]) * az)
    return lap_u, lap_v, lap_w


class MAC3DStep(nn.Module):
    """``step(state, cfl_scale) -> (state, StepMetrics)`` on the 3D MAC
    grid; the Poisson solver's tables and the IBM masks are buffers on
    ``device``."""

    reads_host = False

    def __init__(self, cfg: MAC3DConfig, bcs: MAC3DBCs, ibm_mask_u=None, ibm_mask_v=None,
                 ibm_mask_w=None, ibm_ramp_steps: int = 0, moving_body=None, ibm_ghost=None,
                 moving_scheme: str = "penalize", *, device):
        super().__init__()
        if ibm_ghost is not None and ibm_mask_u is not None:
            raise ValueError("ibm_ghost and ibm_mask_* are mutually exclusive")
        if moving_scheme not in ("penalize", "ghost"):
            raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
        if cfg.scheme not in ("central", "upwind", "tvd"):
            raise ValueError(f"unknown MAC3D scheme {cfg.scheme!r}")
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown MAC3D time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown MAC3D projection {cfg.projection!r}")
        if cfg.les_model not in ("smagorinsky", "dynamic"):
            raise ValueError(f"unknown les_model {cfg.les_model!r}")
        if cfg.use_les and cfg.les_model == "dynamic":
            raise NotImplementedError(
                f"les_model='dynamic' (ops/les_dynamic.py) is not ported yet: {ITEM_17}")
        if ibm_ghost is not None or moving_scheme == "ghost":
            raise NotImplementedError(f"the 3D ghost-cell IBM is not ported yet: {ITEM_17}")
        if moving_body is not None:
            raise NotImplementedError(f"the 3D moving body is not ported yet: {ITEM_17}")
        g = cfg.grid
        self.cfg = cfg
        self.bcs = bcs
        self.device = torch.device(device)
        self.ibm_ramp_steps = ibm_ramp_steps
        self.poisson = Poisson3DSolver(g.shape, g.dx, g.dy, g.dz, cfg.poisson, device=device)
        for name, m in (("mask_u", ibm_mask_u), ("mask_v", ibm_mask_v), ("mask_w", ibm_mask_w)):
            self.register_buffer(name, None if m is None else torch.as_tensor(
                np.asarray(m) if not torch.is_tensor(m) else m, dtype=torch.float32,
                device=device))
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))

    def _stage(self, state, u, v, w, ghosts, nu_t, p_warm, dt):
        """One projected Euler stage from BC-consistent (u, v, w); leaves u,
        v, w and p_warm as they were."""
        cfg = self.cfg
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        conv_u, conv_v, conv_w = advect3d(u, v, w, ghosts, dx, dy, dz, cfg.scheme)
        if cfg.use_les:
            visc_u, visc_v, visc_w = _diffuse_les3d(u, v, w, ghosts, cfg.nu + nu_t, dx, dy, dz)
        else:
            lap_u, lap_v, lap_w = diffuse3d(u, v, w, ghosts, dx, dy, dz)
            visc_u, visc_v, visc_w = cfg.nu * lap_u, cfg.nu * lap_v, cfg.nu * lap_w
        u_star, v_star, w_star = u.clone(), v.clone(), w.clone()
        u_star[:, :, 1:-1] += dt * (visc_u - conv_u)
        v_star[:, 1:-1, :] += dt * (visc_v - conv_v)
        w_star[1:-1] += dt * (visc_w - conv_w)
        if cfg.projection == "incremental":
            u_star[:, :, 1:-1] += -dt * (p_warm[:, :, 1:] - p_warm[:, :, :-1]) * (1.0 / dx)
            v_star[:, 1:-1, :] += -dt * (p_warm[:, 1:, :] - p_warm[:, :-1, :]) * (1.0 / dy)
            w_star[1:-1] += -dt * (p_warm[1:] - p_warm[:-1]) * (1.0 / dz)
        u_star, v_star, w_star = self.bcs.set_normal(u_star, v_star, w_star)

        fx = fy = fz = self.zero
        if self.mask_u is not None:
            strength = ibm_ramp(state.step, self.ibm_ramp_steps)
            du_ibm = u_star * (strength * self.mask_u)
            dv_ibm = v_star * (strength * self.mask_v)
            dw_ibm = w_star * (strength * self.mask_w)
            u_star, v_star, w_star = u_star - du_ibm, v_star - dv_ibm, w_star - dw_ibm
            if cfg.compute_metrics:
                # the force on the body: the penalization's momentum sink
                cell = dx * dy * dz
                fx = du_ibm.sum() * cell / dt
                fy = dv_ibm.sum() * cell / dt
                fz = dw_ibm.sum() * cell / dt

        # exact projection
        div_star = divergence_mac3d(u_star, v_star, w_star, dx, dy, dz)
        rhs = div_star / dt
        if cfg.poisson.method != "dct":
            rhs = rhs - rhs.mean()
        warm = torch.zeros_like(p_warm) if cfg.projection == "incremental" else p_warm
        phi = self.poisson(warm, rhs)
        u_star[:, :, 1:-1] += -dt * (phi[:, :, 1:] - phi[:, :, :-1]) * (1.0 / dx)
        v_star[:, 1:-1, :] += -dt * (phi[:, 1:, :] - phi[:, :-1, :]) * (1.0 / dy)
        w_star[1:-1] += -dt * (phi[1:] - phi[:-1]) * (1.0 / dz)
        u_new, v_new, w_new = self.bcs.set_normal(u_star, v_star, w_star)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        w_new = w_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        if cfg.projection == "incremental":
            phi = p_warm + phi
        return u_new, v_new, w_new, phi, (fx, fy, fz, div_star)

    def forward(self, state: MAC3DState, cfl_scale):
        cfg = self.cfg
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        h = min(dx, dy, dz)
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.u.device)
        bcs = self.bcs
        u, v, w = bcs.set_normal(state.u.clone(), state.v.clone(), state.w.clone())
        ghosts = bcs.ghosts(u, v, w)
        nu_t = None
        if cfg.use_les:
            nu_t = smagorinsky_viscosity_mac3d(u, v, w, ghosts, dx, dy, dz,
                                               cfg.smagorinsky_constant)
        if cfg.adaptive_dt:
            vel_max = torch.maximum(torch.maximum(u.abs().amax(), v.abs().amax()),
                                    w.abs().amax().clamp(min=1e-10))
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            if cfg.use_les:
                dt_visc = 0.125 * h * h / (cfg.nu + nu_t.mean())  # h²/6ν with a margin
                dt = torch.minimum(dt_cfl, dt_visc)
            else:
                dt = dt_cfl.clamp(max=0.125 * h * h / cfg.nu)
            dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        u_new, v_new, w_new, phi, (fx, fy, fz, div_star) = self._stage(
            state, u, v, w, ghosts, nu_t, state.p, dt)
        if cfg.time_scheme == "rk2":
            # Heun: the average with a second projected stage (both solenoidal,
            # so is the average); ν_t refreshed from stage 1
            ghosts1 = bcs.ghosts(u_new, v_new, w_new)
            if cfg.use_les:
                nu_t = smagorinsky_viscosity_mac3d(u_new, v_new, w_new, ghosts1, dx, dy, dz,
                                                   cfg.smagorinsky_constant)
            u2, v2, w2, phi2, (fx2, fy2, fz2, div_star) = self._stage(
                state, u_new, v_new, w_new, ghosts1, nu_t, phi, dt)
            u_new, v_new, w_new = bcs.set_normal(0.5 * (u + u2), 0.5 * (v + v2), 0.5 * (w + w2))
            phi = 0.5 * (phi + phi2)
            fx, fy, fz = 0.5 * (fx + fx2), 0.5 * (fy + fy2), 0.5 * (fz + fz2)

        new_state = MAC3DState(u=u_new, v=v_new, w=w_new, p=phi, t=state.t + dt,
                               step=state.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_state, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                          zero)
        div_post = divergence_mac3d(u_new, v_new, w_new, dx, dy, dz)
        ucc, vcc, wcc = center_velocities_3d(u_new, v_new, w_new)
        # ω_x at the interior x-edges: one vorticity component as the rotation
        # diagnostic
        dwdy = ((w_new[:, 1:, :] - w_new[:, :-1, :]) * (1.0 / dy))[1:-1]
        dvdz = ((v_new[1:] - v_new[:-1]) * (1.0 / dz))[:, 1:-1, :]
        return new_state, StepMetrics(
            dt=dt,
            div_pre=div_star.abs().amax(),
            div_post=div_post.abs().amax(),
            max_vel=torch.maximum(torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                                  w_new.abs().amax()),
            energy=(0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)).mean(),
            vort_max=(dwdy - dvdz).abs().amax(),
            poisson_res=zero,
            fx=fx,
            fy=fy,
            fz=fz,
        )


def make_step(cfg: MAC3DConfig, bcs: MAC3DBCs, ibm_mask_u=None, ibm_mask_v=None,
              ibm_mask_w=None, ibm_ramp_steps: int = 0, moving_body=None, ibm_ghost=None,
              moving_scheme: str = "penalize", *, device) -> MAC3DStep:
    """Build the step module on ``device``. ``ibm_mask_{u,v,w}`` are
    face-sampled penalization masks, the momentum each removes reported as
    the body force (fx, fy, fz)."""
    return MAC3DStep(cfg, bcs, ibm_mask_u, ibm_mask_v, ibm_mask_w, ibm_ramp_steps, moving_body,
                     ibm_ghost, moving_scheme, device=device)
