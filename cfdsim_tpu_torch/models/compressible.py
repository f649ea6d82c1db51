"""Compressible Euler finite-volume solver, shock-capturing
(``cfdsim_tpu.models.compressible``).

The reference's shockwave family: the Mach-2 wedge with HLLC/Roe fluxes
(``ShockwaveSolver`` v1_shock.py:225-328) and the Mach-2.5 supersonic
cavity with Rusanov fluxes, ghost cells and artificial viscosity
(``CavityFlowSolver`` cavity_flow_v1.py:248-308).

The conserved state U = (ρ, ρu, ρv, ρE) is component-leading, shape (4, ny,
nx). One step: BC ghost writes → acoustic CFL dt → (optional MUSCL
reconstruction) → whole-face Riemann fluxes in both sweep directions →
conservative update with positivity floors → artificial viscosity →
solid/pinned-mask handling → BCs. ``dt`` stays a 0-dim float32 device
tensor and nothing is read on the host, so a chunk of steps captures into
one CUDA graph. A BC function returns a new tensor and never writes its
input (the state tensor a captured chunk holds).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ops.limiters import SLOPE_LIMITERS, minmod
from cfdsim_tpu_torch.solvers.riemann import FLUXES, cons_to_prim, prim_to_cons, sound_speed


class CompressibleState(NamedTuple):
    U: torch.Tensor  # (4, ny, nx)
    t: torch.Tensor
    step: torch.Tensor


class CompressibleMetrics(NamedTuple):
    dt: torch.Tensor
    max_vel: torch.Tensor
    min_rho: torch.Tensor
    min_p: torch.Tensor
    energy: torch.Tensor  # mean kinetic energy ½ρ|u|² (cavity_flow_v1.py:289)
    max_mach: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressibleConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    grid: Grid  # centering="cell"; ng ghost layers for cavity-style BCs
    gamma: float = 1.4
    flux: str = "hllc"  # rusanov | hllc | roe (textbook) | roe_ref
    reconstruction: str = "none"  # none (1st order) | muscl
    limiter: str = "minmod"  # minmod | superbee | vanleer (MUSCL slopes)
    cfl: float = 0.4
    time_order: int = 1  # 1 = forward Euler (reference), 2 = SSP-RK2 (Heun)
    eps: float = 1e-8
    rho_min: float = 1e-8
    p_min: float = 1e-8
    max_val: float = 1e3
    artificial_viscosity: float = 0.0
    compute_metrics: bool = True


def freestream(cfg: CompressibleConfig, mach: float, p=1.0, rho=1.0) -> np.ndarray:
    """Uniform freestream conserved values (ρ, ρu, 0, ρE), float32 numpy."""
    a = (cfg.gamma * p / rho) ** 0.5
    u = mach * a
    E = p / (rho * (cfg.gamma - 1.0)) + 0.5 * u * u
    return np.asarray([rho, rho * u, 0.0, rho * E], np.float32)


def init_state(cfg: CompressibleConfig, U_inf, *, device) -> CompressibleState:
    """The uniform state ``U_inf`` (4 values) on ``device``."""
    ny, nx = cfg.grid.shape
    U_inf = torch.as_tensor(np.asarray(U_inf, np.float32), device=device)
    U = U_inf[:, None, None].expand(4, ny, nx).contiguous()
    return CompressibleState(U=U, t=torch.zeros((), dtype=torch.float32, device=device),
                             step=torch.zeros((), dtype=torch.int32, device=device))


def acoustic_dt(cfg: CompressibleConfig, U, cfl_scale):
    """dt = CFL·min(dx/max(|u|+a), dy/max(|v|+a)) (parity: compute_dt
    v1_shock.py:263-275), a 0-dim float32 tensor."""
    rho, u, v, p = cons_to_prim(U, cfg.gamma, cfg.eps, cfg.max_val)
    a = sound_speed(rho, p, cfg.gamma, cfg.eps)
    sx = (u.abs() + a).amax().clamp(max=cfg.max_val)
    sy = (v.abs() + a).amax().clamp(max=cfg.max_val)
    dt_x = cfg.grid.dx / sx.clamp(min=cfg.eps)
    dt_y = cfg.grid.dy / sy.clamp(min=cfg.eps)
    return (cfg.cfl * cfl_scale * torch.minimum(dt_x, dt_y)).to(torch.float32)


def _muscl_faces(W, axis: int, limiter=minmod):
    """Slope-limited MUSCL reconstruction of a primitive tensor W (any
    number of dimensions) along ``axis`` → (W_left, W_right) at the faces
    between adjacent cells; the outermost cells have zero slope."""
    n = W.shape[axis]
    Wm = W.narrow(axis, 0, n - 2)
    Wc = W.narrow(axis, 1, n - 2)
    Wp = W.narrow(axis, 2, n - 2)
    inner = limiter(Wc - Wm, Wp - Wc)
    shape = list(W.shape)
    shape[axis] = 1
    edge = inner.new_zeros(shape)
    slope = torch.cat([edge, inner, edge], dim=axis)
    WL = (W + 0.5 * slope).narrow(axis, 0, n - 1)
    WR = (W - 0.5 * slope).narrow(axis, 1, n - 1)
    return WL, WR


def _face_states(cfg: CompressibleConfig, U, axis: int):
    """(UL, UR) conserved states at faces along ``axis`` (in the (ny, nx)
    plane: 1 = x faces, 0 = y faces; the tensor axis is +1)."""
    arr_axis = axis + 1
    n = U.shape[arr_axis]
    if cfg.reconstruction == "none":
        return U.narrow(arr_axis, 0, n - 1), U.narrow(arr_axis, 1, n - 1)
    if cfg.reconstruction == "muscl":
        limiter = SLOPE_LIMITERS[cfg.limiter]
        rho, u, v, p = cons_to_prim(U, cfg.gamma, cfg.eps, cfg.max_val)
        (rL, rR), (uL, uR), (vL, vR), (pL, pR) = (
            _muscl_faces(w, axis, limiter) for w in (rho, u, v, p))
        rL = rL.clamp(min=cfg.rho_min)
        rR = rR.clamp(min=cfg.rho_min)
        pL = pL.clamp(min=cfg.p_min)
        pR = pR.clamp(min=cfg.p_min)
        return prim_to_cons(rL, uL, vL, pL, cfg.gamma), prim_to_cons(rR, uR, vR, pR, cfg.gamma)
    raise ValueError(f"unknown reconstruction {cfg.reconstruction!r}")


def _floors(U_new, rho_min: float, eps: float, max_val: float):
    """Positivity floors on ρ and ρE, momentum clipped to ±max_val·ρ."""
    rho_f = U_new[0].clamp(min=rho_min)
    lim = max_val * rho_f
    mom = [torch.minimum(torch.maximum(U_new[i], -lim), lim) for i in range(1, U_new.shape[0] - 1)]
    return torch.stack([rho_f, *mom, torch.maximum(U_new[-1], eps * rho_f)])


class CompressibleStep(nn.Module):
    """``step(state, cfl_scale) -> (state, CompressibleMetrics)``; the masks
    and the pinned state are buffers on ``device``."""

    def __init__(self, cfg: CompressibleConfig, bc_fn: Callable, zero_momentum_mask=None,
                 pin_mask=None, pin_state=None, *, device):
        super().__init__()
        if cfg.flux not in FLUXES:
            raise ValueError(f"unknown flux {cfg.flux!r}; one of {sorted(FLUXES)}")
        if cfg.reconstruction not in ("none", "muscl"):
            raise ValueError(f"unknown reconstruction {cfg.reconstruction!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.bc_fn = bc_fn
        self.reads_host = False
        self.flux_fn = FLUXES[cfg.flux]

        def buf(x, dtype=torch.float32):
            return None if x is None else torch.as_tensor(np.asarray(x), device=device).to(dtype)

        # keep = 1 − mask: multiplies the momentum inside an embedded solid
        zm = buf(zero_momentum_mask)
        self.register_buffer("keep", None if zm is None else 1.0 - zm)
        pin = buf(pin_mask)
        self.register_buffer("pin", None if pin is None else pin[None])
        self.register_buffer("pin_state", buf(pin_state))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))

    def euler_update(self, U, dt):
        """One conservative forward-Euler update with artificial viscosity
        and positivity floors (parity: update_state v1_shock.py:211-223,
        cavity_flow_v1.py:224-244)."""
        cfg = self.cfg
        dx, dy = cfg.grid.dx, cfg.grid.dy
        UL, UR = _face_states(cfg, U, axis=1)
        F = self.flux_fn(UL, UR, cfg.gamma, 1, cfg.eps, cfg.max_val)
        dF = (F[:, :, 1:] - F[:, :, :-1]) / dx  # valid for cells 1..nx-2
        VL, VR = _face_states(cfg, U, axis=0)
        G = self.flux_fn(VL, VR, cfg.gamma, 0, cfg.eps, cfg.max_val)
        dG = (G[:, 1:, :] - G[:, :-1, :]) / dy  # valid for cells 1..ny-2

        U_new = U.clone()
        U_new[:, 1:-1, 1:-1] += -dt * (dF[:, 1:-1, :] + dG[:, :, 1:-1])
        if cfg.artificial_viscosity > 0.0:
            mom = U[1:3]
            lap = ((mom[:, 1:-1, 2:] - 2.0 * mom[:, 1:-1, 1:-1] + mom[:, 1:-1, :-2]) / (dx * dx)
                   + (mom[:, 2:, 1:-1] - 2.0 * mom[:, 1:-1, 1:-1] + mom[:, :-2, 1:-1])
                   / (dy * dy))
            U_new[1:3, 1:-1, 1:-1] += dt * cfg.artificial_viscosity * lap
        return _floors(U_new, cfg.rho_min, cfg.eps, cfg.max_val)

    def forward(self, state: CompressibleState, cfl_scale):
        cfg = self.cfg
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.U.device)
        bc = self.bc_fn
        U = bc(state.U, state.step, state.t)
        dt = acoustic_dt(cfg, U, cfl_scale)
        if cfg.time_order == 2:
            # SSP-RK2 (Heun): a convex combination of Euler updates keeps
            # the TVD property of the limited fluxes at 2nd order in time
            U1 = bc(self.euler_update(U, dt), state.step, state.t)
            U_new = 0.5 * U + 0.5 * self.euler_update(U1, dt)
        else:
            U_new = self.euler_update(U, dt)
        # U_new is this step's own tensor: the writes below touch no input
        if self.keep is not None:
            U_new[1] *= self.keep
            U_new[2] *= self.keep
        if self.pin is not None:
            U_new = U_new * (1.0 - self.pin) + self.pin_state[:, None, None] * self.pin
        U_new = bc(U_new, state.step + 1, state.t + dt)
        new_state = CompressibleState(U=U_new, t=state.t + dt, step=state.step + 1)
        if not cfg.compute_metrics:
            z = self.zero
            return new_state, CompressibleMetrics(dt, z, z, z, z, z)
        rho, u, v, p = cons_to_prim(U_new, cfg.gamma, cfg.eps, cfg.max_val)
        a = sound_speed(rho, p, cfg.gamma, cfg.eps)
        vel = (u * u + v * v).sqrt()
        return new_state, CompressibleMetrics(
            dt=dt,
            max_vel=vel.amax(),
            min_rho=U_new[0].amin(),
            min_p=p.amin(),
            energy=(0.5 * rho * vel * vel).mean(),
            max_mach=(vel / a).amax(),
        )


def make_step(cfg: CompressibleConfig, bc_fn: Callable, zero_momentum_mask=None,
              pin_mask=None, pin_state=None, *, device) -> CompressibleStep:
    """Build the step module on ``device``.

    ``bc_fn(U, step, t) -> U`` writes ghost/edge cells into a new tensor.
    ``zero_momentum_mask`` zeroes momentum inside an embedded solid (the
    reference wedge, v1_shock.py:312-313). ``pin_mask``/``pin_state`` pin
    cells to a fixed state each step (the reference's quiescent cavity
    block, cavity_flow_v1.py:165-170). Masks and ``pin_state`` may be numpy
    arrays or tensors."""
    return CompressibleStep(cfg, bc_fn, zero_momentum_mask, pin_mask, pin_state, device=device)
