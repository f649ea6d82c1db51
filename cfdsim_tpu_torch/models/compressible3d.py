"""3D compressible Euler finite-volume solver
(``cfdsim_tpu.models.compressible3d``).

The 3D extension of ``models/compressible.py``: U = (ρ, ρu, ρv, ρw, ρE),
component-leading, shape (5, nz, ny, nx), with dimension-split whole-face
fluxes from the dimension-generic Riemann solvers
(``solvers/riemann.py::FLUXES_ND``), acoustic CFL dt over all three
directions, positivity floors, optional SSP-RK2 and MUSCL reconstruction
per sweep direction. Only the full interior updates: the one-cell frame is
ghost space the BCs own (the interior mask is a buffer). The step reads
nothing on the host, so a chunk of steps captures into one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.models.compressible import CompressibleMetrics, _floors, _muscl_faces
from cfdsim_tpu_torch.ops.limiters import SLOPE_LIMITERS
from cfdsim_tpu_torch.solvers.riemann import FLUXES_ND, cons_to_prim_nd, sound_speed


class Compressible3DState(NamedTuple):
    U: torch.Tensor  # (5, nz, ny, nx)
    t: torch.Tensor
    step: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Compressible3DConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    grid: Grid3D
    gamma: float = 1.4
    flux: str = "hllc"  # rusanov | hllc | roe
    reconstruction: str = "none"  # none | muscl
    limiter: str = "minmod"
    cfl: float = 0.3
    time_order: int = 1
    eps: float = 1e-8
    rho_min: float = 1e-8
    p_min: float = 1e-8
    max_val: float = 1e3
    compute_metrics: bool = True


def prim_to_cons_3d(rho, u, v, w, p, gamma: float):
    E = p / ((gamma - 1.0) * rho) + 0.5 * (u * u + v * v + w * w)
    return torch.stack([rho, rho * u, rho * v, rho * w, rho * E])


def init_state(cfg: Compressible3DConfig, U0, *, device) -> Compressible3DState:
    """``U0`` (5, nz, ny, nx), numpy or tensor, as float32 on ``device``."""
    U = torch.as_tensor(np.asarray(U0) if not torch.is_tensor(U0) else U0,
                        dtype=torch.float32, device=device).clone()
    return Compressible3DState(U=U, t=torch.zeros((), dtype=torch.float32, device=device),
                               step=torch.zeros((), dtype=torch.int32, device=device))


def acoustic_dt_3d(cfg: Compressible3DConfig, U, cfl_scale):
    rho, vels, p = cons_to_prim_nd(U, cfg.gamma, cfg.eps, cfg.max_val)
    a = sound_speed(rho, p, cfg.gamma, cfg.eps)
    g = cfg.grid
    dt = None
    for h, vel in zip((g.dx, g.dy, g.dz), vels):
        s = (vel.abs() + a).amax().clamp(max=cfg.max_val)
        d = h / s.clamp(min=cfg.eps)
        dt = d if dt is None else torch.minimum(dt, d)
    return (cfg.cfl * cfl_scale * dt).to(torch.float32)


def _face_states(cfg: Compressible3DConfig, U, sp_axis: int):
    """(UL, UR) at faces along spatial axis (0=z, 1=y, 2=x → tensor axis+1)."""
    arr_axis = sp_axis + 1
    n = U.shape[arr_axis]
    if cfg.reconstruction == "none":
        return U.narrow(arr_axis, 0, n - 1), U.narrow(arr_axis, 1, n - 1)
    limiter = SLOPE_LIMITERS[cfg.limiter]
    rho, vels, p = cons_to_prim_nd(U, cfg.gamma, cfg.eps, cfg.max_val)
    faces = [_muscl_faces(q, sp_axis, limiter) for q in (rho, *vels, p)]
    rL, rR = faces[0]
    pL, pR = faces[-1]
    rL = rL.clamp(min=cfg.rho_min)
    rR = rR.clamp(min=cfg.rho_min)
    pL = pL.clamp(min=cfg.p_min)
    pR = pR.clamp(min=cfg.p_min)
    vL = [f[0] for f in faces[1:-1]]
    vR = [f[1] for f in faces[1:-1]]
    return (prim_to_cons_3d(rL, vL[0], vL[1], vL[2], pL, cfg.gamma),
            prim_to_cons_3d(rR, vR[0], vR[1], vR[2], pR, cfg.gamma))


class Compressible3DStep(nn.Module):
    """``step(state, cfl_scale) -> (state, CompressibleMetrics)``; the
    interior mask and the solid's momentum mask are buffers on ``device``."""

    def __init__(self, cfg: Compressible3DConfig, bc_fn: Callable, zero_momentum_mask=None, *,
                 device):
        super().__init__()
        if cfg.flux not in FLUXES_ND:
            raise ValueError(f"unknown flux {cfg.flux!r}; one of {sorted(FLUXES_ND)}")
        if cfg.reconstruction not in ("none", "muscl"):
            raise ValueError(f"unknown reconstruction {cfg.reconstruction!r}")
        g = cfg.grid
        self.cfg = cfg
        self.device = torch.device(device)
        self.bc_fn = bc_fn
        self.reads_host = False
        self.flux_fn = FLUXES_ND[cfg.flux]
        self.hs = (g.dz, g.dy, g.dx)  # spatial axes 0, 1, 2
        # the velocity component of each sweep: z → w (2), y → v (1), x → u (0)
        self.vaxes = (2, 1, 0)
        imask = np.zeros((1, g.nz, g.ny, g.nx), np.float32)
        imask[:, 1:-1, 1:-1, 1:-1] = 1.0
        self.register_buffer("imask", torch.from_numpy(imask).to(device))
        keep = None
        if zero_momentum_mask is not None:
            keep = 1.0 - torch.as_tensor(np.asarray(zero_momentum_mask), device=device).to(
                torch.float32)
        self.register_buffer("keep", keep)
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))

    def euler_update(self, U, dt):
        cfg = self.cfg
        dU = torch.zeros_like(U)
        for s in range(3):
            UL, UR = _face_states(cfg, U, s)
            F = self.flux_fn(UL, UR, cfg.gamma, self.vaxes[s], cfg.eps, cfg.max_val)
            arr_axis = s + 1
            n = F.shape[arr_axis]
            dF = (F.narrow(arr_axis, 1, n - 1) - F.narrow(arr_axis, 0, n - 1)) / self.hs[s]
            # valid for the interior cells 1..n-1 along this axis
            shape = list(dF.shape)
            shape[arr_axis] = 1
            edge = dF.new_zeros(shape)
            dU = dU + torch.cat([edge, dF, edge], dim=arr_axis)
        return _floors(U - dt * dU * self.imask, cfg.rho_min, cfg.eps, cfg.max_val)

    def forward(self, state: Compressible3DState, cfl_scale):
        cfg = self.cfg
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=state.U.device)
        bc = self.bc_fn
        U = bc(state.U, state.step, state.t)
        dt = acoustic_dt_3d(cfg, U, cfl_scale)
        if cfg.time_order == 2:
            U1 = bc(self.euler_update(U, dt), state.step, state.t)
            U_new = 0.5 * U + 0.5 * self.euler_update(U1, dt)
        else:
            U_new = self.euler_update(U, dt)
        if self.keep is not None:  # U_new is this step's own tensor
            U_new[1:4] *= self.keep
        U_new = bc(U_new, state.step + 1, state.t + dt)
        new_state = Compressible3DState(U=U_new, t=state.t + dt, step=state.step + 1)
        if not cfg.compute_metrics:
            z = self.zero
            return new_state, CompressibleMetrics(dt, z, z, z, z, z)
        rho, vels, p = cons_to_prim_nd(U_new, cfg.gamma, cfg.eps, cfg.max_val)
        a = sound_speed(rho, p, cfg.gamma, cfg.eps)
        vel = sum(w * w for w in vels).sqrt()
        return new_state, CompressibleMetrics(
            dt=dt,
            max_vel=vel.amax(),
            min_rho=U_new[0].amin(),
            min_p=p.amin(),
            energy=(0.5 * rho * vel * vel).mean(),
            max_mach=(vel / a).amax(),
        )


def make_step(cfg: Compressible3DConfig, bc_fn: Callable, zero_momentum_mask=None, *,
              device) -> Compressible3DStep:
    """``bc_fn(U, step, t) -> U`` writes ghost/edge cells into a new tensor;
    the optional mask zeroes momentum inside an embedded solid."""
    return Compressible3DStep(cfg, bc_fn, zero_momentum_mask, device=device)
