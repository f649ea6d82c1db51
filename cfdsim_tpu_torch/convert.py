"""Carry a simulation state between numpy and the port.

A CFD case has no weights: its state (u, v, p, t, step, and θ for the
coupled transport state; on the staggered tiers u, v and p of three
shapes) is what moves between the JAX package and this one. Pass the JAX arrays through
``np.asarray`` on the way in and build a JAX state from the numpy dict on
the way out.
"""

from __future__ import annotations

import numpy as np
import torch

from cfdsim_tpu_torch.models.incompressible import IncompressibleState
from cfdsim_tpu_torch.models.mac import MACState
from cfdsim_tpu_torch.models.transport import CoupledState


def _fields(cls, u, v, p, t, step, device):
    def field(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return cls(u=field(u), v=field(v), p=field(p), t=torch.tensor(np.float32(t), device=device),
               step=torch.tensor(np.int32(step), device=device))


def state_from_numpy(u, v, p, t, step, device) -> IncompressibleState:
    """An :class:`IncompressibleState` on ``device`` from numpy arrays
    (fields cast to float32, ``t`` to a 0-dim float32, ``step`` to int32)."""
    return _fields(IncompressibleState, u, v, p, t, step, device)


def mac_state_from_numpy(u, v, p, t, step, device) -> MACState:
    """A :class:`MACState` on ``device`` from numpy arrays: u (ny, nx+1),
    v (ny+1, nx), p (ny, nx), cast as :func:`state_from_numpy` casts them."""
    ny, nx = np.shape(p)
    if np.shape(u) != (ny, nx + 1) or np.shape(v) != (ny + 1, nx):
        raise ValueError(f"not a MAC state: u {np.shape(u)}, v {np.shape(v)}, p {(ny, nx)}")
    return _fields(MACState, u, v, p, t, step, device)


def mac_state_to_numpy(state: MACState) -> dict:
    """:func:`state_to_numpy` of a :class:`MACState` (three field shapes)."""
    return state_to_numpy(state)


def state_to_numpy(state) -> dict:
    """``{"u", "v", "p": float32 arrays, "t": np.float32, "step": np.int32}``."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in ("u", "v", "p")}
    out["t"] = np.float32(state.t.item())
    out["step"] = np.int32(state.step.item())
    return out


def coupled_state_from_numpy(u, v, p, t, step, theta, device) -> CoupledState:
    """A :class:`CoupledState` on ``device`` from numpy arrays (the flow as
    :func:`state_from_numpy`, θ cast to float32)."""
    return CoupledState(
        flow=state_from_numpy(u, v, p, t, step, device),
        theta=torch.tensor(np.asarray(theta, dtype=np.float32), device=device),
    )


def coupled_state_to_numpy(state: CoupledState) -> dict:
    """:func:`state_to_numpy` of the flow, plus ``"theta"``."""
    out = state_to_numpy(state.flow)
    out["theta"] = state.theta.detach().cpu().numpy()
    return out
