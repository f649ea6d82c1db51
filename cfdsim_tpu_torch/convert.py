"""Carry a simulation state between numpy and the port.

A CFD case has no weights: its state (u, v, p, t, step, and θ for the
coupled transport state and the Boussinesq state; w too in 3D; on the
staggered tiers fields of several shapes) is what moves between the JAX
package and this one. Pass the JAX arrays through
``np.asarray`` on the way in and build a JAX state from the numpy dict on
the way out.
"""

from __future__ import annotations

import numpy as np
import torch

from cfdsim_tpu_torch.models.boussinesq import BoussinesqState
from cfdsim_tpu_torch.models.incompressible import IncompressibleState
from cfdsim_tpu_torch.models.incompressible3d import Incompressible3DState
from cfdsim_tpu_torch.models.mac import MACState
from cfdsim_tpu_torch.models.mac3d import MAC3DState
from cfdsim_tpu_torch.models.transport import CoupledState


def _fields(cls, t, step, device, **fields):
    def field(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return cls(**{k: field(a) for k, a in fields.items()},
               t=torch.tensor(np.float32(t), device=device),
               step=torch.tensor(np.int32(step), device=device))


def state_from_numpy(u, v, p, t, step, device) -> IncompressibleState:
    """An :class:`IncompressibleState` on ``device`` from numpy arrays
    (fields cast to float32, ``t`` to a 0-dim float32, ``step`` to int32)."""
    return _fields(IncompressibleState, t, step, device, u=u, v=v, p=p)


def mac_state_from_numpy(u, v, p, t, step, device) -> MACState:
    """A :class:`MACState` on ``device`` from numpy arrays: u (ny, nx+1),
    v (ny+1, nx), p (ny, nx), cast as :func:`state_from_numpy` casts them."""
    ny, nx = np.shape(p)
    if np.shape(u) != (ny, nx + 1) or np.shape(v) != (ny + 1, nx):
        raise ValueError(f"not a MAC state: u {np.shape(u)}, v {np.shape(v)}, p {(ny, nx)}")
    return _fields(MACState, t, step, device, u=u, v=v, p=p)


def mac_state_to_numpy(state: MACState) -> dict:
    """:func:`state_to_numpy` of a :class:`MACState` (three field shapes)."""
    return state_to_numpy(state)


def boussinesq_state_from_numpy(u, v, p, theta, t, step, device) -> BoussinesqState:
    """A :class:`BoussinesqState` on ``device`` (the MAC fields as
    :func:`mac_state_from_numpy`, θ (ny, nx) cast to float32)."""
    mac_state_from_numpy(u, v, p, t, step, "cpu")  # the shape check
    return _fields(BoussinesqState, t, step, device, u=u, v=v, p=p, theta=theta)


def state3d_from_numpy(u, v, w, p, t, step, device) -> Incompressible3DState:
    """An :class:`Incompressible3DState` on ``device``: four (nz, ny, nx)
    fields."""
    return _fields(Incompressible3DState, t, step, device, u=u, v=v, w=w, p=p)


def mac3d_state_from_numpy(u, v, w, p, t, step, device) -> MAC3DState:
    """A :class:`MAC3DState` on ``device``: u (nz, ny, nx+1), v (nz, ny+1,
    nx), w (nz+1, ny, nx), p (nz, ny, nx)."""
    nz, ny, nx = np.shape(p)
    if (np.shape(u), np.shape(v), np.shape(w)) != ((nz, ny, nx + 1), (nz, ny + 1, nx),
                                                   (nz + 1, ny, nx)):
        raise ValueError(f"not a MAC 3D state: u {np.shape(u)}, v {np.shape(v)}, "
                         f"w {np.shape(w)}, p {(nz, ny, nx)}")
    return _fields(MAC3DState, t, step, device, u=u, v=v, w=w, p=p)


def state_to_numpy(state) -> dict:
    """Every field of a flat state as a float32 array (u, v, p; θ, w where
    the state has them), with ``"t"`` as np.float32 and ``"step"`` as
    np.int32."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in state._fields
           if k not in ("t", "step")}
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
