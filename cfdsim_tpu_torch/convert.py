"""Carry a simulation state between numpy and the port.

A CFD case has no weights: its state (u, v, p, t, step, and θ for the
coupled transport states and the Boussinesq states; w too in 3D; on the
staggered tiers fields of several shapes; the conserved U of the
compressible tiers; ω̂ of the pseudo-spectral tier, complex64 here and float32
re/im planes in the JAX package; the nodal u (n_u, 2), p (n_p,) and optional
φ of the FEM tier) is what moves between the JAX
package and this one. Pass the JAX arrays through
``np.asarray`` on the way in and build a JAX state from the numpy dict on
the way out.
"""

from __future__ import annotations

import numpy as np
import torch

from cfdsim_tpu_torch.models.boussinesq import BoussinesqState
from cfdsim_tpu_torch.models.boussinesq3d import Boussinesq3DState
from cfdsim_tpu_torch.models.compressible import CompressibleState
from cfdsim_tpu_torch.models.compressible3d import Compressible3DState
from cfdsim_tpu_torch.models.fem import FEMState
from cfdsim_tpu_torch.models.incompressible import IncompressibleState
from cfdsim_tpu_torch.models.incompressible3d import Incompressible3DState
from cfdsim_tpu_torch.models.mac import MACState
from cfdsim_tpu_torch.models.mac3d import MAC3DState
from cfdsim_tpu_torch.models.spectral import SpectralState
from cfdsim_tpu_torch.models.spectral_ps import PSState
from cfdsim_tpu_torch.models.transport import CoupledState
from cfdsim_tpu_torch.models.transport3d import Transport3DState


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


def transport3d_state_from_numpy(u, v, w, p, theta, t, step, device) -> Transport3DState:
    """A :class:`Transport3DState` on ``device`` (the MAC fields as
    :func:`mac3d_state_from_numpy`, θ (nz, ny, nx) cast to float32)."""
    mac3d_state_from_numpy(u, v, w, p, t, step, "cpu")  # the shape check
    return _fields(Transport3DState, t, step, device, u=u, v=v, w=w, p=p, theta=theta)


def boussinesq3d_state_from_numpy(u, v, w, p, theta, t, step, device) -> Boussinesq3DState:
    """A :class:`Boussinesq3DState` on ``device``, as
    :func:`transport3d_state_from_numpy`."""
    mac3d_state_from_numpy(u, v, w, p, t, step, "cpu")
    return _fields(Boussinesq3DState, t, step, device, u=u, v=v, w=w, p=p, theta=theta)


def state_to_numpy(state) -> dict:
    """Every field of a flat state as a float32 array (u, v, p; θ, w where
    the state has them; a bfloat16 field, ``storage="bf16"``, upcast
    exactly), with ``"t"`` as np.float32 and ``"step"`` as np.int32."""

    def host(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()

    out = {k: host(getattr(state, k)) for k in state._fields if k not in ("t", "step")}
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


def compressible_state_from_numpy(U, t, step, device) -> CompressibleState:
    """A :class:`CompressibleState` on ``device``: U (4, ny, nx) cast to
    float32."""
    if np.ndim(U) != 3 or np.shape(U)[0] != 4:
        raise ValueError(f"not a 2D compressible state: U {np.shape(U)}")
    return _fields(CompressibleState, t, step, device, U=U)


def compressible_state_to_numpy(state: CompressibleState) -> dict:
    """``{"U", "t", "step"}`` of a :class:`CompressibleState`."""
    return state_to_numpy(state)


def compressible3d_state_from_numpy(U, t, step, device) -> Compressible3DState:
    """A :class:`Compressible3DState` on ``device``: U (5, nz, ny, nx) cast
    to float32."""
    if np.ndim(U) != 4 or np.shape(U)[0] != 5:
        raise ValueError(f"not a 3D compressible state: U {np.shape(U)}")
    return _fields(Compressible3DState, t, step, device, U=U)


def compressible3d_state_to_numpy(state: Compressible3DState) -> dict:
    """``{"U", "t", "step"}`` of a :class:`Compressible3DState`."""
    return state_to_numpy(state)


def spectral_state_from_numpy(u, v, t, step, device) -> SpectralState:
    """A stable-fluids :class:`SpectralState` on ``device``: u, v (ny, nx)
    cast to float32."""
    return _fields(SpectralState, t, step, device, u=u, v=v)


def spectral_state_to_numpy(state: SpectralState) -> dict:
    """``{"u", "v", "t", "step"}`` of a :class:`SpectralState`."""
    return state_to_numpy(state)


def ps_state_from_numpy(w_hat, t, step, device) -> PSState:
    """A :class:`PSState` on ``device`` from the JAX package's ω̂: float32
    re/im planes (2, ny, nx//2+1), made one complex64 tensor."""
    w_hat = np.asarray(w_hat, dtype=np.float32)
    if w_hat.ndim != 3 or w_hat.shape[0] != 2:
        raise ValueError(f"not re/im planes of a spectrum: {w_hat.shape}")
    re, im = (torch.tensor(a, device=device) for a in w_hat)
    return PSState(w_hat=torch.complex(re, im), t=torch.tensor(np.float32(t), device=device),
                   step=torch.tensor(np.int32(step), device=device))


def ps_state_to_numpy(state: PSState) -> dict:
    """``{"w_hat", "t", "step"}`` of a :class:`PSState`, ω̂ as the JAX
    package's float32 re/im planes (2, ny, nx//2+1)."""
    w = state.w_hat.detach().cpu()
    return {"w_hat": torch.stack([w.real, w.imag]).numpy(),
            "t": np.float32(state.t.item()), "step": np.int32(state.step.item())}


def fem_state_from_numpy(u, p, t, step, device, phi=None, dtype=torch.float32) -> FEMState:
    """A :class:`FEMState` on ``device``: u (n_u, 2), p (n_p,) and, for the
    projection scheme, φ (n_p,) cast to ``dtype`` (float64 for the
    ``precision="fp64"`` cases); ``t`` float32, ``step`` int32."""
    if np.ndim(u) != 2 or np.shape(u)[1] != 2 or np.ndim(p) != 1:
        raise ValueError(f"not an FEM state: u {np.shape(u)}, p {np.shape(p)}")

    def field(a):
        return None if a is None else torch.tensor(np.asarray(a), device=device).to(dtype)

    return FEMState(u=field(u), p=field(p), t=torch.tensor(np.float32(t), device=device),
                    step=torch.tensor(np.int32(step), device=device), phi=field(phi))


def fem_state_to_numpy(state: FEMState) -> dict:
    """``{"u", "p", "t", "step"}`` of a :class:`FEMState`, plus ``"phi"``
    where the state carries one."""
    out = {"u": state.u.detach().cpu().numpy(), "p": state.p.detach().cpu().numpy(),
           "t": np.float32(state.t.item()), "step": np.int32(state.step.item())}
    if state.phi is not None:
        out["phi"] = state.phi.detach().cpu().numpy()
    return out
