"""Sharded stepping (``cfdsim_tpu.parallel.sharded``): the library's
multi-device entry point, and distributed red-black SOR.

:func:`shard_state` cuts a single-device state into this rank's block and
:func:`make_sharded_step` maps a single-device step module to its explicit
counterpart on those blocks, with the same ``step(state, cfl_scale) ->
(state, metrics)`` call; the metrics come back global. The JAX package
jits the single-device step under GSPMD placements instead; XLA's
partitioner has no counterpart here, so every tier has a step written on
blocks (``parallel/*_explicit.py``):

=========================  ==============================================
single-device step         explicit step (this rank's blocks)
=========================  ==============================================
``IncompressibleStep``     ``explicit.py`` (the lid cavity; rbsor or DCT)
``MACStep``                ``mac_explicit.py`` on the trimmed state
``MAC3DStep``              ``mac3d_explicit.py`` on the trimmed state
``PSStep``                 ``spectral_ps_explicit.py`` (full spectrum)
``CompressibleStep``       ``compressible_explicit.py``
``SpectralStep``           ``spectral_explicit.py``
``Incompressible3DStep``   ``incompressible3d_explicit.py``
``Compressible3DStep``     ``compressible3d_explicit.py``
``FEMStep``,               ``fem_explicit.py`` (element-sharded, the DOF
``FEMProjectionStep``      vectors replicated)
=========================  ==============================================

What a block step needs beyond the module (the BC closure's description,
the lid velocity, the compressible cases' ghost map, the FEM lift) is the
``explicit_spec`` the case builders of ``cases.py`` leave on the module;
a step built without one, or of any other type, raises ``ValueError``:
nothing runs the single-device step on every rank.

Distributed red-black SOR: each full sweep runs two halo exchanges, one per
colour, so the black half reads the freshly updated red values of the
neighbouring blocks: the Gauss–Seidel ordering of the single-device sweep,
with the colours taken from the *global* checkerboard and the Neumann
ghosts from clamped global edges. Plain torch: the RB-SOR kernels of
``ops/kernels`` solve one whole grid and are not on this path.
"""

from __future__ import annotations

import torch

from cfdsim_tpu_torch.parallel.halo import clamp_global_edges, global_parity, halo_exchange_edges
from cfdsim_tpu_torch.parallel.mesh import GridMesh, block_state


def rbsor_local(phi_b, rhs_b, mesh: GridMesh, ax: float, ay: float, iters: int, omega: float,
                fluid_b=None, colours=None):
    """``iters`` distributed red-black SOR sweeps of the Neumann problem on
    this rank's block: one halo exchange per colour half-sweep (edges only:
    the 5-point sweep reads no corner), clamped global edges, colours by
    global parity. ``fluid_b`` (a local bool
    block) freezes φ inside embedded solids. ``colours`` = (red, black)
    masks built once by the caller (a step builds them when it is built)."""
    denom_inv = 1.0 / (2.0 * (ax + ay))
    if colours is None:
        colours = sweep_colours(tuple(phi_b.shape), mesh, fluid_b)
    phi = phi_b
    for _ in range(iters):
        for colour in colours:
            p = clamp_global_edges(halo_exchange_edges(phi, mesh, 1), mesh, 1)
            nb = ax * (p[1:-1, 2:] + p[1:-1, :-2]) + ay * (p[2:, 1:-1] + p[:-2, 1:-1])
            phi_star = (nb - rhs_b) * denom_inv
            phi = torch.where(colour, (1.0 - omega) * phi + omega * phi_star, phi)
    return phi


def sweep_colours(local_shape, mesh: GridMesh, fluid_b=None):
    """(red, black) update masks of a local block: the global checkerboard,
    less the solid cells where ``fluid_b`` is given."""
    red = global_parity(local_shape, mesh)
    black = ~red
    if fluid_b is not None:
        red, black = red & fluid_b, black & fluid_b
    return red, black


def make_sharded_poisson(mesh: GridMesh, dx: float, dy: float, iters: int,
                         omega: float = 1.7):
    """``solve(phi_b, rhs_b) -> φ_b``: :func:`rbsor_local` for the Neumann
    pressure problem on this rank's blocks."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)

    def solve(phi_b, rhs_b):
        return rbsor_local(phi_b, rhs_b, mesh, ax, ay, iters, omega)

    return solve


# ---------------------------------------------------------------------------
# the multi-device entry point
# ---------------------------------------------------------------------------

def shard_state(state, mesh: GridMesh):
    """This rank's block of a single-device state: every field of two or
    more axes cut over its two trailing axes ((ny, nx), (nz, ny, nx), a
    (4, ny, nx) or (5, nz, ny, nx) conserved state), the scalars copied, as
    the JAX package's ``_sharding_for`` places them. Three states have
    another layout on the blocks: a MAC state (2D or 3D) is trimmed first
    (``mac_sharded.trim_state``: the last boundary face dropped, every
    field (…, ny, nx)); a pseudo-spectral state's rfft half spectrum
    becomes the full spectrum (``spectral_ps_explicit``, nx even); an FEM
    state stays whole on every rank (its steps shard the elements)."""
    from cfdsim_tpu_torch.models.fem import FEMState
    from cfdsim_tpu_torch.models.mac import MACState
    from cfdsim_tpu_torch.models.mac3d import MAC3DState
    from cfdsim_tpu_torch.models.spectral_ps import PSState

    if isinstance(state, FEMState):
        return type(state)(*(None if x is None else x.to(mesh.device).clone()
                             for x in state))
    if isinstance(state, MACState) and state.u.shape[-1] == state.p.shape[-1] + 1:
        from cfdsim_tpu_torch.parallel.mac_sharded import trim_state

        state = trim_state(state)
    if isinstance(state, MAC3DState) and state.u.shape[-1] == state.p.shape[-1] + 1:
        from cfdsim_tpu_torch.parallel.mac3d_explicit import trim_state3d

        state = trim_state3d(state)
    if isinstance(state, PSState):
        import numpy as np

        ny, m = state.w_hat.shape
        nx = 2 * (m - 1)
        w = np.fft.irfft2(state.w_hat.detach().cpu().numpy(), s=(ny, nx))
        state = state._replace(w_hat=torch.from_numpy(np.fft.fft2(w).astype(np.complex64)))
    return block_state(state, mesh)


def _spec(step, kinds):
    """The step's ``explicit_spec`` (kind, parameters), checked against the
    kinds its explicit counterpart takes."""
    spec = getattr(step, "explicit_spec", None)
    if spec is None or spec[0] not in kinds:
        got = "none" if spec is None else repr(spec[0])
        raise ValueError(f"a {type(step).__name__} has a sharded counterpart for the cases "
                         f"{sorted(kinds)} only (their builders leave its description on the "
                         f"step as explicit_spec); this one has {got}")
    return spec[1]


def make_sharded_step(step, mesh: GridMesh):
    """The explicit counterpart of the single-device step module ``step`` on
    this rank's blocks (:func:`shard_state`), built on the mesh's device:
    ``sharded(state_b, cfl_scale) -> (state_b, metrics)``, the metrics
    global. Raises ``ValueError`` for a step type with no counterpart, or a
    step whose case left no ``explicit_spec``."""
    from cfdsim_tpu_torch.models.compressible import CompressibleStep
    from cfdsim_tpu_torch.models.compressible3d import Compressible3DStep
    from cfdsim_tpu_torch.models.fem import FEMProjectionStep, FEMStep
    from cfdsim_tpu_torch.models.incompressible import IncompressibleStep
    from cfdsim_tpu_torch.models.incompressible3d import Incompressible3DStep
    from cfdsim_tpu_torch.models.mac import MACStep
    from cfdsim_tpu_torch.models.mac3d import MAC3DStep
    from cfdsim_tpu_torch.models.spectral import SpectralStep
    from cfdsim_tpu_torch.models.spectral_ps import PSStep

    dev = mesh.device
    kind = type(step)
    if kind is IncompressibleStep:
        from cfdsim_tpu_torch.parallel.explicit import make_cavity_explicit_step

        p = _spec(step, {"cavity"})
        return make_cavity_explicit_step(step.cfg, mesh, p["lid_velocity"], device=dev)
    if kind is MACStep:
        from cfdsim_tpu_torch.parallel.mac_explicit import make_cavity_mac_explicit_step

        p = _spec(step, {"cavity_mac"})
        return make_cavity_mac_explicit_step(step.cfg, mesh, p["lid_velocity"], device=dev)
    if kind is MAC3DStep:
        from cfdsim_tpu_torch.parallel.mac3d_explicit import make_cavity3d_mac_explicit_step

        p = _spec(step, {"cavity3d_mac"})
        return make_cavity3d_mac_explicit_step(step.cfg, mesh, p["lid_velocity"], device=dev)
    if kind is PSStep:
        from cfdsim_tpu_torch.parallel.spectral_ps_explicit import make_ps_explicit_step

        return make_ps_explicit_step(step.cfg, mesh, device=dev)
    if kind is CompressibleStep:
        from cfdsim_tpu_torch.parallel.compressible_explicit import make_compressible_explicit_step

        p = _spec(step, {"wedge", "cavity_supersonic"})
        return make_compressible_explicit_step(step.cfg, mesh, step.explicit_spec[0], p,
                                               device=dev)
    if kind is SpectralStep:
        from cfdsim_tpu_torch.parallel.spectral_explicit import make_spectral_explicit_step

        return make_spectral_explicit_step(step.cfg, mesh, device=dev)
    if kind is Incompressible3DStep:
        from cfdsim_tpu_torch.parallel.incompressible3d_explicit import (
            make_cavity3d_explicit_step,
        )

        p = _spec(step, {"cavity3d"})
        return make_cavity3d_explicit_step(step.cfg, mesh, p["lid_velocity"], device=dev)
    if kind is Compressible3DStep:
        from cfdsim_tpu_torch.parallel.compressible3d_explicit import (
            make_blast3d_explicit_step,
        )

        _spec(step, {"blast3d"})
        return make_blast3d_explicit_step(step.cfg, mesh, device=dev)
    if kind in (FEMStep, FEMProjectionStep):
        from cfdsim_tpu_torch.parallel import fem_explicit

        p = _spec(step, {"fem"})
        if kind is FEMStep:
            return fem_explicit.make_step(step.ops, step.cfg, p["g"], mesh, p["force_nodes"])
        return fem_explicit.make_projection_step(step.ops, step.cfg, p["g"], p["p_out_nodes"],
                                                 mesh, p["force_nodes"])
    raise ValueError(f"no sharded counterpart for a {kind.__name__} step: make_sharded_step "
                     "maps IncompressibleStep, MACStep, MAC3DStep, PSStep, CompressibleStep, "
                     "SpectralStep, Incompressible3DStep, Compressible3DStep, FEMStep and "
                     "FEMProjectionStep")
