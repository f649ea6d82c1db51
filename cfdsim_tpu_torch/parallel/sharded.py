"""Sharded stepping (``cfdsim_tpu.parallel.sharded``): the library's
multi-device entry point, and distributed red-black SOR.

:func:`shard_state` cuts a single-device state into this rank's block and
:func:`make_sharded_step` maps a single-device step module to its explicit
counterpart on those blocks, with the same ``step(state, cfl_scale) ->
(state, metrics)`` call; the metrics come back global. The JAX package
jits the single-device step under GSPMD placements instead; XLA's
partitioner has no counterpart here, so every tier has a step written on
blocks (``parallel/*_explicit.py``), and every one of the 27 cases runs at
its default options:

============================  ===========================================
single-device step            explicit step (this rank's blocks)
============================  ===========================================
``IncompressibleStep``        ``explicit.py``: the lid cavity, the channel,
                              the IBM cylinder (every pressure solve,
                              ``poisson2d_explicit.py``; the fused
                              predictor)
``CoupledStep``               ``transport_explicit.py`` (the cavity, θ)
``MACStep``                   ``mac_explicit.py``: the cavity (explicit or
                              implicit diffusion), the cylinder
                              (penalized or ghost-cell), the moving body
``StretchedMACStep``          ``mac_stretched_explicit.py``: the same three
``MAC3DStep``                 ``mac3d_explicit.py``: the cavity, the sphere
                              (penalized or ghost-cell, inlet modulation)
``StretchedMAC3DStep``        ``mac_stretched3d_explicit.py``: the cavity,
                              the sphere (any scheme, inlet modulation)
``Transport3DStep``,          ``transport3d_explicit.py`` (the heated
``StretchedTransport3DStep``  spheres, penalized or ghost-cell, any θ
                              scheme)
``BoussinesqStep``            ``boussinesq_explicit.py`` (heated cavity,
                              Rayleigh–Bénard)
``Boussinesq3DStep``          ``boussinesq3d_explicit.py`` (heated cube,
                              any flow scheme)
``PSStep``                    ``spectral_ps_explicit.py`` (full spectrum)
``CompressibleStep``          ``compressible_explicit.py``
``SpectralStep``              ``spectral_explicit.py``
``Incompressible3DStep``      ``incompressible3d_explicit.py``
``Compressible3DStep``        ``compressible3d_explicit.py``
``FEMStep``,                  ``fem_explicit.py`` (element-sharded, the DOF
``FEMProjectionStep``         vectors replicated)
============================  ===========================================

What a block step needs beyond the module (the BC's description, the lid
or inflow speed, the 3D inlet modulation, the IBM masks, the stretched
faces, the moving body, the whole-grid ghost tables, the compressible
cases' ghost map, the FEM lift) is the ``explicit_spec`` the case builders
of ``cases.py`` leave on the module; where the explicit step takes extra
blocks (IBM masks, the y rows, a solid mask), the returned step holds this
rank's blocks of them, cut once when it is built (:class:`BoundStep`).
Every pressure solve of the single-device steps, the MAC tiers'
``time_scheme="rk2"`` and ``projection="incremental"``, MAC
``diffusion="implicit"``, the static 2D and 3D ghost-cell bodies, the
spheres' inlet modulation, the heated cube's upwind/TVD flow and the
heated spheres' TVD θ pass through to the explicit steps. A step built
without an ``explicit_spec`` (by hand, not by a case builder), of any
other type, or with an option no explicit step implements (a stretched 3D
moving body with ``moving_scheme="ghost"``, which no case builds) raises
``ValueError`` naming it: nothing runs the single-device step on every
rank.

Distributed red-black SOR: each full sweep runs two halo exchanges, one per
colour, so the black half reads the freshly updated red values of the
neighbouring blocks: the Gauss–Seidel ordering of the single-device sweep,
with the colours taken from the *global* checkerboard and the Neumann
ghosts from clamped global edges. Plain torch; the unmasked Neumann sweeps
of ``rbsor_pallas`` and the multigrid smoother run kernel B on windows of
the blocks instead (``poisson2d_explicit.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

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

def _staggered(state) -> bool:
    """A state of MAC faces in the single-device layout: u one face longer
    than p along x."""
    return (hasattr(state, "u") and hasattr(state, "p") and state.u.ndim == state.p.ndim
            and state.u.shape[-1] == state.p.shape[-1] + 1)


def shard_state(state, mesh: GridMesh):
    """This rank's block of a single-device state: every field of two or
    more axes cut over its two trailing axes ((ny, nx), (nz, ny, nx), a
    (4, ny, nx) or (5, nz, ny, nx) conserved state), the scalars copied, as
    the JAX package's ``_sharding_for`` places them; a nested state (the
    transport case's ``CoupledState``) has its flow state and θ cut alike.
    Three layouts differ on the blocks: a staggered state (MAC, stretched
    MAC, Boussinesq, heated sphere; 2D or 3D) is trimmed first
    (``mac_sharded.trim_state``, ``mac3d_explicit.trim_state3d``: the last
    boundary face of each component dropped, every field the pressure's
    shape, θ cut like the pressure); a pseudo-spectral state's rfft half
    spectrum becomes the full spectrum (``spectral_ps_explicit``, nx even);
    an FEM state stays whole on every rank (its steps shard the elements)."""
    from cfdsim_tpu_torch.models.fem import FEMState
    from cfdsim_tpu_torch.models.spectral_ps import PSState

    if isinstance(state, FEMState):
        return type(state)(*(None if x is None else x.to(mesh.device).clone()
                             for x in state))
    if _staggered(state):
        if hasattr(state, "w"):
            from cfdsim_tpu_torch.parallel.mac3d_explicit import trim_state3d

            state = trim_state3d(state)
        else:
            from cfdsim_tpu_torch.parallel.mac_sharded import trim_state

            state = trim_state(state)
    if isinstance(state, PSState):
        import numpy as np

        ny, m = state.w_hat.shape
        nx = 2 * (m - 1)
        w = np.fft.irfft2(state.w_hat.detach().cpu().numpy(), s=(ny, nx))
        state = state._replace(w_hat=torch.from_numpy(np.fft.fft2(w).astype(np.complex64)))
    return block_state(state, mesh)


class BoundStep(nn.Module):
    """An explicit step that takes extra blocks (IBM masks, y rows, a solid
    mask), with this rank's blocks cut once and held:
    ``step(state, cfl_scale) -> (state, metrics)``."""

    def __init__(self, step, blocks):
        super().__init__()
        self.inner = step
        self.n_blocks = len(blocks)
        for k, b in enumerate(blocks):
            self.register_buffer(f"block{k}", b)
        self.cfg, self.device = step.cfg, step.device
        self.local_shape = step.local_shape
        self.reads_host = False
        self.collectives = True

    def forward(self, state, cfl_scale):
        return self.inner(state, cfl_scale,
                          *(getattr(self, f"block{k}") for k in range(self.n_blocks)))


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


def _bind(step, mesh: GridMesh, *fields, trim=None, rows=None):
    """``step`` with this rank's blocks of the global ``fields`` (after
    ``trim`` when given: the trimmed face masks) and, last, its ``rows`` of
    a global y vector."""
    from cfdsim_tpu_torch.parallel.mesh import local_block, local_rows

    if trim is not None:
        fields = trim(*fields)
    blocks = [local_block(np.asarray(f, np.float32), mesh) for f in fields]
    if rows is not None:
        blocks.insert(1, local_rows(np.asarray(rows, np.float32), mesh))
    return BoundStep(step, blocks)


def _sphere_step(kind, step, mesh, dev):
    """The sphere cases (uniform or stretched, heated or not; penalized or
    ghost-cell)."""
    from cfdsim_tpu_torch.parallel.mac3d_explicit import trim_face_masks3d

    p = _spec(step, {kind})
    profile = p["inlet_profile"]
    faces = tuple(p[f"{a}_faces"] for a in "xyz") if "x_faces" in p else None
    ghost = p["ibm_ghost"]
    ramp = p["ibm_ramp_steps"]
    if kind.startswith("heated_sphere"):
        from cfdsim_tpu_torch.parallel import transport3d_explicit as t3e

        if faces is None:
            s = t3e.make_heated_sphere_explicit_step(
                step.cfg, mesh, p["v_inf"], ramp, ghost, p["ibm_ghost_c"], device=dev)
        else:
            s = t3e.make_heated_sphere_stretched_explicit_step(
                step.cfg, mesh, *faces, p["v_inf"], ramp, ghost, p["ibm_ghost_c"], device=dev)
        if ghost is not None:
            return s
        mu, mv, mw, mc = p["ibm_masks"]
        return _bind(s, mesh, *trim_face_masks3d(mu, mv, mw), mc)
    if faces is None:
        from cfdsim_tpu_torch.parallel import mac3d_explicit as m3e

        if ghost is not None:
            return m3e.make_sphere_ghost_mac3d_explicit_step(step.cfg, mesh, ghost, p["v_inf"],
                                                             ramp, profile, device=dev)
        s = m3e.make_sphere_mac3d_explicit_step(step.cfg, mesh, p["v_inf"], ramp, profile,
                                                device=dev)
    else:
        from cfdsim_tpu_torch.parallel import mac_stretched3d_explicit as s3e

        if ghost is not None:
            return s3e.make_sphere_ghost3d_stretched_explicit_step(
                step.cfg, mesh, *faces, ghost, p["v_inf"], ramp, profile, device=dev)
        s = s3e.make_sphere3d_stretched_explicit_step(step.cfg, mesh, *faces, p["v_inf"], ramp,
                                                      profile, device=dev)
    return _bind(s, mesh, *p["ibm_masks"], trim=trim_face_masks3d)


def make_sharded_step(step, mesh: GridMesh):
    """The explicit counterpart of the single-device step module ``step`` on
    this rank's blocks (:func:`shard_state`), built on the mesh's device:
    ``sharded(state_b, cfl_scale) -> (state_b, metrics)``, the metrics
    global. An explicit step that takes extra blocks comes bound to this
    rank's blocks of them (:class:`BoundStep`). Raises ``ValueError`` for a
    step type with no counterpart, a step whose case left no
    ``explicit_spec`` (one built by hand), the stretched 3D tier's moving
    ghost, and an option the explicit step does not implement (the
    explicit step's own refusal, which names it)."""
    from cfdsim_tpu_torch.models.boussinesq import BoussinesqStep
    from cfdsim_tpu_torch.models.boussinesq3d import Boussinesq3DStep
    from cfdsim_tpu_torch.models.compressible import CompressibleStep
    from cfdsim_tpu_torch.models.compressible3d import Compressible3DStep
    from cfdsim_tpu_torch.models.fem import FEMProjectionStep, FEMStep
    from cfdsim_tpu_torch.models.incompressible import IncompressibleStep
    from cfdsim_tpu_torch.models.incompressible3d import Incompressible3DStep
    from cfdsim_tpu_torch.models.mac import MACStep
    from cfdsim_tpu_torch.models.mac3d import MAC3DStep
    from cfdsim_tpu_torch.models.mac_stretched import StretchedMACStep
    from cfdsim_tpu_torch.models.mac_stretched3d import StretchedMAC3DStep
    from cfdsim_tpu_torch.models.spectral import SpectralStep
    from cfdsim_tpu_torch.models.spectral_ps import PSStep
    from cfdsim_tpu_torch.models.transport import CoupledStep
    from cfdsim_tpu_torch.models.transport3d import StretchedTransport3DStep, Transport3DStep

    dev = mesh.device
    kind = type(step)
    if kind is IncompressibleStep:
        from cfdsim_tpu_torch.parallel import explicit as ex

        p = _spec(step, {"cavity", "channel", "cylinder"})
        name = step.explicit_spec[0]
        if name == "cavity":
            return ex.make_cavity_explicit_step(step.cfg, mesh, p["lid_velocity"], device=dev)
        if name == "channel":
            return ex.make_channel_explicit_step(step.cfg, mesh, p["u_in"], p["profile"],
                                                 device=dev)
        s = ex.make_cylinder_explicit_step(step.cfg, mesh, v_inf=p["v_inf"],
                                           perturb_amp=p["perturb_amp"],
                                           perturb_ramp_steps=p["perturb_ramp_steps"],
                                           device=dev)
        fields = [p["ibm_mask"]] + ([p["solid_mask"]] if step.cfg.masked_poisson else [])
        return _bind(s, mesh, *fields, rows=p["y"])
    if kind is CoupledStep:
        from cfdsim_tpu_torch.parallel.transport_explicit import make_transport_explicit_step

        p = _spec(step, {"transport"})
        return make_transport_explicit_step(step.cfg, step.transport_cfg, mesh,
                                            p["lid_velocity"], p["hot_lid"], device=dev)
    if kind is MACStep:
        from cfdsim_tpu_torch.parallel import mac_explicit as me

        p = _spec(step, {"cavity_mac", "cylinder_mac", "cylinder_oscillating"})
        name = step.explicit_spec[0]
        if name == "cavity_mac":
            return me.make_cavity_mac_explicit_step(step.cfg, mesh, p["lid_velocity"],
                                                    device=dev)
        if name == "cylinder_oscillating":
            return me.make_moving_body_mac_explicit_step(
                step.cfg, mesh, p["body"], p["ibm_ramp_steps"], p["moving_scheme"], device=dev)
        if p["ibm_scheme"] == "ghost":
            return me.make_cylinder_mac_ghost_explicit_step(
                step.cfg, mesh, p["ibm_ghost"], p["v_inf"], p["perturb_amp"],
                p["perturb_ramp_steps"], p["ibm_ramp_steps"], device=dev)
        s = me.make_cylinder_mac_explicit_step(
            step.cfg, mesh, p["v_inf"], p["perturb_amp"], p["perturb_ramp_steps"],
            p["ibm_ramp_steps"], device=dev)
        return _bind(s, mesh, p["ibm_mask_u"], p["ibm_mask_v"], trim=me.trim_face_masks)
    if kind is StretchedMACStep:
        from cfdsim_tpu_torch.parallel import mac_stretched_explicit as mse
        from cfdsim_tpu_torch.parallel.mac_explicit import trim_face_masks

        p = _spec(step, {"cavity_stretched", "cylinder_stretched", "cylinder_oscillating"})
        name = step.explicit_spec[0]
        faces = (p["x_faces"], p["y_faces"])
        if name == "cavity_stretched":
            return mse.make_cavity_stretched_explicit_step(step.cfg, mesh, *faces,
                                                           p["lid_velocity"], device=dev)
        if name == "cylinder_oscillating":
            return mse.make_moving_body_stretched_explicit_step(
                step.cfg, mesh, *faces, p["body"], p["ibm_ramp_steps"], p["moving_scheme"],
                device=dev)
        s = mse.make_cylinder_stretched_explicit_step(
            step.cfg, mesh, *faces, p["v_inf"], p["perturb_amp"], p["perturb_ramp_steps"],
            p["ibm_ramp_steps"], device=dev)
        return _bind(s, mesh, p["ibm_mask_u"], p["ibm_mask_v"], trim=trim_face_masks)
    if kind is MAC3DStep:
        from cfdsim_tpu_torch.parallel.mac3d_explicit import make_cavity3d_mac_explicit_step

        p = _spec(step, {"cavity3d_mac", "sphere"})
        if step.explicit_spec[0] == "sphere":
            return _sphere_step("sphere", step, mesh, dev)
        return make_cavity3d_mac_explicit_step(step.cfg, mesh, p["lid_velocity"], device=dev)
    if kind is StretchedMAC3DStep:
        from cfdsim_tpu_torch.parallel.mac_stretched3d_explicit import (
            make_cavity3d_stretched_explicit_step,
        )

        if step.moving_body is not None and step.moving_scheme == "ghost":
            raise ValueError("moving_scheme='ghost' on the stretched 3D tier has no sharded "
                             "counterpart (no case builds it; the penalized moving body has "
                             "one: mac_stretched3d_explicit)")
        p = _spec(step, {"cavity3d_stretched", "sphere_stretched"})
        if step.explicit_spec[0] == "sphere_stretched":
            return _sphere_step("sphere_stretched", step, mesh, dev)
        return make_cavity3d_stretched_explicit_step(
            step.cfg, mesh, p["x_faces"], p["y_faces"], p["z_faces"], p["lid_velocity"],
            device=dev)
    if kind is StretchedTransport3DStep:
        return _sphere_step("heated_sphere_stretched", step, mesh, dev)
    if kind is Transport3DStep:
        return _sphere_step("heated_sphere", step, mesh, dev)
    if kind is BoussinesqStep:
        from cfdsim_tpu_torch.parallel.boussinesq_explicit import make_heated_cavity_explicit_step

        _spec(step, {"boussinesq"})
        return make_heated_cavity_explicit_step(step.cfg, mesh, device=dev)
    if kind is Boussinesq3DStep:
        from cfdsim_tpu_torch.parallel.boussinesq3d_explicit import make_heated_cube_explicit_step

        _spec(step, {"heated_cube"})
        return make_heated_cube_explicit_step(step.cfg, mesh, device=dev)
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
                     "maps the step types of the 27 cases (IncompressibleStep, CoupledStep, "
                     "MACStep, StretchedMACStep, MAC3DStep, StretchedMAC3DStep, Transport3DStep, "
                     "StretchedTransport3DStep, BoussinesqStep, Boussinesq3DStep, PSStep, "
                     "CompressibleStep, SpectralStep, Incompressible3DStep, Compressible3DStep, "
                     "FEMStep, FEMProjectionStep)")
