"""The 3D staggered (MAC) step on rank blocks (``cfdsim_tpu.parallel.mac3d_explicit``).

The face arrays of ``models/mac3d.py`` are uneven in one axis each, so the
distributed state is the *trimmed* one: the last boundary face of each
component dropped (u[..., :-1], v[:, :-1, :], w[:-1]), every field (nz, ny,
nx), cut into (nz, ny/py, nx/px) blocks: z stays local (the cavity3d
layout), y and x ride the halo exchanges of ``halo.py`` (which pad the two
trailing axes), the boundary faces and tangential ghosts are global-index
masked writes (``MAC3DLocalBCs``), the z ghosts plain local
concatenations. The projection is the exact distributed 3D DCT
(``transforms.dct_poisson3d_local``), or the distributed multigrid or SOR of
``incompressible3d_explicit.DistributedPoisson3D`` by the configured
method. ``time_scheme="rk2"`` (Heun, one projection per stage, the body's
second stage at t + dt) and ``projection="incremental"`` (p = p_warm + φ)
follow ``models/mac3d.py``.

Advection and diffusion run the *single-device* operators of
``models/mac3d.py`` on a width-2 halo window (the ±2-centre neighbourhood
of the owned faces) and crop to the owned faces: every window position
within a stencil's reach of an owned face holds the global value, so every
scheme (central, upwind, TVD, with ``slope_fix`` zeroing the MUSCL slopes
on the global boundary lines that run through the window) and the
Smagorinsky LES (its edge-clamped ν_t emulated by masked rolls) come along.

The dynamic Germano–Lilly LES (``les_model="dynamic"``) reads centre
velocities within ±2 cells of a cell, so width-3 face halos give its
windows; the volume-averaged C_s² is one sum over the mesh of the partial
contractions (one ``all_reduce`` for both), equal to the single-device
value to float32 partial-sum rounding. The body's cells leave the
contraction through this rank's block of the fluid indicator.

Immersed bodies: trimmed penalization masks (call-time blocks), the static
ghost-cell IBM (this rank's tables, ``ibm_ghost_explicit.py``), or a
moving sphere (sharp masks rebuilt from this rank's lines of the
single-device coordinates, or the moving ghost); forces sum over the mesh.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac3d import (
    MAC3DConfig,
    MAC3DState,
    _diffuse_les3d,
    advect3d,
    diffuse3d,
    smagorinsky_viscosity_mac3d,
    strain_magnitude_mac3d,
)
from cfdsim_tpu_torch.ops.les_dynamic import ibm_fluid_mask_centers, lilly_integrand_3d
from cfdsim_tpu_torch.parallel.explicit import check_divisible, step_device
from cfdsim_tpu_torch.parallel.halo import global_indices, halo_exchange, halo_exchange_edges
from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import (
    GhostTables,
    MovingBodyLocal,
    apply_ghost_forcing_stack,
    moving_ghost_width_2d,
    partition_ghost_ibm3d,
)
from cfdsim_tpu_torch.parallel.mac_explicit import MACBlockStep
from cfdsim_tpu_torch.parallel.mesh import GridMesh, block_state, pmax, psum
from cfdsim_tpu_torch.parallel.incompressible3d_explicit import DistributedPoisson3D


def trim_state3d(state):
    """Full 3D MAC state (or any state with u/v/w faces) → the mesh-divisible
    trimmed state."""
    return state._replace(u=state.u[:, :, :-1], v=state.v[:, :-1, :], w=state.w[:-1])


def untrim_state3d(tstate, lid_velocity: float = 1.0):
    """Trimmed → full state of a closed box: every dropped boundary face is a
    wall's normal face, zero (the lid is tangential)."""
    del lid_velocity
    return tstate._replace(u=F.pad(tstate.u, (0, 1)), v=F.pad(tstate.v, (0, 0, 0, 1)),
                           w=F.pad(tstate.w, (0, 0, 0, 0, 0, 1)))


def shard_trimmed_state3d(tstate, mesh: GridMesh):
    """This rank's blocks of a trimmed 3D state (every 3D field cut over its
    two trailing axes; t and step copied)."""
    return block_state(tstate, mesh)


def _zplane(w, k: int, value: float = 0.0):
    """``w`` with its plane ``k`` set to ``value``: a new tensor."""
    return torch.cat([w[:k], torch.full_like(w[k:k + 1], value), w[k + 1:]], 0)


def _roll_writes(Q, r, c, ny: int, nx: int, sy: float, sx: float, rows=True, cols=True):
    """The tangential ghost writes on a halo-padded 3D block: the global
    ghost rows −1 and ny take ``sy`` times the adjacent row, the ghost
    columns ``sx`` times the adjacent column (−1 no slip, +1 free slip)."""
    if rows:
        Q = torch.where(r == -1, sy * torch.roll(Q, -1, 1), Q)
        Q = torch.where(r == ny, sy * torch.roll(Q, 1, 1), Q)
    if cols:
        Q = torch.where(c == -1, sx * torch.roll(Q, -1, 2), Q)
        Q = torch.where(c == nx, sx * torch.roll(Q, 1, 2), Q)
    return Q


class MAC3DLocalBCs(NamedTuple):
    """3D MAC boundary conditions in the masked-write local form.

    ``pre(u_t, v_t, w_t, ro, co, state)`` applies the set_normal writes
    inside the trimmed arrays; ``aux(...)`` computes the BC numbers that sum
    over the mesh (the outflow shift); ``win(U2, V2, W2, r2, c2, state,
    aux)`` writes the dropped boundary faces and the y/x tangential ghosts on
    the width-2 windows; ``zghost_u``/``zghost_v`` extend window arrays by
    their z ghosts; ``pad_writes(U, V, Wz, rp, cp, state, aux)`` the same
    writes on width-1 padded blocks; ``velmax_extra(u_t, aux)`` the |value|
    of the dropped faces the trimmed maximum cannot see (the outflow)."""

    pre: Callable
    aux: Callable
    win: Callable
    zghost_u: Callable
    zghost_v: Callable
    pad_writes: Callable
    velmax_extra: Callable


def _walls_pre(u_t, v_t, w_t, ro, co, state):
    return torch.where(co == 0, 0.0, u_t), torch.where(ro == 0, 0.0, v_t), _zplane(w_t, 0)


def _no_aux(u_t, v_t, w_t, ro, co, state):
    return ()


def _closed_box(nx: int, ny: int, s: float, zghost_u, zghost_v) -> MAC3DLocalBCs:
    """A closed box whose tangential ghosts are ``s`` times the adjacent line
    (−1 no slip, +1 free slip); the z ghosts by ``zghost_*``."""

    def win(U2, V2, W2, r2, c2, state, a):
        U2 = _roll_writes(torch.where(c2 >= nx, 0.0, U2), r2, c2, ny, nx, s, s, cols=False)
        V2 = _roll_writes(torch.where(r2 >= ny, 0.0, V2), r2, c2, ny, nx, s, s, rows=False)
        return U2, V2, _roll_writes(W2, r2, c2, ny, nx, s, s)

    def pad_writes(U, V, Wz, rp, cp, state, a):
        U = _roll_writes(torch.where(cp == nx, 0.0, U), rp, cp, ny, nx, s, s, cols=False)
        V = _roll_writes(torch.where(rp == ny, 0.0, V), rp, cp, ny, nx, s, s, rows=False)
        return U, V, _roll_writes(Wz, rp, cp, ny, nx, s, s)

    def velmax_extra(u_t, a):
        return torch.zeros((), dtype=u_t.dtype, device=u_t.device)

    return MAC3DLocalBCs(_walls_pre, _no_aux, win, zghost_u, zghost_v, pad_writes,
                         velmax_extra)


def cavity3d_local_bcs(nx: int, ny: int, lid_velocity: float = 1.0) -> MAC3DLocalBCs:
    """The masked-write form of ``mac3d.cavity3d_bcs`` (no-slip box, the lid
    at z_hi moving in +x)."""
    return _closed_box(
        nx, ny, -1.0,
        lambda u: torch.cat([-u[:1], u, 2.0 * lid_velocity - u[-1:]], 0),
        lambda v: torch.cat([-v[:1], v, -v[-1:]], 0))


def free_slip3d_local_bcs(nx: int, ny: int) -> MAC3DLocalBCs:
    """The masked-write form of ``mac3d.free_slip_bcs3d`` (zero normal
    velocity, zero tangential shear on all six faces)."""
    return _closed_box(nx, ny, 1.0, lambda u: torch.cat([u[:1], u, u[-1:]], 0),
                       lambda v: torch.cat([v[:1], v, v[-1:]], 0))


def external_flow3d_local_bcs(nx: int, ny: int, nz: int, v_inf: float, face_weights=None,
                              inlet_profile=None, *, mesh: GridMesh) -> MAC3DLocalBCs:
    """The masked-write form of ``mac3d.external_flow_bcs3d``: Dirichlet
    inflow at x_lo (v_inf, or v_inf times this rank's rows of the static
    (nz, ny) ``inlet_profile``), the mass-consistent zero-gradient outflow
    at x_hi (the dropped u face nx, rebuilt as u(nx−1) plus the shift,
    whose two sums share one ``all_reduce`` and see the modulated inflow),
    free slip on the four lateral faces. ``face_weights`` ((nz, ny), a
    stretched grid's x-face areas) weights the mass balance by area; this
    rank takes its rows."""
    if ny % mesh.py or nx % mesh.px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
    ny_l = ny // mesh.py
    rows = slice(mesh.iy * ny_l, (mesh.iy + 1) * ny_l)
    last_x = mesh.ix == mesh.px - 1
    fw, norm = None, float(ny * nz)
    if face_weights is not None:
        a = np.asarray(face_weights, np.float64)
        norm = float(np.sum(a))
        fw = torch.as_tensor(np.ascontiguousarray(a[:, rows, None]).astype(np.float32),
                             device=mesh.device)
    inflow = v_inf
    if inlet_profile is not None:
        prof = torch.as_tensor(np.ascontiguousarray(
            np.asarray(inlet_profile, np.float32)[:, rows, None]), device=mesh.device)
        inflow = v_inf * prof  # the single-device product, in float32

    def pre(u_t, v_t, w_t, ro, co, state):
        return torch.where(co == 0, inflow, u_t), torch.where(ro == 0, 0.0, v_t), _zplane(w_t, 0)

    def aux(u_t, v_t, w_t, ro, co, state):
        s0 = torch.where(co == 0, u_t, 0.0)
        s1 = torch.where(co == nx - 1, u_t, 0.0)
        if fw is not None:
            s0, s1 = fw * s0, fw * s1
        s = psum(torch.stack([s0.sum(), s1.sum()]), mesh)
        return (s[0] - s[1]) / norm

    def win(U2, V2, W2, r2, c2, state, mcorr):
        U2 = torch.where(c2 > nx, 0.0, U2)
        U2 = torch.where(c2 == nx, torch.roll(U2, 1, 2) + mcorr, U2)  # the outflow face
        U2 = _roll_writes(U2, r2, c2, ny, nx, 1.0, 1.0, cols=False)  # free slip
        V2 = torch.where(r2 >= ny, 0.0, V2)
        V2 = torch.where(c2 == -1, -torch.roll(V2, -1, 2), V2)  # inflow: v = 0
        V2 = torch.where(c2 == nx, torch.roll(V2, 1, 2), V2)  # outflow: ∂v/∂x = 0
        W2 = _roll_writes(W2, r2, c2, ny, nx, 1.0, 1.0, cols=False)
        W2 = torch.where(c2 == -1, -torch.roll(W2, -1, 2), W2)
        return U2, V2, torch.where(c2 == nx, torch.roll(W2, 1, 2), W2)

    def pad_writes(U, V, Wz, rp, cp, state, mcorr):
        U = torch.where(cp == nx, torch.roll(U, 1, 2) + mcorr, U)
        U = _roll_writes(U, rp, cp, ny, nx, 1.0, 1.0, cols=False)
        V = torch.where(rp == ny, 0.0, V)
        V = torch.where(cp == -1, -torch.roll(V, -1, 2), V)
        V = torch.where(cp == nx, torch.roll(V, 1, 2), V)
        Wz = _roll_writes(Wz, rp, cp, ny, nx, 1.0, 1.0, cols=False)
        Wz = torch.where(cp == -1, -torch.roll(Wz, -1, 2), Wz)
        return U, V, torch.where(cp == nx, torch.roll(Wz, 1, 2), Wz)

    def velmax_extra(u_t, mcorr):
        # the dropped outflow face joins the CFL maximum: only the last x-rank has it
        if last_x:
            return (u_t[:, :, -1] + mcorr).abs().amax()
        return torch.zeros((), dtype=u_t.dtype, device=u_t.device)

    return MAC3DLocalBCs(pre, aux, win, lambda u: torch.cat([u[:1], u, u[-1:]], 0),
                         lambda v: torch.cat([v[:1], v, v[-1:]], 0), pad_writes, velmax_extra)


class BoxIndices(nn.Module):
    """The global (row, column) index grids of this rank's 3D blocks, each
    (1, ny_l + 2w, nx_l + 2w): ``ro``/``co`` (w = 0), ``rp``/``cp`` (1) and
    ``r2``/``c2`` (2)."""

    def __init__(self, local_shape, mesh: GridMesh):
        super().__init__()
        for w, (r, c) in ((0, ("ro", "co")), (1, ("rp", "cp")), (2, ("r2", "c2"))):
            gr, gc = global_indices(local_shape, mesh, w)
            self.register_buffer(r, gr[None].contiguous())
            self.register_buffer(c, gc[None].contiguous())


def cavity3d_bc_kit(nx: int, ny: int, mesh: GridMesh, local_shape):
    """The trimmed no-slip box of the 3D Boussinesq step: ``(idx, set_normal,
    pad)`` with ``idx`` the :class:`BoxIndices`, ``set_normal(u_t, v_t,
    w_t)`` the normal-face writes inside the trimmed arrays and ``pad(u_t,
    v_t, w_t, corners=True)`` the width-1 padded blocks with the dropped
    faces and tangential ghosts written (the z ghosts are the caller's);
    ``corners=False`` exchanges the edges only, in one round, for readers
    that are plus-shaped."""
    idx = BoxIndices(local_shape, mesh)
    bcs = cavity3d_local_bcs(nx, ny, 0.0)

    def set_normal(u_t, v_t, w_t):
        return bcs.pre(u_t, v_t, w_t, idx.ro, idx.co, None)

    def pad(u_t, v_t, w_t, corners: bool = True):
        exchange = halo_exchange if corners else halo_exchange_edges
        U, V, W = exchange(torch.stack([u_t, v_t, w_t]), mesh, 1).unbind(0)
        Wz = torch.cat([W, torch.zeros_like(W[:1])], 0)  # w z-face nz = 0
        return bcs.pad_writes(U, V, Wz, idx.rp, idx.cp, None, ())

    return idx, set_normal, pad


def trim_face_masks3d(mask_u, mask_v, mask_w):
    """Trim 3D face-sampled IBM masks to the (nz, ny, nx) shape of the
    trimmed state (numpy), after checking that the boundary-adjacent entries
    the distributed step cannot see are zero."""
    mu, mv, mw = (np.asarray(m.cpu() if torch.is_tensor(m) else m)
                  for m in (mask_u, mask_v, mask_w))
    if not (np.all(mu[:, :, 0] == 0.0) and np.all(mu[:, :, -2:] == 0.0)
            and np.all(mv[:, 0, :] == 0.0) and np.all(mv[:, -2:, :] == 0.0)
            and np.all(mw[0] == 0.0) and np.all(mw[-2:] == 0.0)):
        raise ValueError("IBM body touches the domain boundary; the trimmed sharded "
                         "representation requires zero mask on boundary-adjacent faces")
    return (mu[:, :, :-1].astype(np.float32), mv[:, :-1, :].astype(np.float32),
            mw[:-1].astype(np.float32))


def fluid_from_masks_local(mask_u_t, mask_v_t, mask_w_t, mesh: GridMesh):
    """This rank's block of ``les_dynamic.ibm_fluid_mask_centers`` of the
    trimmed face masks: a cell centre needs its +1 faces, so the masks take
    one edge exchange; the dropped boundary faces feed only cells the
    contraction leaves out, so their zero fill is harmless."""
    P = halo_exchange_edges(torch.stack([mask_u_t, mask_v_t, mask_w_t]), mesh, 1)
    mu = P[0, :, 1:-1, 1:]
    mv = P[1, :, 1:, 1:-1]
    mw = torch.cat([mask_w_t, torch.zeros_like(mask_w_t[:1])], 0)
    solid = torch.maximum(torch.maximum(torch.maximum(mu[:, :, 1:], mu[:, :, :-1]),
                                        torch.maximum(mv[:, 1:, :], mv[:, :-1, :])),
                          torch.maximum(mw[1:], mw[:-1]))
    return solid < 0.5


def dynamic_cs2_local(u_t, v_t, w_t, mesh: GridMesh, include, inv_g2x, inv_g2y, inv_g2z,
                      delta_sq, fluid=None):
    """The volume-averaged Germano–Lilly C_s² from trimmed face blocks, one
    device scalar on every rank: the Lilly integrand of this rank's owned
    cells on ±2-centre windows (width-3 face halos), summed where
    ``include`` (the cells at least 3 from every global wall) and ``fluid``
    (None: everywhere), both sums in one ``all_reduce``. ``inv_g2*`` and
    ``delta_sq`` are numbers (uniform) or lines over the window
    (stretched)."""
    ny_l, nx_l = u_t.shape[-2:]
    U3, V3, W3 = halo_exchange(torch.stack([u_t, v_t, w_t]), mesh, 3).unbind(0)
    uc_w = (0.5 * (U3[:, :, :-1] + U3[:, :, 1:]))[:, 1:-1, 1:]
    vc_w = (0.5 * (V3[:, :-1, :] + V3[:, 1:, :]))[:, 1:, 1:-1]
    wz3 = torch.cat([W3, torch.zeros_like(W3[:1])], 0)
    wc_w = (0.5 * (wz3[:-1] + wz3[1:]))[:, 1:-1, 1:-1]
    lm_w, mm_w = lilly_integrand_3d(uc_w, vc_w, wc_w, inv_g2x, inv_g2y, inv_g2z, delta_sq)
    inc = include if fluid is None else include & fluid
    lm = torch.where(inc, lm_w[:, 2:2 + ny_l, 2:2 + nx_l], 0.0).sum()
    mm = torch.where(inc, mm_w[:, 2:2 + ny_l, 2:2 + nx_l], 0.0).sum()
    lm_s, mm_s = psum(torch.stack([lm, mm]), mesh).unbind(0)
    return (lm_s / (mm_s + 1e-20)).clamp(0.0, 0.3 ** 2)


def dynamic_include(nz: int, ny: int, nx: int, idx: BoxIndices):
    """The cells at least 3 from every global wall (the contraction's
    ``boundary_skip`` = 3), on this rank's block."""
    kz = torch.arange(nz, device=idx.ro.device)[:, None, None]
    return ((kz >= 3) & (kz <= nz - 4) & (idx.ro >= 3) & (idx.ro <= ny - 4)
            & (idx.co >= 3) & (idx.co <= nx - 4))


def check_dynamic_les(shape, local_shape):
    """The dynamic model's refusals: ``shape`` (nz, ny, nx) too small for
    its boundary skip, or blocks too narrow for its width-3 windows."""
    if any(d <= 6 for d in shape):
        raise ValueError(f"grid {tuple(shape)} too small for the dynamic model's "
                         "boundary_skip=3 (needs > 6 cells per axis)")
    if min(local_shape) < 3:
        raise ValueError("les_model='dynamic' needs local blocks >= 3x3 for its width-3 halo "
                         f"windows; got {local_shape[0]}x{local_shape[1]}")


def window_slope_fix(name, s, ny: int, nx: int, local_shape, mesh: GridMesh):
    """Zero the MUSCL slopes ``s`` (``advect3d``'s ``slope_fix``) on the
    *global* boundary lines that run through the width-2 window (the
    single-device slopes end there; z is local, so its window ends are the
    global ones)."""
    if name[1] == "z":
        return s
    ny_l, nx_l = local_shape
    gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
    base, (b0, b1) = {
        "ux": (gx0 - 2, (0, nx)), "uy": (gy0 - 3, (-1, ny)),
        "vx": (gx0 - 3, (-1, nx)), "vy": (gy0 - 2, (0, ny)),
        "wx": (gx0 - 3, (-1, nx)), "wy": (gy0 - 3, (-1, ny)),
    }[name]
    axis = 2 if name[1] == "x" else 1
    shape = [1, 1, 1]
    shape[axis] = s.shape[axis]
    i = base + torch.arange(s.shape[axis], device=s.device).reshape(shape)
    return torch.where((i == b0) | (i == b1), 0.0, s)


def flow_windows(u_t, v_t, w_t, bcs: MAC3DLocalBCs, idx: BoxIndices, mesh: GridMesh, ts, a):
    """The width-2 windows of trimmed face blocks in mac3d's layout and their
    ghosts, ``bcs``' writes applied: the single-device operators run on them;
    the zero lines appended feed only cropped positions or slope lines
    zeroed by :func:`window_slope_fix`."""
    U2, V2, W2 = halo_exchange(torch.stack([u_t, v_t, w_t]), mesh, 2).unbind(0)
    U2, V2, W2 = bcs.win(U2, V2, W2, idx.r2, idx.c2, ts, a)

    def zpad(q, axis):
        z = torch.zeros_like(q.narrow(axis, 0, 1))
        return torch.cat([z, q, z], axis)

    u_win = torch.cat([U2, torch.zeros_like(U2[:, :, :1])], 2)  # (nz, NY, NX+1)
    v_win = torch.cat([V2, torch.zeros_like(V2[:, :1, :])], 1)  # (nz, NY+1, NX)
    w_win = torch.cat([W2, torch.zeros_like(W2[:1])], 0)  # (nz+1, NY, NX)
    ghosts = (zpad(u_win, 1), bcs.zghost_u(u_win), zpad(v_win, 2), bcs.zghost_v(v_win),
              zpad(w_win, 2), zpad(w_win, 1))
    return u_win, v_win, w_win, ghosts


def ghost_tables(ibm_ghost, nx: int, ny: int, nz: int, mesh: GridMesh, device):
    """(this rank's u, v, w ghost tables as :class:`GhostTables`, their halo
    width), cut from the whole-grid ``ibm_ghost``."""
    tables, width = partition_ghost_ibm3d(ibm_ghost, nx, ny, nz, mesh, device=device)
    return GhostTables({"u": tables.u, "v": tables.v, "w": tables.w}, device=device), width


class MAC3DBlockStep(MACBlockStep):
    """The 3D MAC tiers' BC writes on trimmed blocks (``bcs``:
    :class:`MAC3DLocalBCs`; ``idx``: their :class:`BoxIndices`)."""

    def _set_normal(self, u_t, v_t, w_t, ts):
        u_t, v_t, w_t = self.bcs.pre(u_t, v_t, w_t, self.idx.ro, self.idx.co, ts)
        return u_t, v_t, w_t, self.bcs.aux(u_t, v_t, w_t, self.idx.ro, self.idx.co, ts)


class MAC3DExplicitStep(MAC3DBlockStep):
    """``step(tstate, cfl_scale[, mask_u_t, mask_v_t, mask_w_t]) ->
    (tstate, StepMetrics)`` on this rank's trimmed (nz, ny_l, nx_l) blocks;
    see :func:`make_mac3d_explicit_step`."""

    def __init__(self, cfg: MAC3DConfig, mesh: GridMesh, bcs: MAC3DLocalBCs,
                 use_ibm: bool = False, ibm_ramp_steps: int = 0, moving_body=None,
                 moving_scheme: str = "penalize", ibm_ghost=None, *, device=None):
        super().__init__()
        if ibm_ghost is not None and use_ibm:
            raise ValueError("ghost_halo and use_ibm are mutually exclusive")
        if moving_scheme not in ("penalize", "ghost"):
            raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
        g = cfg.grid
        nx, ny, nz = g.nx, g.ny, g.nz
        self.local_shape = check_divisible(g, mesh, min_block=2)
        if cfg.scheme not in ("central", "upwind", "tvd"):
            raise ValueError(f"unknown MAC3D scheme {cfg.scheme!r}")
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown MAC3D time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown MAC3D projection {cfg.projection!r}")
        if cfg.les_model not in ("smagorinsky", "dynamic"):
            raise ValueError(f"unknown les_model {cfg.les_model!r}")
        self.dynamic = cfg.use_les and cfg.les_model == "dynamic"
        if self.dynamic:
            if moving_body is not None:
                raise ValueError("les_model='dynamic' does not support moving_body yet "
                                 "(matches models/mac3d.py)")
            check_dynamic_les((nz, ny, nx), self.local_shape)
        dx, dy, dz = g.dx, g.dy, g.dz
        hb = min(dx, dy, dz)
        self.cfg, self.mesh, self.bcs = cfg, mesh, bcs
        self.use_ibm, self.ibm_ramp_steps = use_ibm, ibm_ramp_steps
        self.device = step_device(mesh, device)
        self.reads_host = False
        self.collectives = True
        self.n_global = float(nx * ny * nz)
        self.idx = BoxIndices(self.local_shape, mesh)
        self.poisson = DistributedPoisson3D(g.shape, g.dx, g.dy, g.dz, cfg.poisson, mesh)
        ny_l, nx_l = self.local_shape
        gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
        self.ghost, self.ghost_width = None, None
        if ibm_ghost is not None:
            self.ghost, self.ghost_width = ghost_tables(ibm_ghost, nx, ny, nz, mesh, self.device)
        self.register_buffer("les_include", dynamic_include(nz, ny, nx, self.idx)
                             if self.dynamic else None)
        fluid = None
        if self.dynamic and ibm_ghost is not None:
            fluid = ibm_fluid_mask_centers(ibm_ghost=ibm_ghost)[
                :, gy0:gy0 + ny_l, gx0:gx0 + nx_l].to(self.device)
        self.register_buffer("les_fluid", fluid)
        self.hb = hb
        self.moving = None
        if moving_body is not None:
            xf = g.x_min + np.arange(nx + 1) * dx
            yf = g.y_min + np.arange(ny + 1) * dy
            zf = g.z_min + np.arange(nz + 1) * dz
            xc = g.x_min + (np.arange(nx) + 0.5) * dx
            yc = g.y_min + (np.arange(ny) + 0.5) * dy
            zc = g.z_min + (np.arange(nz) + 0.5) * dz
            samples = {"u": (xf, yc, zc), "v": (xc, yf, zc), "w": (xc, yc, zf)}
            origins = {"u": (g.x_min, g.y_min + 0.5 * dy, g.z_min + 0.5 * dz),
                       "v": (g.x_min + 0.5 * dx, g.y_min, g.z_min + 0.5 * dz),
                       "w": (g.x_min + 0.5 * dx, g.y_min + 0.5 * dy, g.z_min)}
            self.moving = MovingBodyLocal(
                moving_body, moving_scheme, tuple(samples[c] for c in "uvw"),
                tuple(tuple(zip(origins[c], (dx, dy, dz))) for c in "uvw"), hb, 1.5 * hb,
                moving_ghost_width_2d(1.5 * hb, hb, max(dx, dy, dz)), mesh, (nz, ny_l, nx_l),
                device=self.device)
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=self.device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=self.device))

    def _slope_fix(self, name, s):
        return window_slope_fix(name, s, self.cfg.grid.ny, self.cfg.grid.nx, self.local_shape,
                                self.mesh)

    def _pad(self, u_t, v_t, w_t, a, ts):
        """Width-1 padded blocks with every boundary write (the edges in
        one round: their readers are plus-shaped)."""
        U, V, W = halo_exchange_edges(torch.stack([u_t, v_t, w_t]), self.mesh, 1).unbind(0)
        Wz = torch.cat([W, torch.zeros_like(W[:1])], 0)  # w z-face nz
        return self.bcs.pad_writes(U, V, Wz, self.idx.rp, self.idx.cp, ts, a)

    def _windows(self, u_t, v_t, w_t, a, ts):
        return flow_windows(u_t, v_t, w_t, self.bcs, self.idx, self.mesh, ts, a)

    def _nut(self, windows, u_t, v_t, w_t, extras):
        """LES eddy viscosity on the window (valid on the ±1 ring around the
        owned cells, all the flux-form diffusion reads), the global edge
        clamp emulated."""
        cfg = self.cfg
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        u_win, v_win, w_win, ghosts = windows
        if self.dynamic:
            delta_sq = (dx * dy * dz) ** (2.0 / 3.0)
            fluid = self.les_fluid
            if self.use_ibm:
                fluid = fluid_from_masks_local(*extras, self.mesh)
            cs2 = dynamic_cs2_local(u_t, v_t, w_t, self.mesh, self.les_include, 0.5 / dx,
                                    0.5 / dy, 0.5 / dz, delta_sq, fluid)
            NUT = (cs2 * delta_sq) * strain_magnitude_mac3d(u_win, v_win, w_win, ghosts,
                                                            dx, dy, dz)
        else:
            NUT = smagorinsky_viscosity_mac3d(u_win, v_win, w_win, ghosts, dx, dy, dz,
                                              cfg.smagorinsky_constant)
        return _roll_writes(NUT, self.idx.r2, self.idx.c2, g.ny, g.nx, 1.0, 1.0)

    def _stage(self, ts, u_t, v_t, w_t, a, windows, NUT, p_warm, dt, extras):
        """One projected Euler stage (``models/mac3d.py::MAC3DStep._stage``)
        from BC-consistent trimmed (u, v, w) and their windows, the body at
        ``ts``'s time: (u_new, v_new, w_new, a, p, body sums, div*)."""
        cfg = self.cfg
        mesh = self.mesh
        g = cfg.grid
        dx, dy, dz = g.dx, g.dy, g.dz
        ny_l, nx_l = self.local_shape
        ro, co = self.idx.ro, self.idx.co
        u_win, v_win, w_win, ghosts = windows

        # --- the single-device advection and diffusion on the window, cropped
        conv_u, conv_v, conv_w = advect3d(u_win, v_win, w_win, ghosts, dx, dy, dz, cfg.scheme,
                                          slope_fix=self._slope_fix)
        if cfg.use_les:
            visc_u, visc_v, visc_w = _diffuse_les3d(u_win, v_win, w_win, ghosts, cfg.nu + NUT,
                                                    dx, dy, dz)
        else:
            lap_u, lap_v, lap_w = diffuse3d(u_win, v_win, w_win, ghosts, dx, dy, dz)
            visc_u, visc_v, visc_w = cfg.nu * lap_u, cfg.nu * lap_v, cfg.nu * lap_w
        # owned crops: u rows are window centres (2 …), columns interior
        # x-faces gx0−1+j (1 …); v rows interior y-faces; w every interior
        # z-face (z is local)
        du = (visc_u - conv_u)[:, 2:2 + ny_l, 1:1 + nx_l]
        dv = (visc_v - conv_v)[:, 1:1 + ny_l, 2:2 + nx_l]
        dw = (visc_w - conv_w)[:, 2:2 + ny_l, 2:2 + nx_l]
        u_star = u_t + torch.where(co >= 1, dt * du, 0.0)
        v_star = v_t + torch.where(ro >= 1, dt * dv, 0.0)
        w_star = torch.cat([w_t[:1], w_t[1:] + dt * dw], 0)
        if cfg.projection == "incremental":
            # the lagged pressure gradient; the projection solves for the increment
            PW = halo_exchange_edges(p_warm, mesh, 1)
            u_star = u_star + torch.where(
                co >= 1, -dt * (PW[:, 1:-1, 1:-1] - PW[:, 1:-1, :-2]) * (1.0 / dx), 0.0)
            v_star = v_star + torch.where(
                ro >= 1, -dt * (PW[:, 1:-1, 1:-1] - PW[:, :-2, 1:-1]) * (1.0 / dy), 0.0)
            w_star = torch.cat(
                [w_star[:1], w_star[1:] + -dt * (p_warm[1:] - p_warm[:-1]) * (1.0 / dz)], 0)
        u_star, v_star, w_star, a = self._set_normal(u_star, v_star, w_star, ts)

        # --- the bodies
        sums = []
        if self.use_ibm:
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            d_ibm = [f * (strength * m) for f, m in zip((u_star, v_star, w_star), extras)]
            u_star, v_star, w_star = (f - d for f, d in zip((u_star, v_star, w_star), d_ibm))
            sums += [d.sum() for d in d_ibm]
        if self.ghost is not None:
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            outs = apply_ghost_forcing_stack(
                [u_star, v_star, w_star], [self.ghost.set(c) for c in "uvw"], mesh,
                self.ghost_width, strength)
            (u_star, du_g), (v_star, dv_g), (w_star, dw_g) = outs
            sums += [du_g.sum(), dv_g.sum(), dw_g.sum()]
        if self.moving is not None:
            (u_star, v_star, w_star), d_mb = self.moving(
                (u_star, v_star, w_star), ts.t, ibm_ramp(ts.step, self.ibm_ramp_steps))
            sums += [d.sum() for d in d_mb]

        # --- the distributed 3D projection
        US, VS, WSz = self._pad(u_star, v_star, w_star, a, ts)
        div_star = ((US[:, 1:-1, 2:] - US[:, 1:-1, 1:-1]) * (1.0 / dx)
                    + (VS[:, 2:, 1:-1] - VS[:, 1:-1, 1:-1]) * (1.0 / dy)
                    + (WSz[1:, 1:-1, 1:-1] - WSz[:-1, 1:-1, 1:-1]) * (1.0 / dz))
        rhs = div_star / dt
        if cfg.poisson.method != "dct":
            rhs = rhs - psum(rhs.sum(), mesh) / self.n_global  # Neumann solvability
        warm = torch.zeros_like(p_warm) if cfg.projection == "incremental" else p_warm
        phi = self.poisson(warm, rhs)
        PH = halo_exchange_edges(phi, mesh, 1)
        u_new = u_star + torch.where(
            co >= 1, -dt * (PH[:, 1:-1, 1:-1] - PH[:, 1:-1, :-2]) * (1.0 / dx), 0.0)
        v_new = v_star + torch.where(
            ro >= 1, -dt * (PH[:, 1:-1, 1:-1] - PH[:, :-2, 1:-1]) * (1.0 / dy), 0.0)
        w_new = torch.cat([w_star[:1], w_star[1:] + -dt * (phi[1:] - phi[:-1]) * (1.0 / dz)], 0)
        u_new, v_new, w_new, a = self._set_normal(u_new, v_new, w_new, ts)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        w_new = w_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        p_out = p_warm + phi if cfg.projection == "incremental" else phi
        return u_new, v_new, w_new, a, p_out, sums, div_star

    def _restage(self, ts, fields, a, p_warm, dt, extras):
        windows = self._windows(*fields, a, ts)
        NUT = self._nut(windows, *fields, extras) if self.cfg.use_les else None
        u, v, w, _, p, sums, div_star = self._stage(ts, *fields, a, windows, NUT, p_warm, dt,
                                                    extras)
        return (u, v, w), p, sums, div_star

    def forward(self, ts: MAC3DState, cfl_scale, *extras):
        cfg = self.cfg
        mesh = self.mesh
        bcs = self.bcs
        g = cfg.grid
        nz = g.nz
        dx, dy, dz = g.dx, g.dy, g.dz
        h = self.hb
        ny_l, nx_l = self.local_shape
        ro = self.idx.ro
        if ts.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {ts.u.device}")
        if len(extras) != (3 if self.use_ibm else 0):
            raise ValueError(f"the step takes {3 if self.use_ibm else 0} extra blocks, got "
                             f"{len(extras)}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)

        u_t, v_t, w_t, a = self._set_normal(ts.u, ts.v, ts.w, ts)
        windows = self._windows(u_t, v_t, w_t, a, ts)
        NUT = None
        if cfg.use_les:
            NUT = self._nut(windows, u_t, v_t, w_t, extras)
            nu_stab = cfg.nu + psum(NUT[:, 2:2 + ny_l, 2:2 + nx_l].sum(), mesh) / self.n_global

        # --- adaptive dt (the maximum is exact: the reduction order is free)
        if cfg.adaptive_dt:
            vel_max = pmax(torch.maximum(
                torch.maximum(u_t.abs().amax(), v_t.abs().amax()),
                torch.maximum(w_t.abs().amax(), bcs.velmax_extra(u_t, a)).clamp(min=1e-10)),
                mesh)
            dt_cfl = cfg.cfl_target * cfl_scale * h / vel_max
            if cfg.use_les:
                dt = torch.minimum(dt_cfl, 0.125 * h * h / nu_stab)
            else:
                dt = dt_cfl.clamp(max=0.125 * h * h / cfg.nu)
            dt = dt.clamp(cfg.dt_min, cfg.dt_max)
        else:
            dt = self.dt_base

        u_new, v_new, w_new, a, phi, sums, div_star = self._stage(
            ts, u_t, v_t, w_t, a, windows, NUT, ts.p, dt, extras)
        if cfg.time_scheme == "rk2":  # ν_t refreshed from the first stage
            (u_new, v_new, w_new), a, phi, sums, div_star = self._heun(
                ts, dt, (u_t, v_t, w_t), ((u_new, v_new, w_new), phi, sums), extras)

        new_ts = MAC3DState(u=u_new, v=v_new, w=w_new, p=phi, t=ts.t + dt, step=ts.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_ts, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero, zero)
        UN, VN, WNz = self._pad(u_new, v_new, w_new, a, ts)
        div_post = ((UN[:, 1:-1, 2:] - UN[:, 1:-1, 1:-1]) * (1.0 / dx)
                    + (VN[:, 2:, 1:-1] - VN[:, 1:-1, 1:-1]) * (1.0 / dy)
                    + (WNz[1:, 1:-1, 1:-1] - WNz[:-1, 1:-1, 1:-1]) * (1.0 / dz))
        ucc = 0.5 * (UN[:, 1:-1, 1:-1] + UN[:, 1:-1, 2:])
        vcc = 0.5 * (VN[:, 1:-1, 1:-1] + VN[:, 2:, 1:-1])
        wcc = 0.5 * (WNz[:-1, 1:-1, 1:-1] + WNz[1:, 1:-1, 1:-1])
        # ω_x at the interior (z-face, y-face) edges, as mac3d's diagnostic
        dwdy = ((WNz[:, 1:1 + ny_l, 1:1 + nx_l] - WNz[:, :ny_l, 1:1 + nx_l]) * (1.0 / dy))[1:nz]
        dvdz = (VN[1:, 1:1 + ny_l, 1:1 + nx_l] - VN[:-1, 1:1 + ny_l, 1:1 + nx_l]) * (1.0 / dz)
        vort = torch.where(ro >= 1, dwdy - dvdz, 0.0)
        div_pre, div_post_m, max_vel, vort_max = pmax(torch.stack([
            div_star.abs().amax(), div_post.abs().amax(),
            torch.maximum(torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                          w_new.abs().amax()),
            vort.abs().amax()]), mesh).unbind(0)
        totals = psum(torch.stack([(0.5 * (ucc * ucc + vcc * vcc + wcc * wcc)).sum(), *sums]),
                      mesh)
        f = [zero, zero, zero]
        cell = dx * dy * dz
        for k in range(len(sums)):  # each body's momentum sink is its force
            f[k % 3] = f[k % 3] + totals[1 + k] * cell / dt
        return new_ts, StepMetrics(
            dt=dt, div_pre=div_pre, div_post=div_post_m, max_vel=max_vel,
            energy=totals[0] / self.n_global, vort_max=vort_max, poisson_res=zero,
            fx=f[0], fy=f[1], fz=f[2])


def make_mac3d_explicit_step(cfg: MAC3DConfig, mesh: GridMesh, bcs: MAC3DLocalBCs,
                             use_ibm: bool = False, ibm_ramp_steps: int = 0, moving_body=None,
                             moving_scheme: str = "penalize", ibm_ghost=None, *,
                             device=None) -> MAC3DExplicitStep:
    """Build the explicit-communication 3D MAC step on the trimmed blocks:
    ``step(tstate, cfl_scale[, mask_u_t, mask_v_t, mask_w_t]) -> (tstate,
    StepMetrics)``. The optional masks are this rank's blocks of
    :func:`trim_face_masks3d`. ``ibm_ghost`` (the whole-grid
    ``ibm_ghost.GhostIBM3D``) gives the ghost-cell IBM, cut into this
    rank's tables here; ``moving_body`` (``ibm.MovingBody3D``) a
    moving sphere, by sharp masks or, with ``moving_scheme="ghost"``, the
    moving ghost. The JAX package's refusals hold: Chorin projection, Euler
    steps, the DCT solve, and no dynamic LES with a moving body."""
    return MAC3DExplicitStep(cfg, mesh, bcs, use_ibm, ibm_ramp_steps, moving_body,
                             moving_scheme, ibm_ghost, device=device)


def make_cavity3d_mac_explicit_step(cfg: MAC3DConfig, mesh: GridMesh, lid_velocity: float = 1.0,
                                    *, device=None) -> MAC3DExplicitStep:
    """The explicit-communication 3D MAC step of the lid-driven cavity (the
    lid at z_hi moving in +x): ``step(tstate, cfl_scale)``."""
    g = cfg.grid
    return make_mac3d_explicit_step(cfg, mesh, cavity3d_local_bcs(g.nx, g.ny, lid_velocity),
                                    device=device)


def make_sphere_mac3d_explicit_step(cfg: MAC3DConfig, mesh: GridMesh, v_inf: float = 1.0,
                                    ibm_ramp_steps: int = 0, inlet_profile=None, *,
                                    device=None) -> MAC3DExplicitStep:
    """The explicit-communication 3D MAC step of the external flow past an
    immersed body (the ``sphere`` case): ``step(tstate, cfl_scale, mask_u_t,
    mask_v_t, mask_w_t)`` with this rank's blocks of :func:`trim_face_masks3d`;
    ``inlet_profile`` the case's whole-grid (nz, ny) inflow modulation."""
    g = cfg.grid
    bcs = external_flow3d_local_bcs(g.nx, g.ny, g.nz, v_inf, inlet_profile=inlet_profile,
                                    mesh=mesh)
    return make_mac3d_explicit_step(cfg, mesh, bcs, use_ibm=True, ibm_ramp_steps=ibm_ramp_steps,
                                    device=device)


def make_sphere_ghost_mac3d_explicit_step(cfg: MAC3DConfig, mesh: GridMesh, ghost,
                                          v_inf: float = 1.0, ibm_ramp_steps: int = 0,
                                          inlet_profile=None, *,
                                          device=None) -> MAC3DExplicitStep:
    """The ghost-cell sphere (``sphere`` with ``ibm_scheme="ghost"``) on the
    mesh: ``ghost`` is the whole-grid ``GhostIBM3D``, cut into this rank's
    tables, which the step holds: ``step(tstate, cfl_scale)``."""
    g = cfg.grid
    bcs = external_flow3d_local_bcs(g.nx, g.ny, g.nz, v_inf, inlet_profile=inlet_profile,
                                    mesh=mesh)
    return make_mac3d_explicit_step(cfg, mesh, bcs, ibm_ghost=ghost,
                                    ibm_ramp_steps=ibm_ramp_steps, device=device)


def make_moving_body_mac3d_explicit_step(cfg: MAC3DConfig, mesh: GridMesh, moving_body,
                                         ibm_ramp_steps: int = 0,
                                         moving_scheme: str = "penalize", *,
                                         device=None) -> MAC3DExplicitStep:
    """The explicit-communication 3D MAC step of a moving sphere
    (``ibm.MovingBody3D``) in a quiescent free-slip box:
    ``step(tstate, cfl_scale)``."""
    g = cfg.grid
    return make_mac3d_explicit_step(cfg, mesh, free_slip3d_local_bcs(g.nx, g.ny),
                                    moving_body=moving_body, ibm_ramp_steps=ibm_ramp_steps,
                                    moving_scheme=moving_scheme, device=device)
