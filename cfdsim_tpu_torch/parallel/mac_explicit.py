"""The staggered (MAC) step on rank blocks (``cfdsim_tpu.parallel.mac_explicit``).

The state is the *trimmed* MAC state (``parallel/mac_sharded.py``): the
last boundary face of u and v dropped, every field (ny, nx) and cut into
(ny/py, nx/px) blocks; u_t[j, i] is the u-face at global face index i,
v_t[j, i] the v-face at global row-face j. Width-2 halo exchanges rebuild
each block's neighbourhood, and every boundary is a *global-index masked
write*:

- ``pre``: the ``set_normal`` writes that land inside the trimmed arrays (u
  face 0, v row-face 0), applied before the exchange so that neighbours
  receive post-BC values;
- ``post``: writes on the halo-padded arrays for the positions outside the
  trimmed arrays, the dropped boundary faces (u face nx, v row-face ny)
  and the tangential ghost lines of ``MACBCs.extend``, each a
  ``torch.where(global_index == …, f(roll(·)), ·)``, so only the ranks that
  hold those positions change anything.

The advection and diffusion mirror ``models/mac.py`` (the same
divergence-form fluxes and van Leer MUSCL slopes), the single-device
arrays' edge behaviour (zero slopes at the first and last face)
reproduced by global-index masks. The pressure solve is any method of the
single-device solver through ``poisson2d_explicit.DistributedPoisson2D``
(the exact pencil DCT, with which the projection stays exact to float32
rounding across the mesh, by default). ``time_scheme="rk2"`` is Heun's
method with one projection per stage, the second stage's BCs and body at
t + dt (``models/mac.py``); ``projection="incremental"`` carries the lagged
pressure gradient in the predictor and solves for the increment from a
zero start, p = p_warm + φ, p_warm this rank's block of the state's p.
``diffusion="implicit"`` (Crank–Nicolson, the lid cavity) solves each
component's Helmholtz problem exactly on the pencils
(``transforms.MacHelmholtzLocal``), with c = ½·dt·ν from the device dt and
the lid's right-hand-side fix as a global-row masked add.

A static body is penalized by trimmed face masks (call-time blocks) or
forced by the ghost-cell IBM (``ibm_scheme="ghost"``): this rank's tables
of the whole-grid ``GhostIBM2D`` (``ibm_ghost_explicit.
partition_ghost_ibm2d``), both components' two sweeps on one exchange each.

A moving body (``moving_body=``) is forced on each rank's block: its sharp
face masks rebuilt every step from this rank's lines of the single-device
step's float32 face coordinates, or, with ``moving_scheme="ghost"``, the
ghost faces classified again on the block and their probes gathered from
exchanged windows (``ibm_ghost_explicit.py``); its momentum sums over the
mesh into the body force.

``storage="bf16"`` keeps the trimmed u and v in bfloat16 between steps, as
``models/mac.py`` does: upcast once, float32 inside, rounded once at the
end; the metrics read the float32 fields.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.ibm import ibm_ramp
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.models.mac import MACConfig, MACState, _face_value, _limited_slope
from cfdsim_tpu_torch.parallel.explicit import check_divisible, step_device
from cfdsim_tpu_torch.parallel.halo import global_indices, halo_exchange, halo_exchange_edges
from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import (
    GhostTables,
    MovingBodyLocal,
    apply_ghost_forcing_stack,
    moving_ghost_width_2d,
    partition_ghost_ibm2d,
)
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum
from cfdsim_tpu_torch.parallel.poisson2d_explicit import DistributedPoisson2D
from cfdsim_tpu_torch.parallel.transforms import MacHelmholtzLocal


class MACLocalBCs(NamedTuple):
    """MAC boundary conditions in the masked-write local form.

    ``pre(u_t, v_t, gfu, grv, state)`` applies the set_normal writes inside
    the trimmed arrays. ``aux(u_t, v_t, gfu, grv, state)`` computes the BC
    numbers that need a reduction over the mesh (the mass-consistent
    outflow shift). ``post_u(U, gr, gf, state, aux)`` / ``post_v(V, gr, gc,
    state, aux)`` write the dropped boundary face and the tangential ghost
    lines of a padded block. Each returns new tensors."""

    pre: Callable
    aux: Callable
    post_u: Callable
    post_v: Callable


def cavity_mac_local_bcs(ny: int, nx: int, lid_velocity: float = 1.0) -> MACLocalBCs:
    """The masked-write form of ``mac.cavity_bcs`` (no-slip walls, the lid)."""

    def pre(u_t, v_t, gfu, grv, state):
        return torch.where(gfu == 0, 0.0, u_t), torch.where(grv == 0, 0.0, v_t)

    def aux(u_t, v_t, gfu, grv, state):
        return ()

    def post_u(U, gr, gf, state, aux_):
        U = torch.where(gf == nx, 0.0, U)  # the dropped right-wall face
        below = torch.roll(U, -1, 0)  # the value one real row up (gr + 1)
        above = torch.roll(U, 1, 0)
        U = torch.where(gr == -1, -below, U)  # bottom wall: u_t = 0
        return torch.where(gr == ny, 2.0 * lid_velocity - above, U)  # the lid

    def post_v(V, gr, gc, state, aux_):
        V = torch.where(gr == ny, 0.0, V)  # the dropped top-wall face
        right = torch.roll(V, -1, 1)
        left = torch.roll(V, 1, 1)
        V = torch.where(gc == -1, -right, V)  # left wall: v_t = 0
        return torch.where(gc == nx, -left, V)  # right wall

    return MACLocalBCs(pre, aux, post_u, post_v)


def free_slip_mac_local_bcs(ny: int, nx: int) -> MACLocalBCs:
    """The masked-write form of ``mac.free_slip_bcs`` (zero normal velocity,
    zero tangential shear)."""

    def pre(u_t, v_t, gfu, grv, state):
        return torch.where(gfu == 0, 0.0, u_t), torch.where(grv == 0, 0.0, v_t)

    def aux(u_t, v_t, gfu, grv, state):
        return ()

    def post_u(U, gr, gf, state, aux_):
        U = torch.where(gf == nx, 0.0, U)
        below = torch.roll(U, -1, 0)
        above = torch.roll(U, 1, 0)
        U = torch.where(gr == -1, below, U)  # free slip: ∂u/∂y = 0
        return torch.where(gr == ny, above, U)

    def post_v(V, gr, gc, state, aux_):
        V = torch.where(gr == ny, 0.0, V)
        right = torch.roll(V, -1, 1)
        left = torch.roll(V, 1, 1)
        V = torch.where(gc == -1, right, V)  # free slip: ∂v/∂x = 0
        return torch.where(gc == nx, left, V)

    return MACLocalBCs(pre, aux, post_u, post_v)


def external_flow_mac_local_bcs(ny: int, nx: int, dy: float, y_min: float, y_max: float,
                                v_inf: float, perturb_amp: float = 0.01,
                                perturb_ramp_steps: int = 1000, y_centers=None,
                                mesh: GridMesh = None) -> MACLocalBCs:
    """The masked-write form of ``mac.external_flow_bcs``: perturbed inflow
    at x_lo, mass-consistent zero-gradient outflow at x_hi, free slip top
    and bottom. The inflow profile is recomputed from the global row index
    with the expression ``cases.cylinder_mac`` feeds the single-device BCs.
    On a stretched grid ``y_centers`` (length ny) gives the u-row centres,
    read by global row index. ``mesh`` is the mesh the outflow shift is
    reduced over."""
    if mesh is None:
        raise ValueError("external_flow_mac_local_bcs needs the mesh (its outflow shift is "
                         "a sum over the mesh)")
    yc = None if y_centers is None else torch.as_tensor(
        np.asarray(y_centers, np.float32), device=mesh.device)
    last_x = mesh.ix == mesh.px - 1

    def _inflow(gr, step):
        if yc is None:
            y = y_min + (gr.to(torch.float32) + 0.5) * dy
        else:
            y = yc[gr.clamp(0, ny - 1).long()]
        s = step.to(torch.float32)
        scale = (s / perturb_ramp_steps).clamp(max=1.0) * perturb_amp
        pert = scale * torch.sin(2.0 * math.pi * y / y_max + 0.02 * s)
        return v_inf * (1.0 + pert)

    def pre(u_t, v_t, gfu, grv, state):
        u_t = torch.where(gfu == 0, _inflow(grv, state.step), u_t)
        return u_t, torch.where(grv == 0, 0.0, v_t)

    def aux(u_t, v_t, gfu, grv, state):
        # mean(u[:, 0] − u[:, nx−1]) over the global rows: both sums in one
        # all_reduce
        s0 = torch.where(gfu == 0, u_t, 0.0).sum()
        s1 = u_t[:, -1].sum() if last_x else torch.zeros_like(s0)
        s = psum(torch.stack([s0, s1]), mesh)
        return (s[0] - s[1]) / ny

    def post_u(U, gr, gf, state, mcorr):
        left = torch.roll(U, 1, 1)  # the value at face gf − 1
        U = torch.where(gf == nx, left + mcorr, U)  # outflow copy + shift
        below = torch.roll(U, -1, 0)
        above = torch.roll(U, 1, 0)
        U = torch.where(gr == -1, below, U)  # free slip: ∂u/∂y = 0
        return torch.where(gr == ny, above, U)

    def post_v(V, gr, gc, state, aux_):
        V = torch.where(gr == ny, 0.0, V)  # the far-field wall face
        right = torch.roll(V, -1, 1)
        left = torch.roll(V, 1, 1)
        V = torch.where(gc == -1, -right, V)  # inflow: v = 0
        return torch.where(gc == nx, left, V)  # outflow: ∂v/∂x = 0

    return MACLocalBCs(pre, aux, post_u, post_v)


class MACImplicitLocal(NamedTuple):
    """The lid cavity's implicit-viscous solves on trimmed blocks
    (``models/mac.py::cavity_implicit_kit`` on the mesh): ``solve_u(b,
    c)``, ``solve_v(b, c)`` (:class:`~cfdsim_tpu_torch.parallel.transforms.
    MacHelmholtzLocal`) and u's right-hand-side fix ``rhs_fix_u(r, c, gr)``
    (``gr`` the block's global rows; v's BCs are homogeneous)."""

    solve_u: nn.Module
    solve_v: nn.Module
    rhs_fix_u: Callable


def cavity_implicit_local(grid, mesh: GridMesh, lid_velocity: float = 1.0) -> MACImplicitLocal:
    """``mac.cavity_implicit_kit`` on the mesh: u DST-II in y and DST-I in x,
    v DST-I in y and DST-II in x; the lid adds c·2·U_lid/dy² to the top
    u-row."""
    ny, nx, dx, dy = grid.ny, grid.nx, grid.dx, grid.dy
    ay = 1.0 / (dy * dy)

    def rhs_fix_u(r, c, gr):
        return torch.where(gr == ny - 1, r + c * 2.0 * lid_velocity * ay, r)

    return MACImplicitLocal(MacHelmholtzLocal((ny, nx), ("dst2", "dst1"), dx, dy, mesh),
                            MacHelmholtzLocal((ny, nx), ("dst1", "dst2"), dx, dy, mesh),
                            rhs_fix_u)


def _advect_local(U, V, grU, gfU, grV, gcV, ny: int, nx: int, dx: float, dy: float,
                  scheme: str):
    """Divergence-form MAC advection on width-2 padded blocks: (conv_u,
    conv_v) on the *owned* faces (ny_l, nx_l). Entries at global boundary
    faces are not meaningful; the caller masks them (the predictor updates
    interior faces only, as ``mac.py`` does).

    Index map (W = 2): U[r, c] ↔ u(row gy0−2+r, face gx0−2+c), with the
    tangential ghost rows −1 and ny written by post_u; V[r, c] ↔ v(row-face
    gy0−2+r, col gx0−2+c), ghost cols −1 and nx. The corner window is
    CO[a, b] ↔ corner (gy0−1+a, gx0−1+b), (ny_l+3, nx_l+3)."""
    UC = 0.5 * (U[:, :-1] + U[:, 1:])  # cell (gy0−2+r, gx0−2+c)
    VC = 0.5 * (V[:-1, :] + V[1:, :])  # cell (gy0−2+r, gx0−2+c)
    UY = 0.5 * (U[:-1, :] + U[1:, :])  # corner (gy0−1+r, face gx0−2+c)
    VX = 0.5 * (V[:, :-1] + V[:, 1:])  # corner (gy0−2+r, gx0−1+c)
    UYc = UY[:, 1:]  # the corner window (gy0−1+a, gx0−1+b)
    VXc = VX[1:, :]

    if scheme == "central":
        FU = UC * UC
        GU = VXc * UYc
        FV = UYc * VXc
        GV = VC * VC
    elif scheme in ("upwind", "tvd"):
        def slopes_x(q, mask_zero):
            s = _limited_slope(q[:, 1:-1] - q[:, :-2], q[:, 2:] - q[:, 1:-1])
            return torch.where(mask_zero, 0.0, F.pad(s, (1, 1)))

        def slopes_y(q, mask_zero):
            s = _limited_slope(q[1:-1, :] - q[:-2, :], q[2:, :] - q[1:-1, :])
            return torch.where(mask_zero, 0.0, F.pad(s, (0, 0, 1, 1)))

        if scheme == "tvd":
            # the single-device slopes are zero on the arrays' boundary lines;
            # by global index here, and zero outside the domain so that halo
            # junk stays inert
            SXU = slopes_x(U, (gfU <= 0) | (gfU >= nx))
            SYU = slopes_y(U, (grU <= -1) | (grU >= ny))  # ue's ghost rows
            SYV = slopes_y(V, (grV <= 0) | (grV >= ny))
            SXV = slopes_x(V, (gcV <= -1) | (gcV >= nx))  # ve's ghost cols
        else:
            SXU = SYU = torch.zeros_like(U)
            SYV = SXV = torch.zeros_like(V)
        FU = UC * _face_value(U[:, :-1], U[:, 1:], UC, SXU[:, :-1], SXU[:, 1:])
        GU = VXc * _face_value(U[:-1, 1:], U[1:, 1:], VXc, SYU[:-1, 1:], SYU[1:, 1:])
        GV = VC * _face_value(V[:-1, :], V[1:, :], VC, SYV[:-1, :], SYV[1:, :])
        FV = UYc * _face_value(V[1:, :-1], V[1:, 1:], UYc, SXV[1:, :-1], SXV[1:, 1:])
    else:
        raise ValueError(f"unknown MAC scheme {scheme!r}")

    ny_l = U.shape[0] - 4
    nx_l = U.shape[1] - 4
    # conv_u at the owned face (gy0+j, gx0+i):
    #   (F_u[cell i] − F_u[cell i−1])/dx + (G_u[corner j+1] − G_u[corner j])/dy
    conv_u = (FU[2:2 + ny_l, 2:2 + nx_l] - FU[2:2 + ny_l, 1:1 + nx_l]) * (1.0 / dx) + (
        GU[2:2 + ny_l, 1:1 + nx_l] - GU[1:1 + ny_l, 1:1 + nx_l]) * (1.0 / dy)
    # conv_v at the owned row-face (gy0+j, gx0+i):
    #   (F_v[corner i+1] − F_v[corner i])/dx + (G_v[cell j] − G_v[cell j−1])/dy
    conv_v = (FV[1:1 + ny_l, 2:2 + nx_l] - FV[1:1 + ny_l, 1:1 + nx_l]) * (1.0 / dx) + (
        GV[2:2 + ny_l, 2:2 + nx_l] - GV[1:1 + ny_l, 2:2 + nx_l]) * (1.0 / dy)
    return conv_u, conv_v


def _laplacians(U, V, ax: float, ay: float):
    """5-point Laplacians at the owned faces of width-2 padded blocks."""
    def lap(Q):
        c = Q[2:-2, 2:-2]
        return (Q[2:-2, 3:-1] - 2.0 * c + Q[2:-2, 1:-3]) * ax + (
            Q[3:-1, 2:-2] - 2.0 * c + Q[1:-3, 2:-2]) * ay

    return lap(U), lap(V)


def uniform_moving_body(body, scheme: str, g, mesh: GridMesh, local_shape, *,
                        device) -> MovingBodyLocal:
    """:class:`MovingBodyLocal` on the uniform MAC grid ``g``: the taper
    min(dx, dy) and δ = 1.5·min(dx, dy) of ``models/mac.py``, the window of
    :func:`~cfdsim_tpu_torch.parallel.ibm_ghost_explicit.moving_ghost_width_2d`."""
    dx, dy = g.dx, g.dy
    hb = min(dx, dy)
    xf = g.x_min + np.arange(g.nx + 1) * dx
    yc = g.y_min + (np.arange(g.ny) + 0.5) * dy
    xc = g.x_min + (np.arange(g.nx) + 0.5) * dx
    yf = g.y_min + np.arange(g.ny + 1) * dy
    return MovingBodyLocal(body, scheme, ((xf, yc), (xc, yf)),
                           (((g.x_min, dx), (g.y_min + 0.5 * dy, dy)),
                            ((g.x_min + 0.5 * dx, dx), (g.y_min, dy))), hb, 1.5 * hb,
                           moving_ghost_width_2d(1.5 * hb, dx, dy), mesh, local_shape,
                           device=device)


class MACBlockStep(nn.Module):
    """What the MAC tiers' steps on rank blocks share: Heun's rk2. A tier
    gives ``_set_normal(*fields, ts) -> (*fields, a)`` (its BC writes on
    the trimmed fields and the BC numbers of the post writes) and
    ``_restage(ts, fields, a, p_warm, dt, extras) -> (fields, p, body
    sums, aux)``: one projected stage from BC-consistent trimmed fields,
    with the halos and ν_t it builds from them."""

    def _heun(self, ts, dt, start, first, extras):
        """``models/mac.py``'s rk2: the step's trimmed ``start`` fields
        averaged with a second projected stage from the first stage's
        ``first`` = (fields, p, body sums), with its BCs and body at t + dt;
        p and the body sums averaged alike. Returns (fields, a, p, body
        sums, the second stage's aux)."""
        fields, p, sums = first
        ts2 = ts._replace(t=ts.t + dt)
        *f1, a1 = self._set_normal(*fields, ts2)
        f2, p2, sums2, aux = self._restage(ts2, f1, a1, p, dt, extras)
        *f, a = self._set_normal(*(0.5 * (x + y) for x, y in zip(start, f2)), ts2)
        return f, a, 0.5 * (p + p2), [0.5 * (s1 + s2) for s1, s2 in zip(sums, sums2)], aux


class MAC2DBlockStep(MACBlockStep):
    """The 2D MAC tiers' BC writes and halo padding on trimmed blocks
    (``bcs``: :class:`MACLocalBCs`; ``gr{w}``, ``gc{w}``: the global
    indices of blocks padded by w)."""

    def _set_normal(self, u_t, v_t, ts):
        """The trimmed arrays' set_normal, and the BC numbers of the post
        writes."""
        u_t, v_t = self.bcs.pre(u_t, v_t, self.gc0, self.gr0, ts)
        return u_t, v_t, self.bcs.aux(u_t, v_t, self.gc0, self.gr0, ts)

    def _pad(self, u_t, v_t, a, w: int, ts):
        """Halo-pad the trimmed fields (one exchange for both) and apply
        the post BC writes → the full local MAC arrays."""
        U, V = halo_exchange(torch.stack([u_t, v_t]), self.mesh, w).unbind(0)
        gr, gc = getattr(self, f"gr{w}"), getattr(self, f"gc{w}")
        return (self.bcs.post_u(U, gr, gc, ts, a), self.bcs.post_v(V, gr, gc, ts, a),
                (gr, gc))


class MACExplicitStep(MAC2DBlockStep):
    """``step(tstate, cfl_scale[, mask_u_t, mask_v_t]) -> (tstate,
    StepMetrics)`` on this rank's trimmed blocks; see
    :func:`make_mac_explicit_step`."""

    def __init__(self, cfg: MACConfig, mesh: GridMesh, bcs: MACLocalBCs, use_ibm: bool = False,
                 ibm_ramp_steps: int = 0, moving_body=None, moving_scheme: str = "penalize",
                 implicit: MACImplicitLocal = None, ibm_ghost=None, *, device=None):
        super().__init__()
        if moving_scheme not in ("penalize", "ghost"):
            raise ValueError(f"unknown moving_scheme {moving_scheme!r}")
        if ibm_ghost is not None and use_ibm:
            raise ValueError("ibm_ghost and use_ibm are mutually exclusive")
        g = cfg.grid
        self.local_shape = check_divisible(g, mesh, min_block=4)
        if cfg.time_scheme not in ("euler", "rk2"):
            raise ValueError(f"unknown MAC time scheme {cfg.time_scheme!r}")
        if cfg.projection not in ("chorin", "incremental"):
            raise ValueError(f"unknown MAC projection {cfg.projection!r}")
        if cfg.diffusion not in ("explicit", "implicit"):
            raise ValueError(f"unknown MAC diffusion {cfg.diffusion!r}")
        if cfg.diffusion == "implicit":
            if implicit is None:
                raise ValueError("diffusion='implicit' needs the implicit solves of the BCs "
                                 "(cavity_implicit_local)")
            if cfg.use_les or cfg.time_scheme != "euler":
                raise ValueError("diffusion='implicit' is Crank–Nicolson within the euler step "
                                 "with constant ν (models/mac.py)")
        self.cfg, self.mesh, self.bcs = cfg, mesh, bcs
        self.implicit = implicit
        if implicit is not None:  # the solves' tables move with the step
            self.solve_u, self.solve_v = implicit.solve_u, implicit.solve_v
        self.use_ibm, self.ibm_ramp_steps = use_ibm, ibm_ramp_steps
        self.device = step_device(mesh, device)
        self.ghost, self.ghost_width = None, None
        if ibm_ghost is not None:
            tables, self.ghost_width = partition_ghost_ibm2d(ibm_ghost, g.nx, g.ny, mesh,
                                                             device=self.device)
            self.ghost = GhostTables({"u": tables.u, "v": tables.v}, device=self.device)
        self.poisson = DistributedPoisson2D((g.ny, g.nx), g.dx, g.dy, cfg.poisson, mesh)
        self.reads_host = self.poisson.reads_host
        self.collectives = True
        self.n_global = float(g.ny * g.nx)
        for w in (0, 1, 2):  # global (row, col) indices of blocks padded by w
            gr, gc = global_indices(self.local_shape, mesh, w)
            self.register_buffer(f"gr{w}", gr.contiguous())
            self.register_buffer(f"gc{w}", gc.contiguous())
        gri, gci = global_indices(self.local_shape, mesh, 1)  # ν_t's width-1 cell window
        self.register_buffer("gri", gri.contiguous())
        self.register_buffer("gci", gci.contiguous())
        self.register_buffer("dt_base", torch.tensor(cfg.dt_base, dtype=torch.float32,
                                                     device=self.device))
        self.register_buffer("warmup_dt", torch.tensor(cfg.warmup_dt, dtype=torch.float32,
                                                       device=self.device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=self.device))
        self.register_buffer("visc_num", torch.tensor(0.2 * min(g.dx, g.dy) ** 2,
                                                      dtype=torch.float32, device=self.device))
        self.moving = None
        if moving_body is not None:
            self.moving = uniform_moving_body(moving_body, moving_scheme, g, mesh,
                                              self.local_shape, device=self.device)

    def _les(self, U, V):
        """The staggered Smagorinsky LES (mac.smagorinsky_viscosity_mac on
        the padded blocks): ν_t on a width-1 cell window around the owned
        cells, the single-device edge padding of ν reproduced by global-index
        roll substitutions at the domain's edges, with the gradients the
        flux-form diffusion reads."""
        cfg = self.cfg
        g = cfg.grid
        ny, nx, dx, dy = g.ny, g.nx, g.dx, g.dy
        idx, idy = 1.0 / dx, 1.0 / dy
        DUX0 = (U[:, 1:] - U[:, :-1]) * idx  # cells (gy0−2+r, gx0−2+c)
        DVY0 = (V[1:, :] - V[:-1, :]) * idy
        DUDY = (U[1:, :] - U[:-1, :]) * idy  # corners (gy0−1+r, ·)
        DVDX = (V[:, 1:] - V[:, :-1]) * idx  # corners (·, gx0−1+c)
        SH = DUDY[:, 1:] + DVDX[1:, :]  # the canonical corners
        SHC = 0.25 * (SH[:-1, :-1] + SH[:-1, 1:] + SH[1:, :-1] + SH[1:, 1:])
        DUXw = DUX0[1:-1, 1:]
        DVYw = DVY0[1:, 1:-1]
        s_mag = torch.sqrt(2.0 * (DUXw * DUXw + DVYw * DVYw) + SHC * SHC)
        cs_d2 = (cfg.smagorinsky_constant * (dx * dy) ** 0.5) ** 2
        NUT = cs_d2 * s_mag
        NUT = torch.where(self.gri == -1, torch.roll(NUT, -1, 0), NUT)
        NUT = torch.where(self.gri == ny, torch.roll(NUT, 1, 0), NUT)
        NUT = torch.where(self.gci == -1, torch.roll(NUT, -1, 1), NUT)
        NUT = torch.where(self.gci == nx, torch.roll(NUT, 1, 1), NUT)
        return NUT, DUXw, DVYw, DUDY, DVDX

    def _viscous(self, U, V, les):
        """ν∇²u, ν∇²v at the owned faces, or with LES the flux-form
        variable-ν diffusion (mac._diffuse_les on blocks)."""
        cfg = self.cfg
        dx, dy = cfg.grid.dx, cfg.grid.dy
        ny_l, nx_l = self.local_shape
        if les is None:
            lap_u, lap_v = _laplacians(U, V, 1.0 / (dx * dx), 1.0 / (dy * dy))
            return cfg.nu * lap_u, cfg.nu * lap_v
        NUT, DUXw, DVYw, DUDY, DVDX = les
        NUE = cfg.nu + NUT
        NU_K = 0.25 * (NUE[:-1, :-1] + NUE[:-1, 1:] + NUE[1:, :-1] + NUE[1:, 1:])
        FUX = NUE[1:-1, :] * DUXw[1:-1, :]
        lap_u_x = (FUX[:, 1:1 + nx_l] - FUX[:, 0:nx_l]) * (1.0 / dx)
        DUDYc = DUDY[:, 1:][1:ny_l + 2, 1:nx_l + 2]
        FUY = NU_K * DUDYc
        lap_u_y = ((FUY[1:, :] - FUY[:-1, :]) * (1.0 / dy))[:, :nx_l]
        FVY = NUE[:, 1:-1] * DVYw[:, 1:-1]
        lap_v_y = (FVY[1:1 + ny_l, :] - FVY[0:ny_l, :]) * (1.0 / dy)
        DVDXc = DVDX[1:, :][1:ny_l + 2, 1:nx_l + 2]
        FVX = NU_K * DVDXc
        lap_v_x = (FVX[:ny_l, 1:] - FVX[:ny_l, :-1]) * (1.0 / dx)
        return lap_u_x + lap_u_y, lap_v_x + lap_v_y

    def _stage(self, ts, u_t, v_t, a, U, V, les, p_warm, dt, extras):
        """One projected Euler stage (``models/mac.py::MACStep._stage``) from
        BC-consistent trimmed (u, v) and their width-2 padding (U, V), the
        BCs and the body at ``ts``'s time: (u_new, v_new, a, p, body sums,
        (div*, rhs, φ))."""
        cfg = self.cfg
        mesh = self.mesh
        g = cfg.grid
        ny, nx, dx, dy = g.ny, g.nx, g.dx, g.dy
        gr0, gc0 = self.gr0, self.gc0
        grP, gcP = self.gr2, self.gc2
        conv_u, conv_v = _advect_local(U, V, grP, gcP, grP, gcP, ny, nx, dx, dy, cfg.scheme)
        visc_u, visc_v = self._viscous(U, V, les)
        if cfg.projection == "incremental":
            PW = halo_exchange_edges(p_warm, mesh, 1)
            gpx = (PW[1:-1, 1:-1] - PW[1:-1, :-2]) * (1.0 / dx)
            gpy = (PW[1:-1, 1:-1] - PW[:-2, 1:-1]) * (1.0 / dy)
        if self.implicit is not None:
            # Crank–Nicolson: (I − c∇²)u* = u + dt(−conv + ½ν∇²u) + c·(BC
            # values), c = ½dtν, solved exactly on the pencils; the lagged
            # pressure gradient of the incremental projection in the rhs
            kit = self.implicit
            c = 0.5 * dt * cfg.nu
            ru = u_t + dt * (0.5 * visc_u - conv_u)
            rv = v_t + dt * (0.5 * visc_v - conv_v)
            if cfg.projection == "incremental":
                ru = ru - dt * gpx
                rv = rv - dt * gpy
            ru = kit.rhs_fix_u(ru, c, gr0)
            u_star = torch.where(gc0 >= 1, self.solve_u(ru, c), u_t)
            v_star = torch.where(gr0 >= 1, self.solve_v(rv, c), v_t)
        else:
            # the predictor on interior faces only (mac.py u[:, 1:-1], v[1:-1])
            u_star = u_t + torch.where(gc0 >= 1, dt * (visc_u - conv_u), 0.0)
            v_star = v_t + torch.where(gr0 >= 1, dt * (visc_v - conv_v), 0.0)
            if cfg.projection == "incremental":
                # the lagged pressure gradient; the projection solves for the increment
                u_star = u_star + torch.where(gc0 >= 1, -dt * gpx, 0.0)
                v_star = v_star + torch.where(gr0 >= 1, -dt * gpy, 0.0)
        u_star, v_star, a = self._set_normal(u_star, v_star, ts)

        # --- IBM penalization and its body force
        sums = []
        if self.use_ibm:
            mask_u_t, mask_v_t = extras
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            du_ibm = u_star * (strength * mask_u_t)
            dv_ibm = v_star * (strength * mask_v_t)
            u_star = u_star - du_ibm
            v_star = v_star - dv_ibm
            sums = [du_ibm.sum(), dv_ibm.sum()]
        if self.ghost is not None:
            # both components' sweeps share each exchange (a (1, ny_l, nx_l)
            # plane each: the tables address the 3D layout with z = 0)
            strength = ibm_ramp(ts.step, self.ibm_ramp_steps)
            (u_star, du_g), (v_star, dv_g) = apply_ghost_forcing_stack(
                [u_star[None], v_star[None]], [self.ghost.set("u"), self.ghost.set("v")], mesh,
                self.ghost_width, strength)
            u_star, v_star = u_star[0], v_star[0]
            sums = [du_g.sum(), dv_g.sum()]
        if self.moving is not None:
            (u_star, v_star), d_mb = self.moving(
                (u_star, v_star), ts.t, ibm_ramp(ts.step, self.ibm_ramp_steps))
            sums += [d.sum() for d in d_mb]

        # --- the projection (the adjoint MAC divergence and gradient)
        US, VS, _ = self._pad(u_star, v_star, a, 1, ts)
        div_star = (US[1:-1, 2:] - US[1:-1, 1:-1]) * (1.0 / dx) + (
            VS[2:, 1:-1] - VS[1:-1, 1:-1]) * (1.0 / dy)
        rhs = div_star / dt
        if cfg.poisson.method not in ("dct", "fft"):
            rhs = rhs - psum(rhs.sum(), mesh) / self.n_global  # Neumann solvability
        warm = torch.zeros_like(p_warm) if cfg.projection == "incremental" else p_warm
        phi = self.poisson(warm, rhs)
        PH = halo_exchange_edges(phi, mesh, 1)  # read by 5-point stencils only
        u_new = u_star + torch.where(
            gc0 >= 1, -dt * (PH[1:-1, 1:-1] - PH[1:-1, :-2]) * (1.0 / dx), 0.0)
        v_new = v_star + torch.where(
            gr0 >= 1, -dt * (PH[1:-1, 1:-1] - PH[:-2, 1:-1]) * (1.0 / dy), 0.0)
        u_new, v_new, a = self._set_normal(u_new, v_new, ts)
        u_new = u_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        v_new = v_new.clamp(-cfg.max_velocity, cfg.max_velocity)
        p_out = p_warm + phi if cfg.projection == "incremental" else phi
        return u_new, v_new, a, p_out, sums, (div_star, rhs, phi)

    def _restage(self, ts, fields, a, p_warm, dt, extras):
        U, V, _ = self._pad(*fields, a, 2, ts)
        les = self._les(U, V) if self.cfg.use_les else None
        u, v, _, p, sums, aux = self._stage(ts, *fields, a, U, V, les, p_warm, dt, extras)
        return (u, v), p, sums, aux

    def forward(self, tstate: MACState, cfl_scale, *extras):
        cfg = self.cfg
        mesh = self.mesh
        g = cfg.grid
        ny, nx = g.ny, g.nx
        dx, dy = g.dx, g.dy
        if tstate.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {tstate.u.device}")
        if len(extras) != (2 if self.use_ibm else 0):
            raise ValueError(f"the step takes {2 if self.use_ibm else 0} extra blocks, got "
                             f"{len(extras)}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        gr0, gc0 = self.gr0, self.gc0

        # float32 copies of the fields (under bf16 storage, the upcast)
        u_t, v_t, a = self._set_normal(tstate.u.float(), tstate.v.float(), tstate)
        U, V, (grP, gcP) = self._pad(u_t, v_t, a, 2, tstate)
        les = self._les(U, V) if cfg.use_les else None
        nu_total = None
        if les is not None:
            nu_total = cfg.nu + psum(les[0][1:-1, 1:-1].sum(), mesh) / self.n_global

        # --- adaptive dt (mac._adaptive_dt); the max is exact, so the halo's
        # duplicated faces cost nothing
        if cfg.adaptive_dt:
            real_u = (grP >= 0) & (grP < ny) & (gcP >= 0) & (gcP <= nx)
            real_v = (grP >= 0) & (grP <= ny) & (gcP >= 0) & (gcP < nx)
            vel_max = pmax(torch.maximum(torch.where(real_u, U.abs(), 0.0).amax(),
                                         torch.where(real_v, V.abs(), 0.0).amax()),
                           mesh).clamp(min=1e-10)
            h = min(dx, dy)
            dt = cfg.cfl_target * cfl_scale * h / vel_max
            if self.implicit is None:  # no viscous bound under implicit diffusion
                if nu_total is None:
                    dt = dt.clamp(max=0.2 * h * h / cfg.nu)
                else:
                    dt = torch.minimum(dt, self.visc_num / nu_total)
            dt = dt.clamp(cfg.dt_min, cfg.dt_max)
            if cfg.warmup_steps > 0:
                dt = torch.where(tstate.step < cfg.warmup_steps, self.warmup_dt, dt)
        else:
            dt = self.dt_base

        u_new, v_new, a, p, sums, aux = self._stage(tstate, u_t, v_t, a, U, V, les, tstate.p,
                                                    dt, extras)
        if cfg.time_scheme == "rk2":  # ν_t refreshed from the first stage
            (u_new, v_new), a, p, sums, aux = self._heun(
                tstate, dt, (u_t, v_t), ((u_new, v_new), p, sums), extras)
        div_star, rhs, phi = aux

        u_out, v_out = u_new, v_new
        if cfg.storage == "bf16":
            # round once a step; the metrics below read the float32 fields
            u_out, v_out = u_new.to(torch.bfloat16), v_new.to(torch.bfloat16)
        new_tstate = MACState(u=u_out, v=v_out, p=p, t=tstate.t + dt, step=tstate.step + 1)
        zero = self.zero
        if not cfg.compute_metrics:
            return new_tstate, StepMetrics(dt, zero, zero, zero, zero, zero, zero, zero, zero,
                                           zero)

        UN, VN, (grn, gcn) = self._pad(u_new, v_new, a, 1, tstate)
        div_post = (UN[1:-1, 2:] - UN[1:-1, 1:-1]) * (1.0 / dx) + (
            VN[2:, 1:-1] - VN[1:-1, 1:-1]) * (1.0 / dy)
        ucc = 0.5 * (UN[1:-1, 1:-1] + UN[1:-1, 2:])
        vcc = 0.5 * (VN[1:-1, 1:-1] + VN[2:, 1:-1])
        # vorticity at the interior corners (mac.vorticity_mac): the corner at
        # an owned cell's lower left reads one halo line
        dvdx = (VN[1:-1, 1:-1] - VN[1:-1, :-2]) * (1.0 / dx)
        dudy = (UN[1:-1, 1:-1] - UN[:-2, 1:-1]) * (1.0 / dy)
        vort = torch.where((gr0 >= 1) & (gc0 >= 1), dvdx - dudy, 0.0)
        # poisson_res: |lap_neumann(φ) − rhs| over all cells, φ the last solve's
        lap_n = self.poisson.lap(phi)
        real_un = (grn >= 0) & (grn < ny) & (gcn >= 0) & (gcn <= nx)
        real_vn = (grn >= 0) & (grn <= ny) & (gcn >= 0) & (gcn < nx)
        div_pre, div_post_m, max_vel, vort_max, poisson_res = pmax(torch.stack([
            div_star.abs().amax(),
            div_post.abs().amax(),
            torch.maximum(torch.where(real_un, UN.abs(), 0.0).amax(),
                          torch.where(real_vn, VN.abs(), 0.0).amax()),
            vort.abs().amax(),
            (lap_n - rhs).abs().amax(),
        ]), mesh).unbind(0)
        totals = psum(torch.stack([(0.5 * (ucc * ucc + vcc * vcc)).sum(), *sums]), mesh)
        # each body's momentum sink, summed over the mesh, is its force
        fx = fy = zero
        cell = dx * dy
        for k in range(1, len(sums), 2):
            fx = fx + totals[k] * cell / dt
            fy = fy + totals[k + 1] * cell / dt
        return new_tstate, StepMetrics(
            dt=dt, div_pre=div_pre, div_post=div_post_m, max_vel=max_vel,
            energy=totals[0] / self.n_global, vort_max=vort_max, poisson_res=poisson_res,
            fx=fx, fy=fy, fz=zero)


def make_mac_explicit_step(cfg: MACConfig, mesh: GridMesh, bcs: MACLocalBCs,
                           use_ibm: bool = False, ibm_ramp_steps: int = 0, moving_body=None,
                           moving_scheme: str = "penalize", implicit: MACImplicitLocal = None,
                           ibm_ghost=None, *, device=None) -> MACExplicitStep:
    """Build the explicit-communication MAC step on the trimmed blocks.

    Returns ``step(tstate, cfl_scale[, mask_u_t, mask_v_t]) -> (tstate,
    StepMetrics)``. The optional IBM masks are this rank's blocks of the
    face-sampled penalization masks, *trimmed* (``trim_face_masks``), whose
    boundary-adjacent lines must be zero. ``moving_body`` (``ibm.MovingBody``)
    is forced toward its velocity by sharp masks rebuilt every step or, with
    ``moving_scheme="ghost"``, by the moving ghost (the body at least the
    ghost's halo width + 1 samples inside the domain). ``implicit`` (e.g.
    :func:`cavity_implicit_local`) gives ``diffusion="implicit"`` its
    solves; ``ibm_ghost`` (the whole-grid ``ibm_ghost.GhostIBM2D``) the
    static ghost-cell body, cut into this rank's tables here."""
    return MACExplicitStep(cfg, mesh, bcs, use_ibm, ibm_ramp_steps, moving_body, moving_scheme,
                           implicit, ibm_ghost, device=device)


def trim_face_masks(mask_u, mask_v):
    """Trim face-sampled IBM masks to the (ny, nx) shape of the trimmed
    state (numpy), after checking that the boundary-adjacent lines the
    distributed step cannot see are zero (true for any body at least
    radius + 5dx from the domain boundary: the Gaussian shell is cut to 0
    there)."""
    mu = np.asarray(mask_u.cpu() if torch.is_tensor(mask_u) else mask_u)
    mv = np.asarray(mask_v.cpu() if torch.is_tensor(mask_v) else mask_v)
    if not (np.all(mu[:, 0] == 0.0) and np.all(mu[:, -2:] == 0.0)
            and np.all(mv[0, :] == 0.0) and np.all(mv[-2:, :] == 0.0)):
        raise ValueError(
            "IBM body touches the domain boundary; the trimmed sharded representation "
            "requires zero mask on boundary-adjacent faces")
    return mu[:, :-1].astype(np.float32), mv[:-1, :].astype(np.float32)


def make_cavity_mac_explicit_step(cfg: MACConfig, mesh: GridMesh, lid_velocity: float = 1.0,
                                  *, device=None) -> MACExplicitStep:
    """The explicit-communication MAC step of the lid-driven cavity."""
    bcs = cavity_mac_local_bcs(cfg.grid.ny, cfg.grid.nx, lid_velocity)
    implicit = (cavity_implicit_local(cfg.grid, mesh, lid_velocity)
                if cfg.diffusion == "implicit" else None)
    return make_mac_explicit_step(cfg, mesh, bcs, implicit=implicit, device=device)


def make_cylinder_mac_explicit_step(cfg: MACConfig, mesh: GridMesh, v_inf: float = 1.0,
                                    perturb_amp: float = 0.01, perturb_ramp_steps: int = 1000,
                                    ibm_ramp_steps: int = 0, *, device=None) -> MACExplicitStep:
    """The explicit-communication MAC step of the external flow (the
    cylinder). Call as ``step(tstate, cfl_scale, mask_u_t, mask_v_t)`` with
    this rank's blocks of the masks from :func:`trim_face_masks`."""
    g = cfg.grid
    bcs = external_flow_mac_local_bcs(g.ny, g.nx, g.dy, g.y_min, g.y_max, v_inf,
                                      perturb_amp=perturb_amp,
                                      perturb_ramp_steps=perturb_ramp_steps, mesh=mesh)
    return make_mac_explicit_step(cfg, mesh, bcs, use_ibm=True, ibm_ramp_steps=ibm_ramp_steps,
                                  device=device)


def make_cylinder_mac_ghost_explicit_step(cfg: MACConfig, mesh: GridMesh, ghost,
                                          v_inf: float = 1.0, perturb_amp: float = 0.01,
                                          perturb_ramp_steps: int = 1000,
                                          ibm_ramp_steps: int = 0, *,
                                          device=None) -> MACExplicitStep:
    """The ghost-cell cylinder (``cylinder_mac`` with ``ibm_scheme="ghost"``)
    on the mesh: ``ghost`` is the whole-grid ``GhostIBM2D``, cut into this
    rank's tables, which the step holds: ``step(tstate, cfl_scale)``."""
    g = cfg.grid
    bcs = external_flow_mac_local_bcs(g.ny, g.nx, g.dy, g.y_min, g.y_max, v_inf,
                                      perturb_amp=perturb_amp,
                                      perturb_ramp_steps=perturb_ramp_steps, mesh=mesh)
    return make_mac_explicit_step(cfg, mesh, bcs, ibm_ramp_steps=ibm_ramp_steps,
                                  ibm_ghost=ghost, device=device)


def make_moving_body_mac_explicit_step(cfg: MACConfig, mesh: GridMesh, moving_body,
                                       ibm_ramp_steps: int = 0, moving_scheme: str = "penalize",
                                       *, device=None) -> MACExplicitStep:
    """The explicit-communication MAC step of a moving body
    (``ibm.MovingBody``) in a quiescent free-slip box, the distributed twin
    of the ``cylinder_oscillating`` case: ``step(tstate, cfl_scale)``."""
    g = cfg.grid
    return make_mac_explicit_step(cfg, mesh, free_slip_mac_local_bcs(g.ny, g.nx),
                                  moving_body=moving_body, ibm_ramp_steps=ibm_ramp_steps,
                                  moving_scheme=moving_scheme, device=device)
