"""The 2D compressible Euler step on rank blocks
(``models/compressible.py`` made multi-rank; the JAX package runs this
tier on a mesh only through GSPMD).

Each rank holds its (4, ny/py, nx/px) block of the conserved state. A
forward-Euler stage runs the single-device ``euler_update`` (MUSCL faces,
whole-face Riemann fluxes in both sweeps, artificial viscosity, floors) on
the block's *window* (``halo.interior_window``): the block with ``width``
halo lines from the neighbours on the sides that face another block and
none on the global boundary, so the window's edge there is the global edge
and the update leaves it to the BCs as the single-device step does. MUSCL
reads two cells, so ``width`` is 2: one exchange per stage (two per
SSP-RK2 step), with the corners, then the BC writes on the window and the
update; the block is cropped out of the result.

The BCs are written on global indices: a rank writes a global edge only
where it holds it, on every line of its window (the halo lines of a
neighbour on the same edge get the values that neighbour writes). The
wedge's mirror-ghost slip wall (``ibm.apply_slip_wall_ghosts``) is cut into
per-rank tables: the ghosts in the window whose image stencils lie in it,
their indices local to the window; the window then widens by the largest
stencil excursion so every ghost within two cells of the block is filled,
and the final BC write of a step takes one more exchange. The
zero-momentum mask, the pinned cavity block and the real plate's momentum
mask are cut into blocks (the plate's into windows).

The acoustic dt is one ``all_reduce`` MAX (|u| + a and |v| + a together);
the metrics take one MAX (max speed, −min ρ, −min p, max Mach) and one SUM
(the kinetic energy). Every rank calls the same collectives in the same
order. Every Riemann solver and reconstruction of the single-device step
is supported. The cases' BC descriptions (``explicit_spec``) come from
``cases.py::wedge`` and ``cavity_supersonic``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.ibm import apply_slip_wall_ghosts, ghost_map_to
from cfdsim_tpu_torch.models.compressible import (
    CompressibleConfig,
    CompressibleMetrics,
    CompressibleState,
    CompressibleStep,
)
from cfdsim_tpu_torch.ops.limiters import SLOPE_LIMITERS
from cfdsim_tpu_torch.parallel.explicit import step_device
from cfdsim_tpu_torch.parallel.halo import interior_window
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum
from cfdsim_tpu_torch.solvers.riemann import FLUXES, cons_to_prim, sound_speed

FLIP_V = (1.0, 1.0, -1.0, 1.0)  # a reflecting wall's v sign, per component


def window_extent(n_l: int, i: int, n_ranks: int, width: int) -> tuple[int, int]:
    """[start, stop) of the global lines a rank's window covers along one
    axis (``halo.interior_window``'s extent, known without an exchange)."""
    lo = width if i > 0 else 0
    hi = width if i < n_ranks - 1 else 0
    return i * n_l - lo, (i + 1) * n_l + hi


def local_ghost_map(gm: dict, nx: int, rows, cols) -> tuple[dict, int]:
    """(this window's ghost table, the largest stencil excursion over the
    whole map). ``gm`` is ``ibm.slip_wall_ghost_map``'s host table on the
    global (ny, nx) grid; the window covers global rows [rows) and cols
    [cols). A ghost is kept when it and its four stencil cells lie in the
    window; its indices become flat indices of the window."""
    gi, gj = gm["gi"].astype(np.int64), gm["gj"].astype(np.int64)
    corners = [gm[k].astype(np.int64) for k in ("idx00", "idx01", "idx10", "idx11")]
    ci = [c // nx for c in corners]
    cj = [c % nx for c in corners]
    exc = 0
    if gi.size:
        exc = int(max(max(np.abs(a - gi).max() for a in ci), max(np.abs(b - gj).max() for b in cj)))
    (r0, r1), (c0, c1) = rows, cols

    def inside(i, j):
        return (i >= r0) & (i < r1) & (j >= c0) & (j < c1)

    keep = inside(gi, gj)
    for a, b in zip(ci, cj):
        keep &= inside(a, b)
    wx = c1 - c0
    out = {"gi": (gi[keep] - r0).astype(np.int32), "gj": (gj[keep] - c0).astype(np.int32)}
    for k, a, b in zip(("idx00", "idx01", "idx10", "idx11"), ci, cj):
        out[k] = ((a[keep] - r0) * wx + (b[keep] - c0)).astype(np.int32)
    for k in ("w00", "w01", "w10", "w11", "nx", "ny"):
        out[k] = gm[k][keep]
    return out, exc


class CompressibleExplicitStep(nn.Module):
    """``step(state_b, cfl_scale) -> (state_b, CompressibleMetrics)`` on this
    rank's block; see the module docstring and
    :func:`make_compressible_explicit_step`."""

    reads_host = False
    collectives = True

    def __init__(self, cfg: CompressibleConfig, mesh: GridMesh, kind: str, spec: dict, *,
                 device=None):
        super().__init__()
        if cfg.flux not in FLUXES:
            raise ValueError(f"unknown flux {cfg.flux!r}; one of {sorted(FLUXES)}")
        if cfg.reconstruction not in ("none", "muscl"):
            raise ValueError(f"unknown reconstruction {cfg.reconstruction!r}")
        if kind not in ("wedge", "cavity_supersonic"):
            raise ValueError(f"unknown compressible case {kind!r}")
        self.cfg, self.mesh, self.kind = cfg, mesh, kind
        self.device = step_device(mesh, device)
        self.flux_fn = FLUXES[cfg.flux]
        g = cfg.grid
        ny, nx = g.shape
        self.n_global = float(ny * nx)
        self.frame = spec.get("frame", "lab")
        self.ng = int(spec.get("ng", 1))
        gm = spec.get("ghost_map")
        exc = local_ghost_map(gm, nx, (0, ny), (0, nx))[1] if gm is not None else 0
        # MUSCL reads two cells; a ghost within two cells of the block reads
        # its stencil up to ``exc`` further
        self.width = 2 + exc
        self.final_width = exc if gm is not None else 0
        # the arrays include the grid's ghost layers (the cavity's ng = 2)
        if ny % mesh.py or nx % mesh.px:
            raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
        ny_l, nx_l = self.local_shape = (ny // mesh.py, nx // mesh.px)
        if min(self.local_shape) < max(self.width, 2 * self.ng + 1, 3):
            raise ValueError(f"blocks {self.local_shape} are narrower than the halo "
                             f"({self.width}) or the BC's ghost rows")
        dev = self.device

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        self.register_buffer("u_inf", t32(spec["u_inf"]))
        self.register_buffer("flip_v", t32(FLIP_V)[:, None])
        rows_b = slice(mesh.iy * ny_l, (mesh.iy + 1) * ny_l)
        cols_b = slice(mesh.ix * nx_l, (mesh.ix + 1) * nx_l)
        zm = spec.get("zero_momentum")
        self.register_buffer("keep", None if zm is None else 1.0 - t32(zm)[rows_b, cols_b])
        pin = spec.get("pin_mask")
        self.register_buffer("pin", None if pin is None else t32(pin)[rows_b, cols_b][None])
        self.register_buffer("pin_state", None if pin is None else t32(spec["pin_state"]))
        # the BC's tables on the two windows it writes: the stage windows
        # and the final one (the block itself without a ghost map)
        self.tables = {}
        for w in {self.width, self.final_width}:
            r = window_extent(ny_l, mesh.iy, mesh.py, w)
            c = window_extent(nx_l, mesh.ix, mesh.px, w)
            tab = {}
            if "keep_wall" in spec:
                tab["keep_wall"] = t32(np.asarray(spec["keep_wall"])[c[0]:c[1]])[None, :]
            if "plate_keep" in spec:
                tab["plate_keep"] = t32(np.asarray(spec["plate_keep"])[r[0]:r[1], c[0]:c[1]])
            if gm is not None:
                tab["ghosts"] = ghost_map_to(local_ghost_map(gm, nx, r, c)[0], dev)
            self.tables[w] = tab
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=dev))

    # the single-device update (MUSCL faces, fluxes, viscosity, floors)
    euler_update = CompressibleStep.euler_update

    def _bc(self, U, width: int):
        """The case's BC writes on a window of ``width`` (a new tensor)."""
        mesh, cfg = self.mesh, self.cfg
        lo_x, hi_x = mesh.ix == 0, mesh.ix == mesh.px - 1
        lo_y, hi_y = mesh.iy == 0, mesh.iy == mesh.py - 1
        tab = self.tables[width]
        u_inf = self.u_inf[:, None]
        U = U.clone()
        if self.kind == "cavity_supersonic":
            ng = self.ng
            if lo_x:
                U[:, :, :ng] = u_inf[..., None]
            if hi_x:
                U[:, :, -ng:] = U[:, :, -ng - 1:-ng]
            if hi_y:
                U[:, -ng:, :] = u_inf[..., None]
            if lo_y:
                for k in range(ng):
                    src = 2 * ng - 1 - k
                    U[0, k, :] = U[0, src, :]
                    U[1, k, :] = U[1, src, :]
                    U[2, k, :] = -U[2, src, :]
                    U[3, k, :] = U[3, src, :]
            if "plate_keep" in tab:
                U[1] *= tab["plate_keep"]
                U[2] *= tab["plate_keep"]
            return U
        if self.frame == "wedge_aligned":
            if lo_x:
                U[:, :, 0] = u_inf
            if hi_y:
                U[:, -1, :] = u_inf
            if hi_x:
                U[:, :, -1] = U[:, :, -2]
            if lo_y:
                row = U[:, 1, :]
                keep = tab["keep_wall"]
                U[:, 0, :] = (row * self.flip_v) * keep + row * (1.0 - keep)
            return U
        if lo_x:
            U[:, :, 0] = u_inf
        if hi_x:
            U[:, :, -1] = U[:, :, -2]
        if lo_y:
            U[:, 0, :] = U[:, 1, :] * self.flip_v
        if hi_y:
            U[:, -1, :] = U[:, -2, :]
        if "ghosts" in tab:
            U = apply_slip_wall_ghosts(U, tab["ghosts"], cfg.gamma, cfg.eps, cfg.max_val)
        return U

    def _windowed(self, U_b):
        """The BC'd stage window of a block and the block's offset in it."""
        if self.width == 0:
            return self._bc(U_b, 0), (0, 0)
        win, off = interior_window(U_b, self.mesh, self.width)
        return self._bc(win, self.width), off

    def _crop(self, win, off):
        (oy, ox), (ny_l, nx_l) = off, self.local_shape
        return win[:, oy:oy + ny_l, ox:ox + nx_l]

    def _dt(self, U_b, cfl_scale):
        """``models/compressible.py::acoustic_dt`` with its maxima over the
        whole grid (one MAX all-reduce)."""
        cfg = self.cfg
        rho, u, v, p = cons_to_prim(U_b, cfg.gamma, cfg.eps, cfg.max_val)
        a = sound_speed(rho, p, cfg.gamma, cfg.eps)
        s = pmax(torch.stack([(u.abs() + a).amax(), (v.abs() + a).amax()]), self.mesh)
        sx, sy = s.clamp(max=cfg.max_val).unbind(0)
        dt_x = cfg.grid.dx / sx.clamp(min=cfg.eps)
        dt_y = cfg.grid.dy / sy.clamp(min=cfg.eps)
        return (cfg.cfl * cfl_scale * torch.minimum(dt_x, dt_y)).to(torch.float32)

    def forward(self, state: CompressibleState, cfl_scale):
        cfg = self.cfg
        if state.U.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {state.U.device}")
        if not torch.is_tensor(cfl_scale):
            cfl_scale = torch.tensor(cfl_scale, dtype=torch.float32, device=self.device)
        win, off = self._windowed(state.U)
        U = self._crop(win, off)
        dt = self._dt(U, cfl_scale)
        if cfg.time_order == 2:
            win1, off1 = self._windowed(self._crop(self.euler_update(win, dt), off))
            U_new = 0.5 * U + 0.5 * self._crop(self.euler_update(win1, dt), off1)
        else:
            U_new = self._crop(self.euler_update(win, dt), off).clone()
        if self.keep is not None:
            U_new[1] *= self.keep
            U_new[2] *= self.keep
        if self.pin is not None:
            U_new = U_new * (1.0 - self.pin) + self.pin_state[:, None, None] * self.pin
        if self.final_width:
            fwin, foff = interior_window(U_new, self.mesh, self.final_width)
            U_new = self._crop(self._bc(fwin, self.final_width), foff).contiguous()
        else:
            U_new = self._bc(U_new, 0)
        new_state = CompressibleState(U=U_new, t=state.t + dt, step=state.step + 1)
        if not cfg.compute_metrics:
            z = self.zero
            return new_state, CompressibleMetrics(dt, z, z, z, z, z)
        rho, u, v, p = cons_to_prim(U_new, cfg.gamma, cfg.eps, cfg.max_val)
        a = sound_speed(rho, p, cfg.gamma, cfg.eps)
        vel = (u * u + v * v).sqrt()
        maxima = pmax(torch.stack([vel.amax(), -U_new[0].amin(), -p.amin(),
                                   (vel / a).amax()]), self.mesh)
        energy = psum((0.5 * rho * vel * vel).sum(), self.mesh) / self.n_global
        return new_state, CompressibleMetrics(
            dt=dt, max_vel=maxima[0], min_rho=-maxima[1], min_p=-maxima[2], energy=energy,
            max_mach=maxima[3])


def make_compressible_explicit_step(cfg: CompressibleConfig, mesh: GridMesh, kind: str,
                                    spec: dict, *, device=None) -> CompressibleExplicitStep:
    """The explicit-communication 2D compressible step of the case ``kind``
    ("wedge" or "cavity_supersonic") on this rank's (4, ny/py, nx/px)
    blocks. ``spec`` is the description ``cases.py`` leaves on the
    single-device step (``explicit_spec[1]``): ``u_inf`` (4 values), and
    for the wedge ``frame``, ``zero_momentum`` (the (ny, nx) solid),
    ``ghost_map`` (``ibm.wedge_slip_ghost_map``'s host table, or None),
    ``keep_wall`` ((nx,) for the aligned frame); for the cavity ``ng``,
    ``pin_mask``/``pin_state`` or ``plate_keep`` with ``zero_momentum``."""
    if SLOPE_LIMITERS.get(cfg.limiter) is None:
        raise ValueError(f"unknown limiter {cfg.limiter!r}")
    return CompressibleExplicitStep(cfg, mesh, kind, spec, device=device)
