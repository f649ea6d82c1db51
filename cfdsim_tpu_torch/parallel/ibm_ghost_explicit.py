"""The ghost-cell IBM on rank blocks (``cfdsim_tpu.parallel.ibm_ghost_explicit``).

A static body's ghost tables (``ibm_ghost.GhostIBM3D``, or the 2D
``GhostIBM2D`` lifted to one z plane; built on the host for the whole
grid) are cut into the tables of one rank when a step is
built: a ghost face belongs to the rank whose block of the *trimmed* face
array holds it, and its trilinear probe corners, which may lie in a
neighbour's block, are re-encoded as flat indices into this rank's block
padded by a halo of ``width`` lines (the largest excursion of any probe
corner beyond its owner's block, measured over every rank, so that every
rank exchanges the same width). Each rank keeps only its own rows, in the
global table's order: no rank pads its table to a common length, and the
ghost faces are unique, so the scatter is deterministic.

Each of the two forcing sweeps gathers from a freshly exchanged window
(the corners included), so a probe that reads a neighbour's ghost face sees
its first-sweep value, exactly as in the single-device apply. The
components of one step (u, v, w) share every exchange: one per sweep for
the stack of them.

A moving body's ghost faces are classified again on every call from this
rank's halo-padded window: the sample coordinates of the window are the
single-device step's float32 coordinates at clamped global indices (the
clamp reproduces the edge replication of the single-device classification),
the probe's cell is found in global index space (floor arithmetic on a
uniform face set, ``torch.searchsorted`` into the full float32 sample
vector on a stretched one) and re-encoded into a window of
``moving_ghost_width_2d`` lines. The centre comes from the state's ``t`` on
the device. One function serves the JAX package's three
``moving_ghost_forcing_*_local``: the uniform, stretched and 3D cases
differ only in the :class:`MovingGhostGeometry` of each component.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.ibm_ghost import (
    _bilinear,
    _floor_cell,
    _search_cell,
    _trilinear,
)
from cfdsim_tpu_torch.parallel.halo import halo_exchange
from cfdsim_tpu_torch.parallel.mesh import GridMesh


class ShardedGhostSet(NamedTuple):
    """One component's ghost tables on this rank.

    solid: (nz, ny_l, nx_l) bool, this rank's block of the trimmed solid mask;
    gz, gy, gx: (m,) int64 local (z, y, x) of the ghost faces this rank owns;
    pidx: (m, 8) int64 flat probe-corner indices into the block padded by
    ``width`` lines, (nz, ny_l + 2·width, nx_l + 2·width);
    pw: (m, 8) float32 trilinear weights; scale: (m,) float32."""

    solid: torch.Tensor
    gz: torch.Tensor
    gy: torch.Tensor
    gx: torch.Tensor
    pidx: torch.Tensor
    pw: torch.Tensor
    scale: torch.Tensor


class ShardedGhostIBM3D(NamedTuple):
    u: ShardedGhostSet
    v: ShardedGhostSet
    w: ShardedGhostSet


class ShardedGhostIBM2D(NamedTuple):
    """A 2D body's tables in the 3D layout of one z plane: ``solid`` (1,
    ny_l, nx_l), ``gz`` zeros, ``pidx`` into the (1, ny_l + 2·width, nx_l +
    2·width) window, so the 3D apply runs them on (1, ny_l, nx_l) planes."""

    u: ShardedGhostSet
    v: ShardedGhostSet


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _decode(pidx, full_dims):
    """(k, j, i) of flat indices into a (nzf, nyf, nxf) array."""
    _, nyf, nxf = full_dims
    rem = pidx % (nyf * nxf)
    return pidx // (nyf * nxf), rem // nxf, rem % nxf


def _excursion(gs, full_dims, ny_l: int, nx_l: int) -> int:
    """The largest distance, in lines, of a probe corner beyond its ghost
    face's owning block (the halo width the apply needs)."""
    gy, gx = _np(gs.gy), _np(gs.gx)
    if gy.size == 0:
        return 0
    _, j, i = _decode(_np(gs.pidx), full_dims)
    y0 = ((gy // ny_l) * ny_l)[:, None]
    x0 = ((gx // nx_l) * nx_l)[:, None]
    return max(0, *(int(d.max()) for d in (y0 - j, j - (y0 + ny_l - 1), x0 - i,
                                           i - (x0 + nx_l - 1))))


def _halo_width(sets, ny_l: int, nx_l: int) -> int:
    """The halo width every rank exchanges: the largest excursion of the
    (set, full dims) pairs' probe corners, at least 1, checked against the
    block."""
    width = max(*(_excursion(gs, dims, ny_l, nx_l) for gs, dims in sets), 1)
    if width > min(ny_l, nx_l):
        raise ValueError(f"ghost probe stencils need halo width {width} > local block "
                         f"{ny_l}x{nx_l}; use a coarser mesh or finer grid")
    return width


def _partition_set(gs, full_dims, trim, mesh: GridMesh, width: int, device) -> ShardedGhostSet:
    """This rank's tables of one component. ``full_dims`` are the dims of
    the component's full face array (the one the global ``pidx`` addresses),
    ``trim`` the trailing faces the trimmed layout drops per axis (u (0, 0,
    1), v (0, 1, 0), w (1, 0, 0), cell centres zeros)."""
    nzf, nyf, nxf = full_dims
    tz, ty, tx = trim
    nz, ny, nx = nzf - tz, nyf - ty, nxf - tx
    if ny % mesh.py or nx % mesh.px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
    ny_l, nx_l = ny // mesh.py, nx // mesh.px
    solid = _np(gs.solid)
    gz, gy, gx = _np(gs.gz), _np(gs.gy), _np(gs.gx)
    pidx, pw, scale = _np(gs.pidx), _np(gs.pw), _np(gs.scale)

    # the body must be interior: nothing on the dropped boundary faces
    if tz and (solid[-1].any() or (gz >= nz).any()):
        raise ValueError("ghost IBM body touches the dropped z boundary face")
    if ty and (solid[:, -1].any() or (gy >= ny).any()):
        raise ValueError("ghost IBM body touches the dropped y boundary face")
    if tx and (solid[:, :, -1].any() or (gx >= nx).any()):
        raise ValueError("ghost IBM body touches the dropped x boundary face")
    k, j, i = _decode(pidx, full_dims)
    live = pw != 0.0
    if (live & ((k >= nz) | (j >= ny) | (i >= nx))).any():
        raise ValueError("ghost IBM probe corner lands on a dropped boundary face; the body "
                         "must be interior to the domain")

    gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
    mine = np.nonzero((gy // ny_l == mesh.iy) & (gx // nx_l == mesh.ix))[0]
    NYW, NXW = ny_l + 2 * width, nx_l + 2 * width
    jj = j[mine] - gy0 + width
    ii = i[mine] - gx0 + width
    lv = live[mine]
    # dead corners (pw == 0) may decode anywhere: keep them in the window
    jj = np.where(lv, jj, np.clip(jj, 0, NYW - 1))
    ii = np.where(lv, ii, np.clip(ii, 0, NXW - 1))
    if (lv & ((jj < 0) | (jj >= NYW) | (ii < 0) | (ii >= NXW))).any():
        raise ValueError(f"probe corner exceeds halo width {width}; partition_ghost_ibm3d "
                         "sizes the width from every rank's corners")
    p_local = (k[mine] * NYW + jj) * NXW + ii

    def on(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return ShardedGhostSet(
        solid=on(solid[:nz, gy0:gy0 + ny_l, gx0:gx0 + nx_l], torch.bool),
        gz=on(gz[mine], torch.int64), gy=on(gy[mine] - gy0, torch.int64),
        gx=on(gx[mine] - gx0, torch.int64), pidx=on(p_local, torch.int64),
        pw=on(pw[mine], torch.float32), scale=on(scale[mine], torch.float32))


def partition_ghost_ibm3d(ibm, nx: int, ny: int, nz: int, mesh: GridMesh, extra=None,
                          *, device=None):
    """Cut a whole-grid ``GhostIBM3D`` (``ibm_ghost.sphere_ghost_ibm``) into
    this rank's tables over the trimmed (nz, ny, nx) layout.

    Returns ``(tables, width)``: this rank's :class:`ShardedGhostIBM3D` on
    ``device`` (the mesh's by default) and the halo width, the same on every
    rank. ``extra`` optionally cuts a cell-centred set
    (``sphere_ghost_cells``, the θ forcing) with the same width, returned
    third."""
    device = mesh.device if device is None else torch.device(device)
    if ny % mesh.py or nx % mesh.px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
    ny_l, nx_l = ny // mesh.py, nx // mesh.px
    dims_u, dims_v, dims_w, dims_c = ((nz, ny, nx + 1), (nz, ny + 1, nx), (nz + 1, ny, nx),
                                      (nz, ny, nx))
    width = _halo_width([(ibm.u, dims_u), (ibm.v, dims_v), (ibm.w, dims_w)]
                        + ([(extra, dims_c)] if extra is not None else []), ny_l, nx_l)
    tables = ShardedGhostIBM3D(
        u=_partition_set(ibm.u, dims_u, (0, 0, 1), mesh, width, device),
        v=_partition_set(ibm.v, dims_v, (0, 1, 0), mesh, width, device),
        w=_partition_set(ibm.w, dims_w, (1, 0, 0), mesh, width, device))
    if extra is not None:
        return tables, width, _partition_set(extra, dims_c, (0, 0, 0), mesh, width, device)
    return tables, width


def partition_ghost_ibm2d(ibm, nx: int, ny: int, mesh: GridMesh, *, device=None):
    """Cut a whole-grid ``GhostIBM2D`` (``ibm_ghost.cylinder_ghost_ibm``)
    into this rank's tables over the trimmed (ny, nx) layout: ``(tables,
    width)``, a :class:`ShardedGhostIBM2D` (each set lifted to one z plane:
    a 2D flat index j·nx' + i is the 3D one of plane 0) and the halo width,
    the same on every rank. The checks of :func:`partition_ghost_ibm3d`
    hold: no ghost or solid face and no live probe corner on a dropped
    boundary face, every probe corner within the width."""
    device = mesh.device if device is None else torch.device(device)
    if ny % mesh.py or nx % mesh.px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
    ny_l, nx_l = ny // mesh.py, nx // mesh.px
    sets = [ShardedGhostSet(solid=_np(gs.solid)[None], gz=np.zeros_like(_np(gs.gy)), gy=gs.gy,
                            gx=gs.gx, pidx=gs.pidx, pw=gs.pw, scale=gs.scale)
            for gs in (ibm.u, ibm.v)]
    dims_u, dims_v = (1, ny, nx + 1), (1, ny + 1, nx)
    width = _halo_width([(sets[0], dims_u), (sets[1], dims_v)], ny_l, nx_l)
    return ShardedGhostIBM2D(
        u=_partition_set(sets[0], dims_u, (0, 0, 1), mesh, width, device),
        v=_partition_set(sets[1], dims_v, (0, 1, 0), mesh, width, device)), width


def apply_ghost_forcing_stack(fields, sets, mesh: GridMesh, width: int, strength,
                              sweeps: int = 2):
    """:func:`apply_ghost_forcing_local` on several components of one block
    shape at once, one halo exchange per sweep for all of them: [(field_out,
    du)] in the order of ``fields``."""
    tgts = [torch.where(gs.solid, 0.0, f) for f, gs in zip(fields, sets)]
    for _ in range(sweeps):
        T = halo_exchange(torch.stack(tgts), mesh, width)
        tgts = [t.index_put((gs.gz, gs.gy, gs.gx), -gs.scale * (torch.take(T[k], gs.pidx)
                                                                 * gs.pw).sum(-1))
                for k, (t, gs) in enumerate(zip(tgts, sets))]
    outs = []
    for f, t in zip(fields, tgts):
        out = f - strength * (f - t)
        outs.append((out, f - out))
    return outs


def apply_ghost_forcing_local(field_t, gs: ShardedGhostSet, mesh: GridMesh, width: int,
                              strength, sweeps: int = 2):
    """The ghost forcing of ``ibm_ghost.apply_ghost_forcing`` on this rank's
    trimmed (nz, ny_l, nx_l) block: (field_out, du), equal to the
    single-device apply on the whole array at the owned faces."""
    return apply_ghost_forcing_stack([field_t], [gs], mesh, width, strength, sweeps)[0]


class GhostTables(nn.Module):
    """A rank's :class:`ShardedGhostSet` s as buffers of a step (``names``
    the attribute of each), so that they move with the step."""

    def __init__(self, sets: dict, *, device):
        super().__init__()
        for name, gs in sets.items():
            for field, t in zip(ShardedGhostSet._fields, gs):
                self.register_buffer(f"{name}_{field}", t.to(device))

    def set(self, name: str) -> ShardedGhostSet:
        return ShardedGhostSet(*(getattr(self, f"{name}_{f}") for f in ShardedGhostSet._fields))


# ---------------------------------------------------------------------------
# moving bodies
# ---------------------------------------------------------------------------

def moving_ghost_width_2d(delta: float, dx: float, dy: float) -> int:
    """The halo width of the moving ghost: a ghost sample sits within h·√2
    of the surface and its probe at radius + δ along the normal, so a probe
    corner is at most δ + h·√2 + h away in index space (+1 for the floor)."""
    h = min(dx, dy)
    return int(math.ceil((delta + 2.5 * max(dx, dy)) / h)) + 1


def clamped_line(samples, start: int, length: int, axis: int, ndim: int, *, device):
    """``samples`` (a whole-grid float64 vector) at the global indices start …
    start + length − 1, clamped into the grid, as a float32 line shaped to
    broadcast along ``axis`` of an ``ndim``-dimensional block."""
    s = np.asarray(samples, np.float64)
    idx = np.clip(start + np.arange(length), 0, len(s) - 1)
    shape = [1] * ndim
    shape[axis] = length
    return torch.as_tensor(s[idx].astype(np.float32).reshape(shape), device=device)


class MovingGhostGeometry(nn.Module):
    """One component's sample geometry on this rank for the moving ghost.

    ``samples``: the whole-grid sample coordinates per axis in (x, y[, z])
    order (float64; the component's own axis at faces). The window lines are
    their float32 values at the clamped global indices of this rank's block
    padded by one line (z is local: the whole axis). ``uniform`` gives each
    axis' (origin, spacing) for the floor-arithmetic cell search; otherwise
    the probe's cell is searched in the float32 sample vectors."""

    def __init__(self, samples, gy0: int, gx0: int, block, width: int, uniform=None, *,
                 device):
        super().__init__()
        ndim = len(samples)
        self.ndim = ndim
        self.block = tuple(block)  # (ny_l, nx_l) or (nz, ny_l, nx_l)
        self.gy0, self.gx0, self.width = gy0, gx0, width
        self.sizes = tuple(len(s) for s in samples)  # whole-grid sample counts (x, y[, z])
        self.uniform = uniform
        starts = (gx0 - 1, gy0 - 1, -1)[:ndim]
        lengths = (block[-1] + 2, block[-2] + 2, block[0] + 2)[:ndim]
        axes = (ndim - 1, ndim - 2, 0)[:ndim]
        for a, s, st, n, ax in zip("xyz", samples, starts, lengths, axes):
            self.register_buffer(f"line_{a}", clamped_line(s, st, n, ax, ndim, device=device))
            self.register_buffer(f"samples_{a}", torch.as_tensor(
                np.asarray(s, np.float32), device=device) if uniform is None else None)

    def classify(self, center, radius: float, delta: float):
        """(ghost, solid, gather, scale) on the owned block: ``gather(T)``
        interpolates the probe values from the window ``T`` (the block
        padded by ``width`` lines)."""
        ndim = self.ndim
        lines = [getattr(self, f"line_{a}") for a in "xyz"[:ndim]]
        rel = [X - c for X, c in zip(lines, center)]
        shape = torch.broadcast_shapes(*(r.shape for r in rel))
        rel = [r.expand(shape) for r in rel]
        d2 = rel[0] * rel[0]
        for p in rel[1:]:
            d2 = d2 + p * p
        d = torch.sqrt(d2)
        outside = ~(d <= radius)
        own = (slice(1, -1),) * ndim
        near = torch.zeros_like(outside[own])
        for ax in range(ndim):
            lo = list(own)
            hi = list(own)
            lo[ax] = slice(0, -2)
            hi[ax] = slice(2, None)
            near = near | outside[tuple(lo)] | outside[tuple(hi)]
        inside = ~outside[own]
        ghost = inside & near
        solid = inside & ~near
        d = d[own]
        inv = 1.0 / d.clamp(min=1e-12)
        probe = [c + p[own] * inv * (radius + delta) for p, c in zip(rel, center)]
        scale = ((radius - d) / delta).clamp(0.0, 1.0)
        cells = []
        for a, q, n in zip("xyz", probe, self.sizes):
            if self.uniform is None:
                cells.append(_search_cell(q, getattr(self, f"samples_{a}"), n))
            else:
                origin, spacing = self.uniform["xyz".index(a)]
                cells.append(_floor_cell(q, origin, spacing, n))
        (ix, tx), (iy, ty) = cells[0], cells[1]
        W = self.width
        NXW, NYW = self.block[-1] + 2 * W, self.block[-2] + 2 * W
        jw = (ix - self.gx0 + W).clamp(0, NXW - 2)
        iw = (iy - self.gy0 + W).clamp(0, NYW - 2)
        if ndim == 2:
            gather = _bilinear(iw * NXW + jw, tx, ty, NXW)
        else:
            iz, tz = cells[2]
            kw = iz.clamp(0, self.block[0] - 2)  # z is local: the window is the whole axis
            gather = _trilinear((kw * NYW + iw) * NXW + jw, tx, ty, tz, NXW, NYW)
        return ghost, solid, gather, scale


def moving_ghost_forcing_stack(fields, geoms, mesh: GridMesh, width: int, center,
                               radius: float, delta: float, u_bs, strength, sweeps: int = 2):
    """The moving-body ghost forcing of ``ibm_ghost.moving_ghost_forcing_*``
    on several components of one block shape, one halo exchange per sweep
    for all of them: [(field_out, du)] in the order of ``fields``; ``u_bs``
    the body's velocity component of each."""
    cls = [g.classify(center, radius, delta) for g in geoms]
    tgts = [torch.where(solid, ub, f) for f, (_, solid, _, _), ub in zip(fields, cls, u_bs)]
    for _ in range(sweeps):
        T = halo_exchange(torch.stack(tgts), mesh, width)
        tgts = [torch.where(ghost, ub - scale * (gather(T[k]) - ub), torch.where(solid, ub, f))
                for k, (f, (ghost, solid, gather, scale), ub) in enumerate(zip(fields, cls, u_bs))]
    outs = []
    for f, t in zip(fields, tgts):
        out = f - strength * (f - t)
        outs.append((out, f - out))
    return outs


class MovingBodyLocal(nn.Module):
    """A moving body's forcing on this rank's trimmed blocks of its face
    components (u, v in 2D; u, v, w in 3D): sharp masks with a linear taper
    of width ``taper``, from this rank's lines of the single-device step's
    float32 face coordinates (``scheme="penalize"``), or the moving ghost
    with probe distance ``delta`` through windows of ``width`` lines
    (``"ghost"``). ``samples`` holds each component's whole-grid float64
    sample coordinates per axis (x, y[, z]); ``uniform`` each component's
    (origin, spacing) per axis on a uniform grid, None on a stretched one."""

    def __init__(self, body, scheme: str, samples, uniform, taper: float, delta: float,
                 width, mesh: GridMesh, block, *, device):
        super().__init__()
        if scheme not in ("penalize", "ghost"):
            raise ValueError(f"unknown moving_scheme {scheme!r}")
        ny_l, nx_l = block[-2:]
        if scheme == "ghost" and width >= min(ny_l, nx_l):
            raise ValueError(f"moving-ghost halo width {width} needs local blocks > {width}; "
                             f"got {ny_l}x{nx_l}")
        self.body, self.scheme, self.mesh = body, scheme, mesh
        self.taper, self.delta, self.width = taper, delta, width
        self.ndim = len(block)
        gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
        self.geoms = nn.ModuleList()
        self.lines = nn.ModuleList()
        for k, smp in enumerate(samples):
            if scheme == "ghost":
                self.geoms.append(MovingGhostGeometry(
                    smp, gy0, gx0, block, width, None if uniform is None else uniform[k],
                    device=device))
                continue
            lines = nn.Module()  # this component's X, Y (, Z) lines
            for a, vec, start, n, axis in zip(
                    "XYZ", smp, (gx0, gy0, 0), (nx_l, ny_l, block[0]),
                    (self.ndim - 1, self.ndim - 2, 0)):
                lines.register_buffer(a, clamped_line(vec, start, n, axis, self.ndim,
                                                      device=device))
            self.lines.append(lines)

    def forward(self, fields, t, strength):
        """(the fields after the forcing at time ``t``, the momentum each
        lost)."""
        from cfdsim_tpu_torch.models.mac import moving_body_masks
        from cfdsim_tpu_torch.models.mac3d import moving_body_masks_3d

        body = self.body
        vel = body.velocity(t)
        if self.scheme == "ghost":
            outs = moving_ghost_forcing_stack(list(fields), list(self.geoms), self.mesh,
                                              self.width, body.center(t), body.radius,
                                              self.delta, list(vel), strength)
            return tuple(o for o, _ in outs), tuple(d for _, d in outs)
        coords = [tuple(getattr(ln, a) for a in "XYZ"[:self.ndim]) for ln in self.lines]
        if self.ndim == 2:
            masks = moving_body_masks(body, *coords[0], *coords[1], self.taper, t)
        else:
            masks = moving_body_masks_3d(body, tuple(coords), self.taper, t)
        d = tuple((f - b) * (strength * m) for f, b, m in zip(fields, vel, masks))
        return tuple(f - di for f, di in zip(fields, d)), d


__all__ = [
    "ShardedGhostSet",
    "ShardedGhostIBM3D",
    "ShardedGhostIBM2D",
    "GhostTables",
    "partition_ghost_ibm3d",
    "partition_ghost_ibm2d",
    "apply_ghost_forcing_local",
    "apply_ghost_forcing_stack",
    "moving_ghost_width_2d",
    "MovingGhostGeometry",
    "moving_ghost_forcing_stack",
    "MovingBodyLocal",
]
