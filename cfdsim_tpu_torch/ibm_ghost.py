"""Ghost-cell direct-forcing IBM, the sharp-interface wall treatment
(``cfdsim_tpu.ibm_ghost``), in 2D and 3D.

The penalization masks of ``ibm.py`` enforce no-slip on a staircase
surface smeared over one taper width, so the effective radius carries an
O(h) bias. Ghost-cell direct forcing (Fadlun et al. 2000; Mittal &
Iaccarino 2005 §4) instead gives the faces just inside the body ("ghost
faces") the linear reflection of the flow sampled along the outward
normal,

    u_ghost = −(R − d)/δ · u(x_probe),   x_probe = c + r̂ (R + δ),

so that linear interpolation between the probe and the ghost face puts
u = 0 exactly on the surface r = R; faces deeper inside are zeroed.

A static body's classification, normals and bilinear (2D) or trilinear
(3D) probe stencils are built once on the host in float64 numpy
(``cylinder_ghost_ibm``; ``sphere_ghost_ibm``, and ``sphere_ghost_cells``
for a Dirichlet scalar at cell centres) and cast to device tensors: per
step the forcing is two gather/scatter passes over the ghost faces
(``apply_ghost_forcing_2d``, ``apply_ghost_forcing``; a step holds the
tables as ``GhostForcing2D``/``GhostForcing3D`` buffers). A moving body's
are rebuilt elementwise on the device every call from ``center(t)``
(``moving_ghost_forcing_2d``/``_3d`` on a uniform face set, by floor
arithmetic; ``moving_ghost_forcing_2d_nonuniform``/``_3d_nonuniform`` on a
stretched one, by an on-device ``searchsorted``), so nothing is read on
the host and a step that calls them captures into a CUDA graph. Every
gather is on a flat index clipped into the field, as the JAX package's
clip bounds make it (a CUDA tensor asserts where XLA clamps).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class GhostFaceSet2D(NamedTuple):
    """Ghost-cell forcing data for one staggered component, on a device."""

    solid: torch.Tensor  # (ny', nx') bool: faces strictly inside the body (zeroed)
    gy: torch.Tensor  # (M,) int64 rows of the ghost faces
    gx: torch.Tensor  # (M,) int64 columns
    pidx: torch.Tensor  # (M, 4) int64 flat indices of the bilinear probe corners
    pw: torch.Tensor  # (M, 4) float32 bilinear weights (rows sum to 1)
    scale: torch.Tensor  # (M,) float32 reflection factor (R − d)/δ clipped to [0, 1]


class GhostIBM2D(NamedTuple):
    u: GhostFaceSet2D
    v: GhostFaceSet2D


class GhostFaceSet(NamedTuple):
    """The 3D twin of :class:`GhostFaceSet2D`: (nz', ny', nx') fields,
    trilinear probes."""

    solid: torch.Tensor  # (nz', ny', nx') bool
    gz: torch.Tensor  # (M,) int64
    gy: torch.Tensor
    gx: torch.Tensor
    pidx: torch.Tensor  # (M, 8) int64 flat indices of the trilinear probe corners
    pw: torch.Tensor  # (M, 8) float32 trilinear weights
    scale: torch.Tensor  # (M,) float32


class GhostIBM3D(NamedTuple):
    u: GhostFaceSet
    v: GhostFaceSet
    w: GhostFaceSet


def _near_fluid(outside):
    """Points with an ``outside`` point among their axis neighbours (four
    in 2D, six in 3D), the grid's edge replicated (so a domain boundary
    spawns no ghost)."""
    near = torch.zeros_like(outside)
    for ax in range(outside.ndim):
        n = outside.shape[ax]
        lo = torch.cat([outside.narrow(ax, 0, 1), outside.narrow(ax, 0, n - 1)], ax)
        hi = torch.cat([outside.narrow(ax, 1, n - 1), outside.narrow(ax, n - 1, 1)], ax)
        near = near | lo | hi
    return near


def _ghost_set(cls, coords, center, radius: float, delta: float, *, device):
    """Classify one component's sample points and build its probe stencils
    (``cls`` is :class:`GhostFaceSet2D` or :class:`GhostFaceSet`):
    ``coords`` are the 1D sample coordinates per axis in (x, y[, z]) order,
    the component's own axis at faces, the others at centres. float64 numpy
    on the host, arrays indexed ([z,] y, x), then cast onto ``device``."""
    coords = [np.asarray(a, np.float64) for a in coords]
    grids = np.meshgrid(*coords[::-1], indexing="ij")[::-1]  # X, Y[, Z], each ([z,] y, x)
    rel = [g - float(c) for g, c in zip(grids, center)]
    d2 = rel[0] * rel[0]
    for p in rel[1:]:
        d2 = d2 + p * p
    d = np.sqrt(d2)
    inside = d <= radius
    outside = ~inside
    near_fluid = np.zeros_like(inside)
    for ax in range(inside.ndim):
        pad = [(1, 1) if a == ax else (0, 0) for a in range(inside.ndim)]
        o = np.pad(outside, pad, mode="edge")
        lo = [slice(None)] * inside.ndim
        hi = [slice(None)] * inside.ndim
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        near_fluid |= o[tuple(lo)] | o[tuple(hi)]
    ghost = inside & near_fluid
    solid = inside & ~near_fluid

    gidx = np.nonzero(ghost)  # ([z,] y, x)
    d_g = d[gidx]
    inv = 1.0 / np.maximum(d_g, 1e-12)
    # δ is global: on a stretched grid a ghost face in a coarse region can
    # lie deeper than δ, and an unclipped factor above 1 would amplify
    scale = np.clip((radius - d_g) / delta, 0.0, 1.0)

    def locate(q, s):
        i = np.clip(np.searchsorted(s, q) - 1, 0, len(s) - 2)
        t = (q - s[i]) / (s[i + 1] - s[i])
        return i, np.clip(t, 0.0, 1.0)

    # per axis, outermost first: the probe's lower corner and weight
    located = [locate(float(c) + p[gidx] * inv * (radius + delta), s)
               for p, c, s in zip(rel, center, coords)][::-1]
    sizes = [len(s) for s in coords][::-1]
    idx_cols, w_cols = [], []
    for corner in itertools.product((0, 1), repeat=len(sizes)):
        flat, weight = None, None
        for (i, t), n, up in zip(located, sizes, corner):
            flat = i + up if flat is None else flat * n + (i + up)
            w = t if up else 1.0 - t
            weight = w if weight is None else weight * w
        idx_cols.append(flat)
        w_cols.append(weight)

    def on(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return cls(on(solid, torch.bool), *(on(g, torch.int64) for g in gidx),
               pidx=on(np.stack(idx_cols, axis=-1), torch.int64),
               pw=on(np.stack(w_cols, axis=-1).astype(np.float32), torch.float32),
               scale=on(scale.astype(np.float32), torch.float32))


def _ghost_face_set_2d(xs, ys, center, radius: float, delta: float, *,
                       device) -> GhostFaceSet2D:
    """Classify one 2D component's sample points (x coordinates ``xs``, y
    coordinates ``ys``) and build the bilinear probe stencils."""
    return _ghost_set(GhostFaceSet2D, (xs, ys), center, radius, delta, device=device)


def _ghost_face_set(xs, ys, zs, center, radius: float, delta: float, *,
                    device) -> GhostFaceSet:
    """Classify one 3D component's sample points and build the trilinear
    probe stencils."""
    return _ghost_set(GhostFaceSet, (xs, ys, zs), center, radius, delta, device=device)


def _probe_dist(faces) -> float:
    """The default probe distance δ: 1.5 times the smallest spacing."""
    return 1.5 * float(min(np.diff(f).min() for f in faces))


def cylinder_ghost_ibm(x_faces, y_faces, center, radius: float,
                       probe_dist: float | None = None, *, device) -> GhostIBM2D:
    """Ghost-cell stencils for a static cylinder on the 2D MAC layout (u at
    (ny, nx+1) x-faces, v at (ny+1, nx) y-faces) of any tensor-product grid
    with face coordinates ``x_faces`` (nx+1,), ``y_faces`` (ny+1,).
    ``probe_dist`` δ defaults to 1.5 times the smallest spacing."""
    xf = np.asarray(x_faces, np.float64)
    yf = np.asarray(y_faces, np.float64)
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    if probe_dist is None:
        probe_dist = _probe_dist((xf, yf))
    return GhostIBM2D(
        u=_ghost_face_set_2d(xf, yc, center, radius, probe_dist, device=device),
        v=_ghost_face_set_2d(xc, yf, center, radius, probe_dist, device=device),
    )


def _faces_and_centres(x_faces, y_faces, z_faces, probe_dist):
    f = [np.asarray(a, np.float64) for a in (x_faces, y_faces, z_faces)]
    c = [0.5 * (a[:-1] + a[1:]) for a in f]
    return f, c, _probe_dist(f) if probe_dist is None else probe_dist


def sphere_ghost_ibm(x_faces, y_faces, z_faces, center, radius: float,
                     probe_dist: float | None = None, *, device) -> GhostIBM3D:
    """Ghost-cell stencils for a static sphere on the 3D MAC layout (u
    (nz, ny, nx+1), v (nz, ny+1, nx), w (nz+1, ny, nx)) of any
    tensor-product grid with face coordinates ``x_faces``, ``y_faces``,
    ``z_faces``. ``probe_dist`` δ defaults to 1.5 times the smallest
    spacing."""
    (xf, yf, zf), (xc, yc, zc), delta = _faces_and_centres(x_faces, y_faces, z_faces,
                                                           probe_dist)
    return GhostIBM3D(
        u=_ghost_face_set(xf, yc, zc, center, radius, delta, device=device),
        v=_ghost_face_set(xc, yf, zc, center, radius, delta, device=device),
        w=_ghost_face_set(xc, yc, zf, center, radius, delta, device=device),
    )


def sphere_ghost_cells(x_faces, y_faces, z_faces, center, radius: float,
                       probe_dist: float | None = None, *, device) -> GhostFaceSet:
    """Cell-centred ghost stencils for a Dirichlet scalar on the same sphere
    (an isothermal body in ``models/transport3d.py``). Apply them to the
    shifted field θ − θ_body: the homogeneous reflection then puts θ =
    θ_body exactly on r = R."""
    _, (xc, yc, zc), delta = _faces_and_centres(x_faces, y_faces, z_faces, probe_dist)
    return _ghost_face_set(xc, yc, zc, center, radius, delta, device=device)


def _apply_ghost(field, gs, index, strength, sweeps: int):
    tgt = torch.where(gs.solid, 0.0, field)
    for _ in range(sweeps):
        probe = (torch.take(tgt, gs.pidx) * gs.pw).sum(-1)
        tgt.index_put_(index, -gs.scale * probe)  # unique ghost faces
    out = field - strength * (field - tgt)
    return out, field - out


def apply_ghost_forcing_2d(field, gs: GhostFaceSet2D, strength, sweeps: int = 2):
    """Drive ``field`` toward the ghost-cell target (solid faces 0, ghost
    faces the reflected probe value, ``sweeps`` passes so a probe that
    touches another ghost face sees its update) by ``strength`` ∈ [0, 1].
    Returns (field_out, du) with du = field − field_out, the momentum the
    forcing removed."""
    return _apply_ghost(field, gs, (gs.gy, gs.gx), strength, sweeps)


def apply_ghost_forcing(field, gs: GhostFaceSet, strength, sweeps: int = 2):
    """:func:`apply_ghost_forcing_2d` on a 3D component (trilinear probes):
    (field_out, du), Σ du·V/dt the force on the fluid."""
    return _apply_ghost(field, gs, (gs.gz, gs.gy, gs.gx), strength, sweeps)


class _GhostForcing(nn.Module):
    """One component's ghost set as buffers of a step, so the step moves and
    captures them with its other tables."""

    def __init__(self, gs, *, device):
        super().__init__()
        for name, t in zip(gs._fields, gs):
            self.register_buffer(name, t.to(device))

    def forward(self, field, strength):
        gs = self.SET(*(getattr(self, name) for name in self.SET._fields))
        return self.APPLY(field, gs, strength)


class GhostForcing2D(_GhostForcing):
    """A :class:`GhostFaceSet2D` as buffers; ``forward`` is
    :func:`apply_ghost_forcing_2d`."""

    SET = GhostFaceSet2D
    APPLY = staticmethod(apply_ghost_forcing_2d)


class GhostForcing3D(_GhostForcing):
    """A :class:`GhostFaceSet` as buffers; ``forward`` is
    :func:`apply_ghost_forcing`."""

    SET = GhostFaceSet
    APPLY = staticmethod(apply_ghost_forcing)


def _classify(coords, center, radius: float, delta: float):
    """Device-side classification of a moving body from the sample
    coordinate grids ``coords`` (X, Y[, Z]): (ghost, solid, the probe's
    coordinates per axis, reflection factor)."""
    rel = [X - c for X, c in zip(coords, center)]
    d2 = rel[0] * rel[0]
    for p in rel[1:]:
        d2 = d2 + p * p
    d = torch.sqrt(d2)
    inside = d <= radius
    near = _near_fluid(~inside)
    ghost = inside & near
    solid = inside & ~near
    inv = 1.0 / d.clamp(min=1e-12)
    probe = [c + p * inv * (radius + delta) for p, c in zip(rel, center)]
    scale = ((radius - d) / delta).clamp(0.0, 1.0)
    return ghost, solid, probe, scale


def _moving_forcing(field, ghost, solid, gather, scale, u_b, strength, sweeps):
    """The moving-body forcing with the probe interpolation ``gather``: the
    wall condition u(r=R) = u_b, ghosts u_g = u_b − (R−d)/δ·(u(probe) −
    u_b), the solid interior pinned to u_b."""
    tgt = torch.where(solid, u_b, field)
    for _ in range(sweeps):
        probe = gather(tgt)
        u_g = u_b - scale * (probe - u_b)
        tgt = torch.where(ghost, u_g, torch.where(solid, u_b, field))
    out = field - strength * (field - tgt)
    return out, field - out


def _bilinear(base, tx, ty, nx_):
    """Bilinear interpolation from the flat lower-left corner ``base``
    (clipped so all four corners are in the field)."""

    def gather(f):
        v00 = torch.take(f, base)
        v01 = torch.take(f, base + 1)
        v10 = torch.take(f, base + nx_)
        v11 = torch.take(f, base + nx_ + 1)
        return ((1.0 - ty) * ((1.0 - tx) * v00 + tx * v01)
                + ty * ((1.0 - tx) * v10 + tx * v11))

    return gather


def _trilinear(base, tx, ty, tz, nx_, ny_):
    """Trilinear interpolation from the flat lowest corner ``base``
    (clipped so all eight corners are in the field)."""
    sy, sz = nx_, ny_ * nx_

    def plane(f, b):
        return ((1.0 - ty) * ((1.0 - tx) * torch.take(f, b) + tx * torch.take(f, b + 1))
                + ty * ((1.0 - tx) * torch.take(f, b + sy) + tx * torch.take(f, b + sy + 1)))

    def gather(f):
        return (1.0 - tz) * plane(f, base) + tz * plane(f, base + sz)

    return gather


def _floor_cell(q, origin: float, spacing: float, n: int):
    """The uniform-grid cell of probe coordinates ``q``: (index, weight),
    the position clipped to [0, n − 1.001] as the JAX package clips it."""
    g = ((q - origin) / spacing).clamp(0.0, n - 1.001)
    f = torch.floor(g)
    return f.to(torch.int64), g - f


def _search_cell(q, s, n: int):
    """The nonuniform-grid cell of ``q`` in the float32 sample coordinates
    ``s`` (n,): (index clipped to [0, n − 2], weight clipped to [0, 1])."""
    i = (torch.searchsorted(s, q, right=True) - 1).clamp(0, n - 2)
    lo = torch.take(s, i)
    return i, ((q - lo) / (torch.take(s, i + 1) - lo)).clamp(0.0, 1.0)


def moving_ghost_forcing_2d(field, X, Y, x0: float, dx: float, y0: float, dy: float, center,
                            radius: float, delta: float, u_b, strength, sweeps: int = 2):
    """Ghost-cell direct forcing for a moving body on a uniform face set,
    on the device: ``X``/``Y`` are the face coordinates of ``field``, (x0,
    y0) those of sample (0, 0) and (dx, dy) the spacings; the probe's cell
    is found by floor arithmetic. Returns (field_out, du)."""
    ghost, solid, (qx, qy), scale = _classify((X, Y), center, radius, delta)
    ny_, nx_ = field.shape
    ix, tx = _floor_cell(qx, x0, dx, nx_)
    iy, ty = _floor_cell(qy, y0, dy, ny_)
    return _moving_forcing(field, ghost, solid, _bilinear(iy * nx_ + ix, tx, ty, nx_), scale,
                           u_b, strength, sweeps)


def moving_ghost_forcing_2d_nonuniform(field, X, Y, xs, ys, center, radius: float,
                                       delta: float, u_b, strength, sweeps: int = 2):
    """:func:`moving_ghost_forcing_2d` on a nonuniform tensor-product face
    set: the probe's cell is located by ``torch.searchsorted`` into the
    float32 sample coordinates ``xs`` (nx',) and ``ys`` (ny',) on the
    device."""
    ghost, solid, (qx, qy), scale = _classify((X, Y), center, radius, delta)
    ny_, nx_ = field.shape
    ix, tx = _search_cell(qx, xs, nx_)
    iy, ty = _search_cell(qy, ys, ny_)
    return _moving_forcing(field, ghost, solid, _bilinear(iy * nx_ + ix, tx, ty, nx_), scale,
                           u_b, strength, sweeps)


def moving_ghost_forcing_3d(field, X, Y, Z, origin, spacing, center, radius: float,
                            delta: float, u_b, strength, sweeps: int = 2):
    """:func:`moving_ghost_forcing_2d` for a moving sphere on a uniform 3D
    face set: ``origin``/``spacing`` are the (x, y, z) coordinates of
    sample (0, 0, 0) and the spacings; trilinear probes."""
    ghost, solid, (qx, qy, qz), scale = _classify((X, Y, Z), center, radius, delta)
    nz_, ny_, nx_ = field.shape
    ix, tx = _floor_cell(qx, origin[0], spacing[0], nx_)
    iy, ty = _floor_cell(qy, origin[1], spacing[1], ny_)
    iz, tz = _floor_cell(qz, origin[2], spacing[2], nz_)
    base = (iz * ny_ + iy) * nx_ + ix
    return _moving_forcing(field, ghost, solid, _trilinear(base, tx, ty, tz, nx_, ny_), scale,
                           u_b, strength, sweeps)


def moving_ghost_forcing_3d_nonuniform(field, X, Y, Z, xs, ys, zs, center, radius: float,
                                       delta: float, u_b, strength, sweeps: int = 2):
    """:func:`moving_ghost_forcing_3d` on a nonuniform tensor-product face
    set (``torch.searchsorted`` into the float32 sample coordinates ``xs``,
    ``ys``, ``zs``)."""
    ghost, solid, (qx, qy, qz), scale = _classify((X, Y, Z), center, radius, delta)
    nz_, ny_, nx_ = field.shape
    ix, tx = _search_cell(qx, xs, nx_)
    iy, ty = _search_cell(qy, ys, ny_)
    iz, tz = _search_cell(qz, zs, nz_)
    base = (iz * ny_ + iy) * nx_ + ix
    return _moving_forcing(field, ghost, solid, _trilinear(base, tx, ty, tz, nx_, ny_), scale,
                           u_b, strength, sweeps)
