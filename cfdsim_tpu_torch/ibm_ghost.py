"""Ghost-cell direct-forcing IBM, the sharp-interface wall treatment, 2D
(``cfdsim_tpu.ibm_ghost``, its 2D half).

The penalization masks of ``ibm.py`` enforce no-slip on a staircase
surface smeared over one taper width, so the effective radius carries an
O(h) bias. Ghost-cell direct forcing (Fadlun et al. 2000; Mittal &
Iaccarino 2005 §4) instead gives the faces just inside the body ("ghost
faces") the linear reflection of the flow sampled along the outward
normal,

    u_ghost = −(R − d)/δ · u(x_probe),   x_probe = c + r̂ (R + δ),

so that linear interpolation between the probe and the ghost face puts
u = 0 exactly on the surface r = R; faces deeper inside are zeroed.

A static body's classification, normals and bilinear probe stencils are
built once on the host in float64 numpy (``cylinder_ghost_ibm``) and cast
to device tensors: per step the forcing is two gather/scatter passes over
the ghost faces (``apply_ghost_forcing_2d``). A moving body's are rebuilt
elementwise on the device every call from ``center(t)``
(``moving_ghost_forcing_2d`` on a uniform face set, by floor arithmetic;
``moving_ghost_forcing_2d_nonuniform`` on a stretched one, by an
on-device ``searchsorted``), so nothing is read on the host and a step
that calls them captures into a CUDA graph. Every gather is on a flat
index clipped into the field, as the JAX package's clip bounds make it.

The 3D half (``GhostFaceSet``, ``sphere_ghost_ibm``,
``apply_ghost_forcing``, ``moving_ghost_forcing_3d*``) is ROADMAP.md queue
1, item 17.
"""

from __future__ import annotations

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


def _near_fluid(outside):
    """Faces with an ``outside`` face among their four axis neighbours, the
    grid's edge replicated (so a domain boundary spawns no ghost)."""
    left = torch.cat([outside[:, :1], outside[:, :-1]], 1)
    right = torch.cat([outside[:, 1:], outside[:, -1:]], 1)
    down = torch.cat([outside[:1], outside[:-1]], 0)
    up = torch.cat([outside[1:], outside[-1:]], 0)
    return left | right | down | up


def _ghost_face_set_2d(xs, ys, center, radius: float, delta: float, *,
                       device) -> GhostFaceSet2D:
    """Classify one component's sample points (x coordinates ``xs``, y
    coordinates ``ys``; its own axis at faces, the other at centres) and
    build the bilinear probe stencils: float64 numpy on the host, arrays
    (ny, nx) with x on the last axis, then cast onto ``device``."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    cx, cy = float(center[0]), float(center[1])
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    px, py = X - cx, Y - cy
    d = np.sqrt(px * px + py * py)
    inside = d <= radius
    outside = ~inside
    near_fluid = np.zeros_like(inside)
    for ax in range(2):
        pad = [(1, 1) if a == ax else (0, 0) for a in range(2)]
        o = np.pad(outside, pad, mode="edge")
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        near_fluid |= o[tuple(lo)] | o[tuple(hi)]
    ghost = inside & near_fluid
    solid = inside & ~near_fluid

    gy, gx = np.nonzero(ghost)
    d_g = d[gy, gx]
    inv = 1.0 / np.maximum(d_g, 1e-12)
    qx = cx + px[gy, gx] * inv * (radius + delta)
    qy = cy + py[gy, gx] * inv * (radius + delta)
    # δ is global: on a stretched grid a ghost face in a coarse region can
    # lie deeper than δ, and an unclipped factor above 1 would amplify
    scale = np.clip((radius - d_g) / delta, 0.0, 1.0)

    def locate(q, s):
        i = np.clip(np.searchsorted(s, q) - 1, 0, len(s) - 2)
        t = (q - s[i]) / (s[i + 1] - s[i])
        return i, np.clip(t, 0.0, 1.0)

    ix, tx = locate(qx, xs)
    iy, ty = locate(qy, ys)
    nx_ = len(xs)
    idx_cols, w_cols = [], []
    for b in (0, 1):
        wy = ty if b else 1.0 - ty
        for c in (0, 1):
            wx = tx if c else 1.0 - tx
            idx_cols.append((iy + b) * nx_ + (ix + c))
            w_cols.append(wy * wx)

    def on(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return GhostFaceSet2D(
        solid=on(solid, torch.bool),
        gy=on(gy, torch.int64),
        gx=on(gx, torch.int64),
        pidx=on(np.stack(idx_cols, axis=-1), torch.int64),
        pw=on(np.stack(w_cols, axis=-1).astype(np.float32), torch.float32),
        scale=on(scale.astype(np.float32), torch.float32),
    )


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
        probe_dist = 1.5 * float(min(np.diff(xf).min(), np.diff(yf).min()))
    return GhostIBM2D(
        u=_ghost_face_set_2d(xf, yc, center, radius, probe_dist, device=device),
        v=_ghost_face_set_2d(xc, yf, center, radius, probe_dist, device=device),
    )


def apply_ghost_forcing_2d(field, gs: GhostFaceSet2D, strength, sweeps: int = 2):
    """Drive ``field`` toward the ghost-cell target (solid faces 0, ghost
    faces the reflected probe value, ``sweeps`` passes so a probe that
    touches another ghost face sees its update) by ``strength`` ∈ [0, 1].
    Returns (field_out, du) with du = field − field_out, the momentum the
    forcing removed."""
    tgt = torch.where(gs.solid, 0.0, field)
    for _ in range(sweeps):
        probe = (torch.take(tgt, gs.pidx) * gs.pw).sum(-1)
        tgt.index_put_((gs.gy, gs.gx), -gs.scale * probe)  # unique ghost faces
    out = field - strength * (field - tgt)
    return out, field - out


class GhostForcing2D(nn.Module):
    """One component's :class:`GhostFaceSet2D` as buffers of a step, so the
    step moves and captures them with its other tables."""

    def __init__(self, gs: GhostFaceSet2D, *, device):
        super().__init__()
        for name, t in zip(gs._fields, gs):
            self.register_buffer(name, t.to(device))

    def forward(self, field, strength):
        gs = GhostFaceSet2D(*(getattr(self, name) for name in GhostFaceSet2D._fields))
        return apply_ghost_forcing_2d(field, gs, strength)


def _classify(X, Y, center, radius: float, delta: float):
    """Device-side classification of a moving body: (ghost, solid, probe x,
    probe y, reflection factor)."""
    cx, cy = center
    px, py = X - cx, Y - cy
    d = torch.sqrt(px * px + py * py)
    inside = d <= radius
    near = _near_fluid(~inside)
    ghost = inside & near
    solid = inside & ~near
    inv = 1.0 / d.clamp(min=1e-12)
    qx = cx + px * inv * (radius + delta)
    qy = cy + py * inv * (radius + delta)
    scale = ((radius - d) / delta).clamp(0.0, 1.0)
    return ghost, solid, qx, qy, scale


def _moving_forcing(field, ghost, solid, base, tx, ty, scale, u_b, strength, sweeps):
    """The moving-body forcing from the bilinear corner ``base`` (a flat
    index of the lower-left corner, clipped so all four are in the field)
    and the weights ``tx``, ``ty``: the wall condition u(r=R) = u_b, ghosts
    u_g = u_b − (R−d)/δ·(u(probe) − u_b), the solid interior pinned to u_b."""
    nx_ = field.shape[1]

    def gather(f):
        v00 = torch.take(f, base)
        v01 = torch.take(f, base + 1)
        v10 = torch.take(f, base + nx_)
        v11 = torch.take(f, base + nx_ + 1)
        return ((1.0 - ty) * ((1.0 - tx) * v00 + tx * v01)
                + ty * ((1.0 - tx) * v10 + tx * v11))

    tgt = torch.where(solid, u_b, field)
    for _ in range(sweeps):
        probe = gather(tgt)
        u_g = u_b - scale * (probe - u_b)
        tgt = torch.where(ghost, u_g, torch.where(solid, u_b, field))
    out = field - strength * (field - tgt)
    return out, field - out


def moving_ghost_forcing_2d(field, X, Y, x0: float, dx: float, y0: float, dy: float, center,
                            radius: float, delta: float, u_b, strength, sweeps: int = 2):
    """Ghost-cell direct forcing for a moving body on a uniform face set,
    on the device: ``X``/``Y`` are the face coordinates of ``field``, (x0,
    y0) those of sample (0, 0) and (dx, dy) the spacings; the probe's cell
    is found by floor arithmetic. Returns (field_out, du)."""
    ghost, solid, qx, qy, scale = _classify(X, Y, center, radius, delta)
    ny_, nx_ = field.shape
    gx = ((qx - x0) / dx).clamp(0.0, nx_ - 1.001)
    gy = ((qy - y0) / dy).clamp(0.0, ny_ - 1.001)
    fx = torch.floor(gx)
    fy = torch.floor(gy)
    base = fy.to(torch.int64) * nx_ + fx.to(torch.int64)
    return _moving_forcing(field, ghost, solid, base, gx - fx, gy - fy, scale, u_b, strength,
                           sweeps)


def moving_ghost_forcing_2d_nonuniform(field, X, Y, xs, ys, center, radius: float,
                                       delta: float, u_b, strength, sweeps: int = 2):
    """:func:`moving_ghost_forcing_2d` on a nonuniform tensor-product face
    set: the probe's cell is located by ``torch.searchsorted`` into the
    float32 sample coordinates ``xs`` (nx',) and ``ys`` (ny',) on the
    device."""
    ghost, solid, qx, qy, scale = _classify(X, Y, center, radius, delta)
    ny_, nx_ = field.shape
    ix = (torch.searchsorted(xs, qx, right=True) - 1).clamp(0, nx_ - 2)
    iy = (torch.searchsorted(ys, qy, right=True) - 1).clamp(0, ny_ - 2)
    x_lo = torch.take(xs, ix)
    y_lo = torch.take(ys, iy)
    tx = ((qx - x_lo) / (torch.take(xs, ix + 1) - x_lo)).clamp(0.0, 1.0)
    ty = ((qy - y_lo) / (torch.take(ys, iy + 1) - y_lo)).clamp(0.0, 1.0)
    return _moving_forcing(field, ghost, solid, iy * nx_ + ix, tx, ty, scale, u_b, strength,
                           sweeps)
