"""Immersed-boundary geometry and forcing (``cfdsim_tpu.ibm``): the
collocated cylinder's ``cylinder_masks``, ``apply_ibm``, ``ibm_ramp`` and
``potential_flow_cylinder``; the staggered tiers' face-sampled
``cylinder_masks_mac`` and ``potential_flow_cylinder_mac``; the moving
bodies (``MovingBody``, ``oscillating_cylinder``, ``translating_body``);
and in 3D the sphere's face-sampled and cell-centred masks
(``sphere_masks_faces``, ``sphere_mask_cells``, ``sphere_masks_mac3d``),
its potential-flow start (``potential_flow_sphere_faces``,
``potential_flow_sphere_mac3d``) and the moving sphere (``MovingBody3D``,
``oscillating_sphere``); and the compressible tier's wedge
(``wedge_mask``, its slip-wall ghost map ``wedge_slip_ghost_map`` on
``slip_wall_ghost_map``, applied by ``apply_slip_wall_ghosts``) and open
cavity (``cavity_mask``).

The mask and initial-field builders are numpy, run once at set-up, and
give the JAX package's arrays bit for bit; the step moves them to its
device. ``apply_ibm`` and ``ibm_ramp`` are per-step torch ops, and a moving
body's ``center(t)``/``velocity(t)`` are torch functions of the device-side
time, so its masks are rebuilt on the device without a host read.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.solvers.riemann import cons_to_prim, prim_to_cons


def cylinder_masks(grid: Grid, center: tuple[float, float], radius: float):
    """(solid_mask bool, ibm_mask float32) numpy arrays for an embedded
    cylinder. The IBM mask is 1 inside the body and decays as a Gaussian
    shell exp(−((r−R)/2dx)²) out to R+5dx."""
    X, Y = grid.meshgrid()
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    solid = dist <= radius
    sigma = 2.0 * grid.dx
    shell = np.exp(-(((dist - radius) / sigma) ** 2))
    ibm = np.where(dist < radius, 1.0, np.where(dist < radius + 5 * grid.dx, shell, 0.0))
    return solid, ibm.astype(np.float32)


def apply_ibm(u, v, ibm_mask, strength):
    """Penalize velocity inside/near the body: q *= (1 − mask·strength)."""
    damp = 1.0 - ibm_mask * strength
    return u * damp, v * damp


def ibm_ramp(step, ramp_steps: int):
    """Force-strength ramp min(1, step/ramp_steps) as a 0-dim float32 tensor
    on ``step``'s device; 1 if no ramp."""
    if ramp_steps <= 0:
        return torch.ones((), dtype=torch.float32, device=step.device)
    return (step.to(torch.float32) / ramp_steps).clamp(max=1.0)


def potential_flow_cylinder(grid: Grid, center: tuple[float, float], radius: float,
                            v_inf: float, ibm_mask):
    """Initial (u, v), float32 numpy: ideal potential flow around a
    cylinder, blended to rest inside the IBM shell."""
    X, Y = grid.meshgrid()
    dx = grid.dx
    r = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    theta = np.arctan2(Y - center[1], X - center[0])
    mask = np.asarray(ibm_mask)
    factor = (radius / np.maximum(r, 1e-10)) ** 2
    u_far = v_inf * (1.0 - factor * np.cos(2.0 * theta)) * (1.0 - mask)
    v_far = -v_inf * factor * np.sin(2.0 * theta) * (1.0 - mask)
    blend = np.minimum(1.0, ((r - radius) / (4.0 * dx)) ** 2)
    u_near = v_inf * blend * (1.0 - mask)
    far = r > radius + 4.0 * dx
    u0 = np.where(far, u_far, u_near)
    v0 = np.where(far, v_far, 0.0)
    return u0.astype(np.float32), v0.astype(np.float32)


def _gaussian_shell(dist, radius, dx):
    sigma = 2.0 * dx
    shell = np.exp(-(((dist - radius) / sigma) ** 2))
    return np.where(dist < radius, 1.0, np.where(dist < radius + 5 * dx, shell, 0.0))


def _mac_face_coords(grid: Grid):
    """(Xu, Yu), (Xv, Yv): the u-face (ny, nx+1) and v-face (ny+1, nx)
    coordinates of a cell-centred grid, float64."""
    nx, ny, dx, dy = grid.nx, grid.ny, grid.dx, grid.dy
    xu = grid.x_min + np.arange(nx + 1) * dx
    yu = grid.y_min + (np.arange(ny) + 0.5) * dy
    xv = grid.x_min + (np.arange(nx) + 0.5) * dx
    yv = grid.y_min + np.arange(ny + 1) * dy
    return (np.meshgrid(xu, yu, indexing="xy"), np.meshgrid(xv, yv, indexing="xy"))


def cylinder_masks_mac(grid: Grid, center: tuple[float, float], radius: float,
                       profile: str = "shell"):
    """Face-sampled IBM masks (float32 numpy) for the staggered layout, at
    the u-faces (ny, nx+1) and v-faces (ny+1, nx) of a cell-centred grid.
    ``"shell"``: the Gaussian shell of :func:`cylinder_masks`; ``"sharp"``:
    1 inside with a half-cell taper (quantitative forces)."""
    dx = grid.dx
    (Xu, Yu), (Xv, Yv) = _mac_face_coords(grid)
    du = np.sqrt((Xu - center[0]) ** 2 + (Yu - center[1]) ** 2)
    dv = np.sqrt((Xv - center[0]) ** 2 + (Yv - center[1]) ** 2)
    if profile == "sharp":
        def shape(d):
            return np.clip((radius + 0.5 * dx - d) / dx, 0.0, 1.0)
    elif profile == "shell":
        def shape(d):
            return _gaussian_shell(d, radius, dx)
    else:
        raise ValueError(f"unknown IBM mask profile {profile!r}")
    return shape(du).astype(np.float32), shape(dv).astype(np.float32)


def potential_flow_cylinder_mac(grid: Grid, center: tuple[float, float], radius: float,
                                v_inf: float, mask_u, mask_v):
    """Potential-flow initial (u, v) on the MAC faces, float32 numpy, at rest
    inside the masks."""
    dx = grid.dx

    def fields(X, Y):
        r = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
        th = np.arctan2(Y - center[1], X - center[0])
        fac = (radius / np.maximum(r, 1e-10)) ** 2
        u = v_inf * (1.0 - fac * np.cos(2.0 * th))
        v = -v_inf * fac * np.sin(2.0 * th)
        blend = np.minimum(1.0, ((r - radius) / (4.0 * dx)) ** 2)
        near = r <= radius + 4.0 * dx
        return np.where(near, v_inf * blend, u), np.where(near, 0.0, v)

    (Xu, Yu), (Xv, Yv) = _mac_face_coords(grid)
    u0 = fields(Xu, Yu)[0] * (1.0 - np.asarray(mask_u))
    v0 = fields(Xv, Yv)[1] * (1.0 - np.asarray(mask_v))
    return u0.astype(np.float32), v0.astype(np.float32)


class MovingBody(NamedTuple):
    """A rigid circular body in motion, for the moving-geometry IBM of the
    MAC tiers: ``center(t) -> (cx, cy)`` and ``velocity(t) -> (ub, vb)``
    are torch functions of the simulated time ``t`` (a 0-dim device
    tensor); the step rebuilds the sharp face masks from them every stage
    and drives the fluid toward the body's velocity."""

    center: Callable
    velocity: Callable
    radius: float


def oscillating_cylinder(center, radius: float, amplitude: float, period: float,
                         axis: int = 0) -> MovingBody:
    """In-line (axis=0) or transverse (axis=1) harmonic oscillation
    x_c(t) = x0 + A·sin(2πt/T) (KC = 2πA/D)."""
    x0, y0 = center
    om = 2.0 * math.pi / period

    def c(t):
        d = amplitude * torch.sin(om * t)
        return (x0 + d, y0) if axis == 0 else (x0, y0 + d)

    def vel(t):
        s = amplitude * om * torch.cos(om * t)
        return (s, torch.zeros_like(s)) if axis == 0 else (torch.zeros_like(s), s)

    return MovingBody(center=c, velocity=vel, radius=radius)


def translating_body(center0, velocity, radius: float) -> MovingBody:
    """A rigid body at constant velocity (the Galilean-invariance harness)."""
    x0, y0 = center0
    ub, vb = velocity

    def c(t):
        return (x0 + ub * t, y0 + vb * t)

    def vel(t):
        z = torch.zeros_like(t)
        return (z + ub, z + vb)

    return MovingBody(center=c, velocity=vel, radius=radius)


def _cell_centres(*faces):
    """float64 face vectors and their cell centres, per axis."""
    f = [np.asarray(a, np.float64) for a in faces]
    return f, [0.5 * (a[:-1] + a[1:]) for a in f]


def _min_spacing(faces) -> float:
    return float(min(np.diff(a).min() for a in faces))


def _mask_profile(profile: str, radius: float, width: float):
    if profile == "sharp":
        return lambda d: np.clip((radius + 0.5 * width - d) / width, 0.0, 1.0)
    if profile == "shell":
        return lambda d: _gaussian_shell(d, radius, width)
    raise ValueError(f"unknown IBM mask profile {profile!r}")


def sphere_masks_faces(x_faces, y_faces, z_faces, center, radius: float,
                       profile: str = "sharp", width: float | None = None):
    """Face-sampled IBM masks (float32 numpy) for the 3D staggered layout of
    any tensor-product grid with face coordinates ``x_faces`` (nx+1,),
    ``y_faces``, ``z_faces``: u faces (nz, ny, nx+1), v (nz, ny+1, nx), w
    (nz+1, ny, nx). ``"sharp"``: 1 inside r < R with a linear taper of
    ``width`` (default the smallest spacing), for quantitative forces;
    ``"shell"``: the Gaussian shell of :func:`cylinder_masks`."""
    (xf, yf, zf), (xc, yc, zc) = _cell_centres(x_faces, y_faces, z_faces)
    if width is None:
        width = _min_spacing((xf, yf, zf))
    cx, cy, cz = center
    shape = _mask_profile(profile, radius, width)

    def dist(xs, ys, zs):
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        return np.sqrt((X - cx) ** 2 + (Y - cy) ** 2 + (Z - cz) ** 2)

    return tuple(shape(dist(*s)).astype(np.float32)
                 for s in ((xf, yc, zc), (xc, yf, zc), (xc, yc, zf)))


def sphere_mask_cells(x_faces, y_faces, z_faces, center, radius: float,
                      profile: str = "sharp", width: float | None = None):
    """The cell-centred sphere mask (nz, ny, nx), float32 numpy: the θ
    penalization mask of an isothermal body; the profiles of
    :func:`sphere_masks_faces`."""
    (xf, yf, zf), (xc, yc, zc) = _cell_centres(x_faces, y_faces, z_faces)
    if width is None:
        width = _min_spacing((xf, yf, zf))
    Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
    d = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2 + (Z - center[2]) ** 2)
    return _mask_profile(profile, radius, width)(d).astype(np.float32)


def _uniform_faces(grid):
    """The face coordinates of a uniform cell-centred ``Grid3D``."""
    return (grid.x_min + np.arange(grid.nx + 1) * grid.dx,
            grid.y_min + np.arange(grid.ny + 1) * grid.dy,
            grid.z_min + np.arange(grid.nz + 1) * grid.dz)


def sphere_masks_mac3d(grid, center, radius: float, profile: str = "sharp"):
    """:func:`sphere_masks_faces` on a uniform cell-centred ``Grid3D``."""
    return sphere_masks_faces(*_uniform_faces(grid), center, radius, profile=profile,
                              width=grid.dx)


def potential_flow_sphere_faces(x_faces, y_faces, z_faces, center, radius: float,
                                v_inf: float, mask_u, mask_v, mask_w,
                                width: float | None = None):
    """Potential flow around a sphere on the 3D MAC faces of any
    tensor-product grid, float32 numpy: φ = V·x·(1 + R³/2r³), blended to
    rest within 4·``width`` of the surface and zeroed inside the masks."""
    (xf, yf, zf), (xc, yc, zc) = _cell_centres(x_faces, y_faces, z_faces)
    if width is None:
        width = _min_spacing((xf, yf, zf))
    cx, cy, cz = center

    def fields(xs, ys, zs):
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        X, Y, Z = X - cx, Y - cy, Z - cz
        r = np.maximum(np.sqrt(X**2 + Y**2 + Z**2), 1e-10)
        fac = radius**3 / (2.0 * r**3)
        u = v_inf * (1.0 + fac - 3.0 * fac * X * X / r**2)
        v = -3.0 * v_inf * fac * X * Y / r**2
        w = -3.0 * v_inf * fac * X * Z / r**2
        blend = np.minimum(1.0, ((r - radius) / (4.0 * width)) ** 2)
        near = r <= radius + 4.0 * width
        return (np.where(near, v_inf * blend, u), np.where(near, 0.0, v),
                np.where(near, 0.0, w))

    u0 = fields(xf, yc, zc)[0] * (1.0 - np.asarray(mask_u))
    v0 = fields(xc, yf, zc)[1] * (1.0 - np.asarray(mask_v))
    w0 = fields(xc, yc, zf)[2] * (1.0 - np.asarray(mask_w))
    return u0.astype(np.float32), v0.astype(np.float32), w0.astype(np.float32)


def potential_flow_sphere_mac3d(grid, center, radius: float, v_inf: float, mask_u, mask_v,
                                mask_w):
    """:func:`potential_flow_sphere_faces` on a uniform cell-centred
    ``Grid3D``."""
    return potential_flow_sphere_faces(*_uniform_faces(grid), center, radius, v_inf, mask_u,
                                       mask_v, mask_w, width=grid.dx)


class MovingBody3D(NamedTuple):
    """A rigid sphere in motion for the 3D MAC tiers: ``center(t) -> (cx,
    cy, cz)`` and ``velocity(t) -> (ub, vb, wb)`` are torch functions of the
    simulated time ``t`` (a 0-dim device tensor)."""

    center: Callable
    velocity: Callable
    radius: float


def oscillating_sphere(center, radius: float, amplitude: float, period: float,
                       axis: int = 0) -> MovingBody3D:
    """Harmonic oscillation along one axis (0, 1, 2 for x, y, z):
    x_c(t) = x0 + A·sin(2πt/T)."""
    c0 = tuple(float(c) for c in center)
    om = 2.0 * math.pi / period

    def c(t):
        out = list(c0)
        out[axis] = c0[axis] + amplitude * torch.sin(om * t)
        return tuple(out)

    def vel(t):
        s = amplitude * om * torch.cos(om * t)
        z = torch.zeros_like(s)
        out = [z, z, z]
        out[axis] = s
        return tuple(out)

    return MovingBody3D(center=c, velocity=vel, radius=radius)


# ---------------------------------------------------------------------------
# the compressible tier's geometry: the wedge, its slip-wall ghost map and
# the open cavity
# ---------------------------------------------------------------------------

def wedge_mask(grid: Grid, wedge_angle: float, wedge_start_x: float) -> np.ndarray:
    """Boolean (ny, nx) mask of a wedge rising at ``wedge_angle`` from
    ``wedge_start_x`` along the bottom wall (reference v1_shock.py:240-248)."""
    X, Y = grid.meshgrid()
    wedge_y = np.tan(wedge_angle) * (X - wedge_start_x)
    return (X >= wedge_start_x) & (Y <= wedge_y)


def slip_wall_ghost_map(grid: Grid, depth, normal_x, normal_y, solid_mask=None,
                        band: float = 2.5) -> dict:
    """A mirror-ghost interpolation map for a slip wall (ghost-cell
    immersed boundary, Forrer & Jeltsch style), host numpy, built once.

    ``depth`` is the penetration depth into the solid (> 0 inside),
    ``normal_x/y`` the unit surface normal pointing into the fluid, all
    (ny, nx) numpy arrays. Ghost cells are solid cells within ``band``·h of
    the surface; each gets the state at its mirror point, sampled
    bilinearly from the fluid (stencil corners inside the solid get no
    weight), with the normal velocity reflected
    (:func:`apply_slip_wall_ghosts`). Flat indices are int32, weights and
    normals float32, as the JAX package builds them; :func:`ghost_map_to`
    puts the map on a device."""
    X, Y = grid.meshgrid()
    ny, nx = X.shape
    h = min(grid.dx, grid.dy)
    inside = depth > 0.0 if solid_mask is None else np.asarray(solid_mask)
    ghost = inside & (depth <= band * h)
    gi, gj = np.nonzero(ghost)
    d = depth[gi, gj]
    nxg = normal_x[gi, gj]
    nyg = normal_y[gi, gj]
    # image point at least 0.75h into the fluid, so the bilinear stencil is
    # dominated by true fluid cells
    d_img = np.maximum(d, 0.75 * h)
    xm = X[gi, gj] + (d + d_img) * nxg
    ym = Y[gi, gj] + (d + d_img) * nyg

    xc = grid.x_coords()
    yc = grid.y_coords()
    j0 = np.clip(np.searchsorted(xc, xm) - 1, 0, nx - 2)
    i0 = np.clip(np.searchsorted(yc, ym) - 1, 0, ny - 2)
    wx = np.clip((xm - xc[j0]) / (xc[j0 + 1] - xc[j0]), 0.0, 1.0)
    wy = np.clip((ym - yc[i0]) / (yc[i0 + 1] - yc[i0]), 0.0, 1.0)

    # zero the weights of corners inside the solid and renormalise; where
    # all four are solid keep plain bilinear
    bilinear = np.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx])
    corners = np.stack([inside[i0, j0], inside[i0, j0 + 1],
                        inside[i0 + 1, j0], inside[i0 + 1, j0 + 1]])
    w = np.where(corners, 0.0, bilinear)
    degenerate = w.sum(axis=0) <= 1e-12
    if np.any(degenerate):
        w[:, degenerate] = bilinear[:, degenerate]
    w = w / w.sum(axis=0)

    def flat(i, j):
        return (i * nx + j).astype(np.int32)

    return {
        "gi": gi.astype(np.int32), "gj": gj.astype(np.int32),
        "idx00": flat(i0, j0), "idx01": flat(i0, j0 + 1),
        "idx10": flat(i0 + 1, j0), "idx11": flat(i0 + 1, j0 + 1),
        "w00": w[0].astype(np.float32), "w01": w[1].astype(np.float32),
        "w10": w[2].astype(np.float32), "w11": w[3].astype(np.float32),
        "nx": nxg.astype(np.float32), "ny": nyg.astype(np.float32),
    }


def ghost_map_to(gm: dict, device) -> dict:
    """A ghost map's arrays as tensors on ``device`` (indices as int64)."""
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind == "i" else torch.float32,
                               device=device) for k, v in gm.items()}


def apply_slip_wall_ghosts(U, gm: dict, gamma: float, eps: float = 1e-8,
                           max_val: float = 1e3):
    """A copy of the conserved state U (4, ny, nx) with mirror-ghost states in
    the near-surface solid cells: (ρ, u, v, p) sampled at each ghost's mirror
    point (four ``take``s on the flattened field), the velocity reflected
    across the wall (v → v − 2(v·n̂)n̂, slip), ρ and p copied, written with
    one ``index_put_``. ``gm`` is :func:`ghost_map_to`'s."""
    rho, u, v, p = cons_to_prim(U, gamma, eps, max_val)

    def samp(q):
        qf = q.reshape(-1)
        return (gm["w00"] * qf.take(gm["idx00"]) + gm["w01"] * qf.take(gm["idx01"])
                + gm["w10"] * qf.take(gm["idx10"]) + gm["w11"] * qf.take(gm["idx11"]))

    rm, um, vm, pm = samp(rho), samp(u), samp(v), samp(p)
    vn = um * gm["nx"] + vm * gm["ny"]
    ur = um - 2.0 * vn * gm["nx"]
    vr = vm - 2.0 * vn * gm["ny"]
    Ug = prim_to_cons(rm, ur, vr, pm, gamma)
    out = U.clone()
    out[:, gm["gi"], gm["gj"]] = Ug
    return out


def wedge_slip_ghost_map(grid: Grid, wedge_angle: float, wedge_start_x: float,
                         band: float = 2.5) -> dict:
    """Slip-wall ghost map for the planar wedge surface y = (x − x0)·tanθ,
    x ≥ x0 (the geometry of v1_shock.py:240-248)."""
    X, Y = grid.meshgrid()
    s, c = np.sin(wedge_angle), np.cos(wedge_angle)
    depth = (X - wedge_start_x) * s - Y * c  # > 0 inside the wedge
    solid = wedge_mask(grid, wedge_angle, wedge_start_x)
    return slip_wall_ghost_map(grid, depth, np.full_like(X, -s), np.full_like(X, c),
                               solid_mask=solid, band=band)


def cavity_mask(grid: Grid, x_start: float, length: float, depth: float) -> np.ndarray:
    """Smoothed float32 mask of the open-cavity geometry: 1 inside the
    cavity below the shear layer, a Gaussian-smoothed edge above it (σ =
    3dx), parity with reference cavity_flow_v1.py:264-273. In the
    supersonic cavity it marks cells pinned to quiescent fluid each step."""
    X, Y = grid.meshgrid()
    inside = (X >= x_start) & (X <= x_start + length) & (Y <= depth)
    mask = inside.astype(np.float64)
    sigma = 3.0 * grid.dx
    above = (~inside) & (X >= x_start) & (X <= x_start + length) & (Y > depth)
    dist_y = Y - depth
    shell = np.exp(-((dist_y / sigma) ** 2))
    mask = np.where(above & (dist_y < 3.0 * sigma), shell, mask)
    return mask.astype(np.float32)
