"""Core finite-difference stencil operators (``cfdsim_tpu.ops.stencil``).

Each operator is written with shifted slices on the interior and padded
back with a zero frame, so every expression is the same fp32 arithmetic,
in the same order, as the JAX package's. All operators write zeros on the
one-point boundary frame.

Convention: tensors are (ny, nx); dim 0 is y (rows), dim 1 is x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad1(interior):
    """Pad an (ny-2, nx-2) interior result back to (ny, nx) with zeros."""
    return F.pad(interior, (1, 1, 1, 1))


def shift(a, di: int, dj: int):
    """a shifted so result[i,j] = a[i+di, j+dj] on the valid interior,
    implemented as a slice (no wraparound). Shapes shrink by |di|,|dj|."""
    ny, nx = a.shape
    i0, i1 = max(di, 0), ny + min(di, 0)
    j0, j1 = max(dj, 0), nx + min(dj, 0)
    return a[i0:i1, j0:j1]


def gradient(phi, dx: float, dy: float):
    """Central-difference gradient (∂φ/∂x, ∂φ/∂y); zero on boundary frame."""
    gx = (phi[1:-1, 2:] - phi[1:-1, :-2]) * (0.5 / dx)
    gy = (phi[2:, 1:-1] - phi[:-2, 1:-1]) * (0.5 / dy)
    return _pad1(gx), _pad1(gy)


def divergence(u, v, dx: float, dy: float):
    """Central divergence ∂u/∂x + ∂v/∂y; zero on boundary frame."""
    div = (u[1:-1, 2:] - u[1:-1, :-2]) * (0.5 / dx) + (
        v[2:, 1:-1] - v[:-2, 1:-1]
    ) * (0.5 / dy)
    return _pad1(div)


def _lap_interior(phi, dx: float, dy: float):
    c = phi[1:-1, 1:-1]
    return (phi[1:-1, 2:] - 2.0 * c + phi[1:-1, :-2]) * (1.0 / (dx * dx)) + (
        phi[2:, 1:-1] - 2.0 * c + phi[:-2, 1:-1]
    ) * (1.0 / (dy * dy))


def laplacian(phi, dx: float, dy: float):
    """5-point Laplacian; zero on boundary frame."""
    return _pad1(_lap_interior(phi, dx, dy))


def laplacian_coeff(phi, dx: float, dy: float, nu_eff):
    """ν_eff-weighted 5-point Laplacian: ν_eff(i,j) * ∇²φ.

    ``nu_eff`` may be a Python float or an (ny, nx) tensor.
    """
    lap = _lap_interior(phi, dx, dy)
    nu = nu_eff[1:-1, 1:-1] if torch.is_tensor(nu_eff) and nu_eff.ndim == 2 else nu_eff
    return _pad1(nu * lap)


def curl(u, v, dx: float, dy: float):
    """z-vorticity ω = ∂v/∂x − ∂u/∂y; zero on boundary frame."""
    w = (v[1:-1, 2:] - v[1:-1, :-2]) * (0.5 / dx) - (
        u[2:, 1:-1] - u[:-2, 1:-1]
    ) * (0.5 / dy)
    return _pad1(w)


def interior_mask(shape, width: int = 1, dtype=torch.float32, *, device):
    """1 on the interior, 0 on a ``width``-point boundary frame (constant)."""
    m = torch.zeros(shape, dtype=dtype, device=device)
    m[width:-width, width:-width] = 1.0
    return m
