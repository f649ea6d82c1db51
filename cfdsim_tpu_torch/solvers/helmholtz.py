"""Exact Dirichlet Helmholtz solver via discrete sine transforms
(``cfdsim_tpu.solvers.helmholtz``).

The implicit (backward-Euler) viscous step solves

    (I − c ∇²) u* = b,   c = dt·ν,

with Dirichlet velocity BCs on the one-node boundary frame. The interior
5-point operator with homogeneous Dirichlet walls is exactly diagonalized
by the 2D DST-I; inhomogeneous boundary values move to the right-hand side.
One forward/inverse transform pair replaces the damped-Jacobi iteration of
``models/incompressible.py``: machine precision instead of
O((ρ_J)^iters) error, at FFT cost.

DST-I of length m is the imaginary part of a real FFT of the odd extension
(length 2(m+1)), through ``torch.fft`` (cuFFT on the card). The step keeps
one :class:`DirichletHelmholtz`, which holds the eigen-table as a buffer;
:func:`solve_helmholtz_dirichlet` is the functional form. ``coeff`` may be
a 0-dim tensor on the device (the adaptive dt times ν): nothing here reads
it on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.solvers.poisson import _along, _dct_fwd, _dct_inv


def dst1(x, axis: int):
    """DST-I along ``axis``: S[k] = Σ_{j=1..m} x_j sin(πjk/(m+1)), k=1..m.

    Self-inverse up to the factor 2/(m+1): dst1(dst1(x)) = (m+1)/2 · x.
    """
    m = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    v = torch.cat([zero, x, zero, -torch.flip(x, (axis,))], axis)
    V = torch.fft.rfft(v, dim=axis)  # length m+2 along axis
    return -0.5 * torch.imag(V.narrow(axis, 1, m))


def idst1(X, axis: int):
    m = X.shape[axis]
    return dst1(X, axis) * (2.0 / (m + 1))


def _dirichlet_table(my: int, mx: int, dx: float, dy: float) -> np.ndarray:
    """2(ax+ay) − ax·cx − ay·cy on the (my, mx) interior: minus the
    eigenvalues of the 5-point Laplacian with homogeneous Dirichlet walls
    in the DST-I basis; built in float64, stored float32."""
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    cy = 2.0 * np.cos(np.pi * np.arange(1, my + 1) / (my + 1))
    cx = 2.0 * np.cos(np.pi * np.arange(1, mx + 1) / (mx + 1))
    return (2.0 * (ax + ay) - ax * cx[None, :] - ay * cy[:, None]).astype(np.float32)


class DirichletHelmholtz(nn.Module):
    """``forward(b, coeff)`` solves (I − coeff·∇²) u = b on the interior of
    one (ny, nx) grid whose one-node boundary frame carries the Dirichlet
    values of u (they are preserved in the returned tensor). The
    eigen-table is a buffer on ``device``; ``coeff`` = dt·ν is a number or
    a 0-dim tensor (spatially varying ν needs the iterative path)."""

    def __init__(self, shape, dx: float, dy: float, *, device):
        super().__init__()
        ny, nx = shape
        self.shape = (ny, nx)
        self.ax, self.ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
        self.register_buffer("table", torch.from_numpy(
            _dirichlet_table(ny - 2, nx - 2, dx, dy)).to(device))

    def forward(self, b, coeff):
        if tuple(b.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, got {tuple(b.shape)}")
        # move the known boundary values to the RHS of the interior system
        rhs = b[1:-1, 1:-1].clone()
        rhs[:, 0] += coeff * self.ax * b[1:-1, 0]
        rhs[:, -1] += coeff * self.ax * b[1:-1, -1]
        rhs[0, :] += coeff * self.ay * b[0, 1:-1]
        rhs[-1, :] += coeff * self.ay * b[-1, 1:-1]
        rhat = dst1(dst1(rhs, 0), 1)
        uhat = rhat / (1.0 + coeff * self.table)
        out = b.clone()
        out[1:-1, 1:-1] = idst1(idst1(uhat, 1), 0)
        return out


def solve_helmholtz_dirichlet(b, coeff, dx: float, dy: float):
    """Functional form of :class:`DirichletHelmholtz`; builds the table on
    every call."""
    return DirichletHelmholtz(tuple(b.shape), dx, dy, device=b.device)(b, coeff)


# ---------------------------------------------------------------------------
# MAC-component Helmholtz: mixed half-sample/integer bases
# ---------------------------------------------------------------------------

def _alternating(x, axis: int):
    """(−1)^j along ``axis``, shaped to broadcast against 2D ``x``."""
    j = torch.arange(x.shape[axis], device=x.device)
    return _along((1 - 2 * (j % 2)).to(x.dtype), axis)


def dst2(x, axis: int):
    """DST-II along ``axis``: S_k = Σ_j x_j sin(π(j+½)(k+1)/m), the
    eigenbasis of the 1D Laplacian with odd-half-sample (no-slip
    tangential ghost = −u) ends. Computed from the fast DCT-II by the
    sign-flip/index-reversal identity DST-II(x)_k = DCT-II((−1)^j x)_{m−1−k}."""
    return torch.flip(_dct_fwd(x * _alternating(x, axis), axis), (axis,))


def idst2(X, axis: int):
    """Inverse of ``dst2`` (DST-III up to the DCT-II normalization)."""
    return _dct_inv(torch.flip(X, (axis,)), axis) * _alternating(X, axis)


def _axis_basis(kind: str, m: int, h: float):
    """(fwd, inv, eigenvalues/h²) for one axis of a MAC-component
    Helmholtz operator. Kinds:

    - "dst1": unknowns at integer interior faces, Dirichlet walls
      (normal velocity): λ_k = 2cos(πk/(m+1))−2, k=1..m
    - "dst2": unknowns at half-sample centers, odd mirror ghost = −u
      (no-slip tangential): λ_k = 2cos(π(k+1)/m)−2, k=0..m−1
    - "dct2": unknowns at half-sample centers, even mirror ghost = +u
      (free-slip tangential): λ_k = 2cos(πk/m)−2, k=0..m−1
    """
    if kind == "dst1":
        lam = 2.0 * np.cos(np.pi * np.arange(1, m + 1) / (m + 1)) - 2.0
        return dst1, idst1, lam / (h * h)
    if kind == "dst2":
        lam = 2.0 * np.cos(np.pi * np.arange(1, m + 1) / m) - 2.0
        return dst2, idst2, lam / (h * h)
    if kind == "dct2":
        lam = 2.0 * np.cos(np.pi * np.arange(m) / m) - 2.0
        return _dct_fwd, _dct_inv, lam / (h * h)
    raise ValueError(f"unknown Helmholtz axis kind {kind!r}")


class MacHelmholtz(nn.Module):
    """``forward(b, c)`` solves (I − c·∇²) q = b on a MAC velocity
    component's (my, mx) interior unknowns, with ``kinds`` = (kind_y,
    kind_x) of :func:`_axis_basis`. ``c`` = dt·ν may be a 0-dim tensor (the
    adaptive dt): the eigen-denominator is built from the buffer ``lam`` on
    the device. The implicit-viscous engine of the staggered tier."""

    def __init__(self, shape, kinds, dx: float, dy: float, *, device):
        super().__init__()
        my, mx = shape
        self.shape = (my, mx)
        self.fy, self.iy, lam_y = _axis_basis(kinds[0], my, dy)
        self.fx, self.ix, lam_x = _axis_basis(kinds[1], mx, dx)
        lam = (lam_y[:, None] + lam_x[None, :]).astype(np.float32)
        self.register_buffer("lam", torch.from_numpy(lam).to(device))

    def forward(self, b, c):
        if tuple(b.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, got {tuple(b.shape)}")
        bh = self.fx(self.fy(b, 0), 1)
        qh = bh / (1.0 - c * self.lam)
        return self.ix(self.iy(qh, 0), 1)


def make_mac_helmholtz(shape, kinds, dx: float, dy: float, *, device):
    """The exact MAC-component solver ``solve(b, c)`` for ``shape`` and
    ``kinds`` on ``device`` (a :class:`MacHelmholtz`)."""
    return MacHelmholtz(shape, kinds, dx, dy, device=device)
