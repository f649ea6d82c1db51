"""Fast diagonalization (FDM): the exact direct Neumann Poisson solve on
stretched (nonuniform tensor-product) grids by dense eigenbasis matmuls
(``cfdsim_tpu.solvers.fdm``).

A stretched grid's separable cell-centred operator L = Ly ⊕ Lx is not
DCT-diagonal, but each 1D operator is similar to a symmetric tridiagonal
matrix, so

    L p = Ly @ p + p @ Lxᵀ = r    ⇒    p = Vy [ (Vy⁻¹ r Vx⁻ᵀ) ⊘ Λ ] Vxᵀ,

with Λ_jk = λy_j + λx_k. The eigendecompositions run once in float64 numpy
at set-up; the four float32 matrices and 1/Λ are buffers on the device. The
four products are ``torch.matmul`` and run in full float32 whatever the
caller set: a TF32 (or bf16) pass turns this exact solve into one with a
residual of tens of percent, so :func:`full_fp32_matmul` switches TF32 off
around them and restores the caller's setting afterwards. The 3D solve
(:class:`FDMSolver3D`) is the same construction with a third axis: six
products and one spectral division.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from scipy.linalg import eigh_tridiagonal
from torch import nn


@contextlib.contextmanager
def full_fp32_matmul():
    """CUDA float32 matmuls in full precision (no TF32) inside the block,
    whatever the caller set through ``torch.set_float32_matmul_precision``,
    ``allow_tf32`` or ``fp32_precision``; the CUDA matmul setting comes back
    as it was. Host state only, read when a kernel is chosen: safe inside a
    CUDA graph capture, where it fixes the captured kernels."""
    matmul = torch.backends.cuda.matmul
    # the backend-level setting overrides the legacy global one and is the
    # one that reads back in every state the two APIs can leave
    prev = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = prev


def neumann_operator_1d(h: np.ndarray) -> np.ndarray:
    """Cell-centred 1D Poisson operator with zero-flux (Neumann) ends on
    cells of widths ``h``: (L p)_i = [(p_{i+1}−p_i)/d_{i+1/2} −
    (p_i−p_{i−1})/d_{i−1/2}]/h_i, boundary fluxes dropped; ``d`` are the
    centre-to-centre gaps."""
    h = np.asarray(h, np.float64)
    n = len(h)
    d = 0.5 * (h[:-1] + h[1:])
    L = np.zeros((n, n))
    for i in range(n):
        if i > 0:
            L[i, i - 1] += 1.0 / (d[i - 1] * h[i])
            L[i, i] -= 1.0 / (d[i - 1] * h[i])
        if i < n - 1:
            L[i, i + 1] += 1.0 / (d[i] * h[i])
            L[i, i] -= 1.0 / (d[i] * h[i])
    return L


def _eig_similar_symmetric(L: np.ndarray, h: np.ndarray):
    """Eigendecomposition of L = D_h⁻¹ T (T symmetric): L is similar to
    S = D^{1/2} L D^{-1/2} = Q Λ Qᵀ (tridiagonal, so ``eigh_tridiagonal``,
    O(n²)), giving real eigenpairs V = D^{-1/2} Q, V⁻¹ = Qᵀ D^{1/2}."""
    h = np.asarray(h, np.float64)
    sq = np.sqrt(h)
    S = (L * h[:, None]) / sq[:, None] / sq[None, :]
    S = 0.5 * (S + S.T)  # symmetrize roundoff
    lam, Q = eigh_tridiagonal(np.diag(S).copy(), np.diag(S, 1).copy())
    return lam, Q / sq[:, None], Q.T * sq[None, :]


def uniform_neumann_eigs(n: int, h: float):
    """Analytic eigendecomposition of the uniform cell-centred Neumann
    operator: the DCT-II cosine basis v_k(i) = cos(πk(2i+1)/2n) with
    λ_k = (2cos(πk/n) − 2)/h² (O(n²) to build, no numerical eig)."""
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    V = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    w = np.full(n, 2.0 / n)
    w[0] = 1.0 / n
    Vinv = (V * w).T
    lam = (2.0 * np.cos(np.pi * np.arange(n) / n) - 2.0) / h**2
    return lam, V, Vinv


class FDMSolver(nn.Module):
    """``forward(rhs) -> φ``: the exact Neumann Poisson solve on the
    stretched cell-centred grid of widths (hx, hy), the constant mode
    projected out. ``eigs=((lx, Vx, Vxi), (ly, Vy, Vyi))`` skips the numeric
    eigendecomposition (a uniform grid has the analytic basis)."""

    def __init__(self, hx, hy, nullspace_tol: float = 1e-10, eigs=None, *, device):
        super().__init__()
        hx = np.asarray(hx, np.float64)
        hy = np.asarray(hy, np.float64)
        if eigs is not None:
            (lx, Vx, Vxi), (ly, Vy, Vyi) = eigs
        else:
            lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
            ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
        self.shape = (len(hy), len(hx))
        lam = ly[:, None] + lx[None, :]
        scale = max(np.abs(lam).max(), 1.0)
        with np.errstate(divide="ignore"):  # the analytic basis has λ₀ = 0 exactly
            inv_lam = np.where(np.abs(lam) < nullspace_tol * scale, 0.0, 1.0 / lam)
        for name, a in (("VxT", Vx.T), ("VxiT", Vxi.T), ("Vy", Vy), ("Vyi", Vyi),
                        ("inv_lam", inv_lam)):
            self.register_buffer(name, torch.tensor(np.asarray(a, np.float32), device=device))

    def forward(self, rhs):
        if tuple(rhs.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, got {tuple(rhs.shape)}")
        with full_fp32_matmul():
            rhat = self.Vyi @ rhs @ self.VxiT
            return self.Vy @ (rhat * self.inv_lam) @ self.VxT


def make_fdm_solver(hx, hy, nullspace_tol: float = 1e-10, eigs=None, *, device) -> FDMSolver:
    """The exact Neumann Poisson solver of a stretched cell-centred grid on
    ``device`` (an :class:`FDMSolver`)."""
    return FDMSolver(hx, hy, nullspace_tol, eigs, device=device)


class FDMSolver3D(nn.Module):
    """``forward(rhs) -> φ``: the exact Neumann Poisson solve on the
    stretched cell-centred 3D grid of widths (hx, hy, hz), L = Lz ⊕ Ly ⊕ Lx,
    by six eigenbasis products and one spectral division, the constant mode
    projected out: the stretched analog of the 3D DCT solve. The products
    contract in the JAX package's order (x, y, z, then back z, y, x) and run
    in full float32 (:func:`full_fp32_matmul`)."""

    def __init__(self, hx, hy, hz, nullspace_tol: float = 1e-10, *, device):
        super().__init__()
        (lx, Vx, Vxi), (ly, Vy, Vyi), (lz, Vz, Vzi) = (
            _eig_similar_symmetric(neumann_operator_1d(h), h)
            for h in (np.asarray(a, np.float64) for a in (hx, hy, hz)))
        self.shape = (len(lz), len(ly), len(lx))
        lam = lz[:, None, None] + ly[None, :, None] + lx[None, None, :]
        scale = max(np.abs(lam).max(), 1.0)
        inv_lam = np.where(np.abs(lam) < nullspace_tol * scale, 0.0, 1.0 / lam)
        for name, a in (("VxT", Vx.T), ("VxiT", Vxi.T), ("Vy", Vy), ("Vyi", Vyi), ("Vz", Vz),
                        ("Vzi", Vzi), ("inv_lam", inv_lam)):
            self.register_buffer(name, torch.tensor(np.asarray(a, np.float32), device=device))

    def forward(self, rhs):
        if tuple(rhs.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, got {tuple(rhs.shape)}")
        with full_fp32_matmul():
            t = rhs @ self.VxiT
            t = torch.einsum("ab,zbx->zax", self.Vyi, t)
            t = torch.einsum("ab,byx->ayx", self.Vzi, t)
            t = t * self.inv_lam
            t = torch.einsum("ab,byx->ayx", self.Vz, t)
            t = torch.einsum("ab,zbx->zax", self.Vy, t)
            return t @ self.VxT


def make_fdm_solver_3d(hx, hy, hz, nullspace_tol: float = 1e-10, *, device) -> FDMSolver3D:
    """The exact Neumann Poisson solver of a stretched cell-centred 3D grid
    on ``device`` (an :class:`FDMSolver3D`)."""
    return FDMSolver3D(hx, hy, hz, nullspace_tol, device=device)
