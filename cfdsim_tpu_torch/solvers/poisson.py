"""Pressure-Poisson solve: the exact Neumann DCT path of
``cfdsim_tpu.solvers.poisson``.

All solvers share one convention:

    solve  ∇²φ = rhs   (for Chorin projection, rhs = div(u*) / dt)

φ is collocated with the velocity field, shape (ny, nx). The ``"neumann"``
boundary condition makes every node an unknown, with zero normal gradient
imposed by clamped edge padding (ghost = edge value). That operator is
exactly diagonal in the 2D DCT-II basis, which the ``"dct"`` method uses:
forward DCT, multiply by 1/λ, inverse DCT, with the constant nullspace mode
projected out. The FFTs run on ``torch.fft`` (cuFFT on the card); the
Makhoul permutes, twiddles and the 1/λ multiply are plain torch around
them.

Ported so far: ``method="dct"`` with ``dct_variant`` "rfft" (one real FFT
per axis; odd lengths use the even-extension transform) and "rfft2" (one 2D
real FFT, even×even; other shapes take the per-axis path). The iterative
methods, the other DCT variants and non-Neumann DCT raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.ops.stencil import laplacian

PORTED_METHODS = ("dct",)
PORTED_DCT_VARIANTS = ("rfft", "rfft2")


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    """Static configuration for the pressure solve: the JAX package's
    fields and defaults, less the sweep, relaxation, early-exit and
    multigrid knobs of the methods not ported yet (only "dct" with the
    "rfft"/"rfft2" variants and the "neumann" BC is; :func:`check_ported`
    refuses the rest).

    method: "jacobi" | "rbsor" | "rbsor_pallas" | "mg" | "fft" | "dct" | "hybrid"
    bc: "neumann" | "dirichlet" | "periodic"
    dct_variant: exact-DCT backend, "rfft" (per-axis real FFTs) or "rfft2"
        (one 2D real FFT, even×even; other shapes take the per-axis path)
    """

    method: str = "rbsor"
    bc: str = "neumann"
    dct_variant: str = "rfft"


def check_ported(cfg: PoissonConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port lacks."""
    if cfg.method not in PORTED_METHODS:
        raise NotImplementedError(
            f"poisson method {cfg.method!r} is not ported yet (ported: "
            f"{PORTED_METHODS}); the iterative methods and the RB-SOR kernels "
            "are ROADMAP.md queue 1 slice 2 and queue 2"
        )
    if cfg.dct_variant not in PORTED_DCT_VARIANTS:
        raise NotImplementedError(
            f"dct_variant {cfg.dct_variant!r} is not ported yet (ported: "
            f"{PORTED_DCT_VARIANTS}); the autotuner and the packed, matmul and "
            "rfft_split variants are ROADMAP.md queue 1"
        )
    if cfg.bc != "neumann":
        raise NotImplementedError(
            f"the dct method solves the neumann problem only, got bc={cfg.bc!r}"
        )


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

def _neighbor_sum_neumann(phi, ax: float, ay: float):
    """ax*(E+W) + ay*(N+S) with clamped edge padding (ghost = edge)."""
    e = torch.cat([phi[:, 1:], phi[:, -1:]], 1)
    w = torch.cat([phi[:, :1], phi[:, :-1]], 1)
    n = torch.cat([phi[1:], phi[-1:]], 0)
    s = torch.cat([phi[:1], phi[:-1]], 0)
    return ax * (e + w) + ay * (n + s)


def _neighbor_sum_dirichlet(phi, ax: float, ay: float):
    """Interior-valid neighbor sum, zero-padded back to full shape."""
    s = ax * (phi[1:-1, 2:] + phi[1:-1, :-2]) + ay * (phi[2:, 1:-1] + phi[:-2, 1:-1])
    return torch.nn.functional.pad(s, (1, 1, 1, 1))


def lap_neumann(phi, dx: float, dy: float):
    """5-point Laplacian with clamped edge padding, defined on all nodes."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    return _neighbor_sum_neumann(phi, ax, ay) - 2.0 * (ax + ay) * phi


def poisson_residual(phi, rhs, dx: float, dy: float, solid_mask=None, bc="neumann"):
    """Max-abs residual |∇²φ − rhs| over updatable nodes (a 0-dim tensor;
    reading it on the host is the caller's choice)."""
    if bc == "neumann":
        r = (lap_neumann(phi, dx, dy) - rhs).abs()
    elif bc == "dirichlet":
        r = (laplacian(phi, dx, dy) - rhs).abs()
        r = torch.nn.functional.pad(r[1:-1, 1:-1], (1, 1, 1, 1))
    else:
        raise ValueError(f"unknown bc {bc!r}")
    if solid_mask is not None:
        r = torch.where(solid_mask.to(torch.bool), 0.0, r)
    return r.amax()


# ---------------------------------------------------------------------------
# DCT-II transforms (2× scale per axis, the JAX package's convention)
# ---------------------------------------------------------------------------

def _twiddle(n: int, length: int, sign: int, device) -> torch.Tensor:
    """exp(sign·iπk/2n) for k < ``length``, complex64, computed in fp32 as
    the JAX package does in its traced code."""
    k = torch.arange(length, device=device, dtype=torch.float32)
    return torch.exp((sign * 1j) * (torch.pi * k / (2 * n)))


def _along(t: torch.Tensor, axis: int) -> torch.Tensor:
    """Shape a 1D table to broadcast along ``axis`` of a 2D array."""
    return t[:, None] if axis == 0 else t[None, :]


def _dct2(x, axis: int, tw):
    """DCT-II along ``axis`` via an even-extension FFT (any length);
    ``tw`` = exp(−iπk/2n), k < n, shaped along ``axis``."""
    n = x.shape[axis]
    V = torch.fft.fft(torch.cat([x, torch.flip(x, (axis,))], axis), dim=axis)
    return torch.real(tw * V.narrow(axis, 0, n))


def _idct2(X, axis: int, tw):
    """Exact inverse of ``_dct2``; ``tw`` = exp(+iπk/2n), k < n."""
    n = X.shape[axis]
    head = X.to(torch.complex64) * tw
    zero = torch.zeros_like(head.narrow(axis, 0, 1))
    tail = torch.conj(torch.flip(head.narrow(axis, 1, n - 1), (axis,)))
    v = torch.fft.ifft(torch.cat([head, zero, tail], axis), dim=axis)
    return torch.real(v.narrow(axis, 0, n))


def _dct2_fast(x, axis: int, tw):
    """Makhoul single-FFT DCT-II (even length): permute to
    v = [x_even, reversed(x_odd)], one real FFT, twiddle.
    ``tw`` = exp(−iπk/2n), k ≤ n/2."""
    n = x.shape[axis]
    ev = x[::2] if axis == 0 else x[:, ::2]
    od = x[1::2] if axis == 0 else x[:, 1::2]
    W = torch.fft.rfft(torch.cat([ev, torch.flip(od, (axis,))], axis), dim=axis)
    # with B = e^{-iπk/2n}·W[k] (k ≤ n/2): X[k] = 2·Re(B[k]), X[n−k] = −2·Im(B[k])
    B = tw * W
    head = 2.0 * torch.real(B)
    tail = -2.0 * torch.flip(torch.imag(B.narrow(axis, 1, n // 2 - 1)), (axis,))
    return torch.cat([head, tail], axis)


def _idct2_fast(X, axis: int, tw, scale_k=None, scale_nk=None):
    """Exact inverse of ``_dct2_fast``: V[k] = e^{iπk/2n}·(X[k] − i·X[n−k])/2,
    one inverse real FFT, un-permute. ``tw`` = exp(+iπk/2n), k ≤ n/2.
    ``scale_k``/``scale_nk`` fold a spectral multiplier (the Poisson 1/λ)
    into this pass."""
    n = X.shape[axis]
    h = n // 2
    Xk = X.narrow(axis, 0, h + 1)
    rev = torch.flip(X.narrow(axis, h + 1, n - h - 1), (axis,))
    zero = torch.zeros_like(X.narrow(axis, 0, 1))
    # X[n−k] for k = 0..n/2  (k=0 → 0 by convention, k=n/2 → X[n/2])
    Xnk = torch.cat([zero, rev, X.narrow(axis, h, 1)], axis)
    if scale_k is not None:
        Xk = Xk * scale_k
        Xnk = Xnk * scale_nk
    V = tw * (0.5 * (Xk - 1j * Xnk))
    v = torch.fft.irfft(V, n=n, dim=axis)
    ev = v.narrow(axis, 0, h)
    od = torch.flip(v.narrow(axis, h, h), (axis,))
    return torch.stack([ev, od], axis + 1).reshape(X.shape)


def _dct2d_rfft2(x, w1, w2):
    """Full 2D DCT-II of a real even×even array via ONE ``rfft2``
    (2D Makhoul). ``w1`` = exp(−iπk1/2m), k1 < m, shape (m, 1);
    ``w2`` = exp(−iπk2/2n), k2 ≤ n/2, shape (1, n/2+1)."""
    m, n = x.shape
    v = torch.cat([x[::2], torch.flip(x[1::2], (0,))], 0)
    v = torch.cat([v[:, ::2], torch.flip(v[:, 1::2], (1,))], 1)
    G = w2 * torch.fft.rfft2(v)  # (m, n//2 + 1)
    Gf = torch.conj(torch.roll(torch.flip(G, (0,)), 1, 0))  # conj G[(−k1)%m, k2]
    head = 2.0 * torch.real(w1 * (G + Gf))
    tail = 2.0 * torch.real(1j * w1 * (G - Gf))
    return torch.cat([head, torch.flip(tail[:, 1 : n // 2], (1,))], 1)


def _idct2d_rfft2(X, w1c, w2c, scale=None):
    """Exact inverse of ``_dct2d_rfft2`` (even×even), one ``irfft2``.
    ``w1c``/``w2c`` are the conjugate twiddles of ``_dct2d_rfft2``'s;
    ``scale`` folds a real spectral multiplier (the Poisson 1/λ) in."""
    m, n = X.shape
    if scale is not None:
        X = X * scale
    Xk = X[:, : n // 2 + 1]
    Xnk = torch.cat(
        [X.new_zeros((m, 1)), torch.flip(X[:, n // 2 + 1 :], (1,)),
         X[:, n // 2 : n // 2 + 1]], 1)
    S = w2c * (0.5 * (Xk - 1j * Xnk))
    Sf = torch.cat([S.new_zeros((1, S.shape[1])), torch.flip(S[1:], (0,))], 0)
    V = w1c * (0.5 * (S - 1j * Sf))
    v = torch.fft.irfft2(V, s=(m, n))
    v = torch.stack([v[: m // 2], torch.flip(v[m // 2 :], (0,))], 1).reshape(m, n)
    return torch.stack([v[:, : n // 2], torch.flip(v[:, n // 2 :], (1,))], 2).reshape(m, n)


def _inv_neumann_eigenvalues(m: int, n: int, dx: float, dy: float) -> np.ndarray:
    """1/λ table (float32, built in float64) for the clamped-edge
    (DCT-II-diagonal) FD Laplacian, with the constant mode zeroed.

    Uses the cancellation-safe identity 2cos(πk/n)−2 = −4sin²(πk/2n)."""
    sy = np.sin(np.pi * np.arange(m) / (2 * m))
    sx = np.sin(np.pi * np.arange(n) / (2 * n))
    lam = (-4.0 / (dy * dy)) * (sy * sy)[:, None] + (-4.0 / (dx * dx)) * (sx * sx)[None, :]
    lam[0, 0] = 1.0
    ilam = (1.0 / lam).astype(np.float32)
    ilam[0, 0] = 0.0  # project out the constant nullspace mode
    return ilam


class NeumannDCT(nn.Module):
    """Exact solver of the clamped-edge (Neumann) FD Poisson problem on one
    (m, n) grid. The 1/λ table and the twiddles are built once, as buffers,
    on ``device``; ``forward(rhs)`` returns φ (mean-free)."""

    def __init__(self, shape, dx: float, dy: float, variant: str = "rfft", *, device):
        super().__init__()
        if variant not in PORTED_DCT_VARIANTS:
            raise NotImplementedError(
                f"dct_variant {variant!r} is not ported yet (ported: {PORTED_DCT_VARIANTS})"
            )
        m, n = shape
        self.shape = (m, n)
        self.use_rfft2 = variant == "rfft2" and m % 2 == 0 and n % 2 == 0
        ilam = _inv_neumann_eigenvalues(m, n, dx, dy)
        self.register_buffer("ilam", torch.from_numpy(ilam).to(device))
        if self.use_rfft2:
            lengths = (m, n // 2 + 1)
        else:
            lengths = tuple(L // 2 + 1 if L % 2 == 0 else L for L in (m, n))
        for axis, (L, length) in enumerate(zip((m, n), lengths)):
            self.register_buffer(f"fwd{axis}", _along(_twiddle(L, length, -1, device), axis))
            self.register_buffer(f"inv{axis}", _along(_twiddle(L, length, +1, device), axis))
        if not self.use_rfft2 and n % 2 == 0:
            # 1/λ for the X[k] and X[n−k] branches of the first inverse pass
            self.register_buffer("ilam_k", self.ilam[:, : n // 2 + 1].clone())
            self.register_buffer("ilam_nk", torch.cat(
                [self.ilam[:, :1], torch.flip(self.ilam[:, n // 2 + 1 :], (1,)),
                 self.ilam[:, n // 2 : n // 2 + 1]], 1))

    def _fwd(self, x, axis):
        tw = getattr(self, f"fwd{axis}")
        return _dct2_fast(x, axis, tw) if x.shape[axis] % 2 == 0 else _dct2(x, axis, tw)

    def _inv(self, X, axis):
        tw = getattr(self, f"inv{axis}")
        return _idct2_fast(X, axis, tw) if X.shape[axis] % 2 == 0 else _idct2(X, axis, tw)

    def forward(self, rhs):
        if tuple(rhs.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, got {tuple(rhs.shape)}")
        if self.use_rfft2:
            rhs_hat = _dct2d_rfft2(rhs, self.fwd0, self.fwd1)
            return _idct2d_rfft2(rhs_hat, self.inv0, self.inv1, scale=self.ilam)
        rhs_hat = self._fwd(self._fwd(rhs, 0), 1)
        if self.shape[1] % 2 == 0:
            # fold 1/λ into the first inverse's spectrum-build pass
            X = _idct2_fast(rhs_hat, 1, self.inv1, scale_k=self.ilam_k, scale_nk=self.ilam_nk)
            return self._inv(X, 0)
        return self._inv(self._inv(rhs_hat * self.ilam, 1), 0)


def solve_poisson_neumann_dct(rhs, dx: float, dy: float, variant: str = "rfft"):
    """Exact solve of the clamped-edge (Neumann) FD Poisson problem; the
    constant nullspace mode is projected out. Builds its tables on every
    call: a step that solves repeatedly keeps one :class:`NeumannDCT`."""
    return NeumannDCT(tuple(rhs.shape), dx, dy, variant, device=rhs.device)(rhs)


def solve_poisson(phi0, rhs, dx: float, dy: float, cfg: PoissonConfig = PoissonConfig(),
                  solid_mask=None):
    """Solve ∇²φ = rhs with the configured backend (``"dct"`` only so far;
    ``phi0`` is the warm start of the iterative backends, unused by it)."""
    check_ported(cfg)
    if solid_mask is not None:
        raise NotImplementedError("masked Poisson solves are not ported yet")
    return solve_poisson_neumann_dct(rhs, dx, dy, variant=cfg.dct_variant)

