"""Pressure-Poisson solvers (``cfdsim_tpu.solvers.poisson``): Jacobi,
red-black SOR (streaming, or the RB-SOR kernels), geometric multigrid,
the periodic FFT solve, the exact Neumann DCT solve, and the DCT + masked
SOR hybrid.

All solvers share one convention:

    solve  ∇²φ = rhs   (for Chorin projection, rhs = div(u*) / dt)

φ is collocated with the velocity field, shape (ny, nx). The ``"neumann"``
boundary condition makes every node an unknown, with zero normal gradient
imposed by clamped edge padding (ghost = edge value). That operator is
exactly diagonal in the 2D DCT-II basis, which the ``"dct"`` method uses:
forward DCT, multiply by 1/λ, inverse DCT, with the constant nullspace mode
projected out. The FFTs run on ``torch.fft`` (cuFFT on the card); the
Makhoul permutes, twiddles and the 1/λ multiply are plain torch around
them. Its variants (``dct_variant``) solve the same problem by different
routes: ``rfft`` (per-axis real FFTs), ``rfft2`` (one 2D real FFT),
``rfft_split``/``rfft_split4``/``rfft_split8`` (the per-axis real FFT
through a half-length complex FFT and 0-2 further radix-2 peels),
``packed`` (two real lines per complex FFT), ``matmul`` (fast
diagonalization, ``solvers/fdm.py``) and ``auto`` (the fastest of them on
the device, measured once per shape by ``solvers/autotune.py`` when the
solver is built). ``"dirichlet"`` keeps the one-node frame at φ0's values and updates
only the interior (iterative methods only). An optional solid mask
freezes φ inside embedded bodies.

``method="rbsor_pallas"`` and multigrid smoothing with
``mg_pallas_smooth`` run the hand-written RB-SOR kernels of
``ops/kernels/poisson_rb.py`` on CUDA tensors (their plain versions on the
CPU). The streaming ``"jacobi"``/``"rbsor"`` early exit (``tol > 0``)
reads the residual on the host once per ``check_every`` sweeps; the
kernel path keeps it on the device.

Not ported: ``"dct"`` with a non-Neumann ``bc``, which raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.ops.stencil import laplacian

METHODS = ("jacobi", "rbsor", "rbsor_pallas", "mg", "fft", "dct", "hybrid")
DCT_VARIANTS = ("rfft", "rfft2", "rfft_split", "rfft_split4", "rfft_split8", "packed",
                "matmul", "auto")


@dataclasses.dataclass(frozen=True)
class PoissonConfig:
    """Static configuration for the pressure solve (the JAX package's
    fields and defaults).

    method: "jacobi" | "rbsor" | "rbsor_pallas" | "mg" | "fft" | "dct"
            | "hybrid" (exact DCT + masked rbsor repair around solids)
    iters: sweep budget (jacobi/rbsor/rbsor_pallas/hybrid) or number of
        V-cycles (mg)
    tol: if > 0, stop early once the max residual is ≤ tol, checked every
        ``check_every`` sweeps, after at most ``max(1, iters //
        check_every)`` checks
    omega: SOR relaxation factor (1.0 = Gauss-Seidel)
    bc: "neumann" | "dirichlet" for the iterative methods; "dct" solves
        the neumann problem; "periodic" is solved only by "fft"
    mg_pre/mg_post: smoothing sweeps per level; mg_coarse: coarsest sweeps
    mg_pallas_smooth: multigrid smoothing through the RB-SOR kernels;
        "auto" = for CUDA tensors (plain sweeps on the CPU), True/False force
    dct_variant: exact-DCT backend, one of ``DCT_VARIANTS`` (module
        docstring); "rfft2" and "rfft_split*" take the per-axis "rfft" path
        on a shape with an odd side; "auto" is resolved when the solver is
        built
    """

    method: str = "rbsor"
    iters: int = 100
    tol: float = 0.0
    check_every: int = 8
    omega: float = 1.7
    bc: str = "neumann"
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarse: int = 40
    mg_min_size: int = 4
    mg_pallas_smooth: bool | str = "auto"
    dct_variant: str = "rfft"


def check_ported(cfg: PoissonConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port lacks and
    ``ValueError`` for one the JAX package refuses too."""
    if cfg.method not in METHODS:
        raise ValueError(f"unknown poisson method {cfg.method!r}")
    if cfg.method == "dct":
        if cfg.dct_variant not in DCT_VARIANTS:
            raise ValueError(f"unknown dct_variant {cfg.dct_variant!r}; one of {DCT_VARIANTS}")
        if cfg.bc != "neumann":
            raise NotImplementedError(
                f"the dct method solves the neumann problem only, got bc={cfg.bc!r}"
            )
    elif cfg.method == "mg" and cfg.bc != "neumann":
        raise ValueError("multigrid supports the neumann convention")
    elif cfg.method in ("jacobi", "rbsor", "rbsor_pallas") and cfg.bc not in (
            "neumann", "dirichlet"):
        raise ValueError(
            f"bc={cfg.bc!r} is solved only by method='fft'; the iterative "
            "sweeps implement the neumann/dirichlet conventions"
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


def _color_masks(shape, bc: str, solid_mask, device):
    """(red, black) boolean masks of updatable nodes (built once)."""
    ny, nx = shape
    ij = np.add.outer(np.arange(ny), np.arange(nx))
    if bc == "neumann":
        updatable = np.ones(shape, dtype=bool)
    else:  # dirichlet: frame is fixed
        updatable = np.zeros(shape, dtype=bool)
        updatable[1:-1, 1:-1] = True
    red = torch.from_numpy(((ij % 2) == 0) & updatable).to(device)
    black = torch.from_numpy(((ij % 2) == 1) & updatable).to(device)
    if solid_mask is not None:
        fluid = ~torch.as_tensor(solid_mask, dtype=torch.bool, device=device)
        red, black = red & fluid, black & fluid
    return red, black


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------

def _sweep(phi, rhs, dx: float, dy: float, colors, omega: float, bc: str):
    """One smoothing sweep. ``colors`` is a tuple of update masks: one
    entry → Jacobi; (red, black) → red-black Gauss–Seidel/SOR where the
    black half reads the freshly updated red values."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    denom_inv = 1.0 / (2.0 * (ax + ay))
    nb = _neighbor_sum_neumann if bc == "neumann" else _neighbor_sum_dirichlet
    for color in colors:
        phi_star = (nb(phi, ax, ay) - rhs) * denom_inv
        upd = (1.0 - omega) * phi + omega * phi_star
        phi = torch.where(color, upd, phi)
    return phi


def _iterate(sweep_fn, phi, rhs, cfg: PoissonConfig, dx, dy, solid_mask):
    """Run sweeps for a fixed budget, or until tol with periodic checks.
    The check reads the residual on the host (one synchronisation per
    ``check_every`` sweeps); the number of chunks run equals the JAX
    package's while_loop."""
    if cfg.tol <= 0.0:
        for _ in range(cfg.iters):
            phi = sweep_fn(phi)
        return phi
    check = max(1, cfg.check_every)
    for _ in range(max(1, cfg.iters // check)):
        for _ in range(check):
            phi = sweep_fn(phi)
        if not bool(poisson_residual(phi, rhs, dx, dy, solid_mask, cfg.bc) > cfg.tol):
            break
    return phi


# ---------------------------------------------------------------------------
# geometric multigrid (Neumann, cell-centered convention)
# ---------------------------------------------------------------------------

def _restrict(r):
    """Full-weighting restriction: 2x2 block average (halves both dims)."""
    ny, nx = r.shape
    return r.reshape(ny // 2, 2, nx // 2, 2).mean(dim=(1, 3))


def _prolong_axis(e, axis: int):
    """Bilinear cell-centered prolongation along one axis: fine value at 2i
    gets weights (3/4, 1/4) from coarse cells (i, i−1), at 2i+1 from
    (i, i+1), with clamped ends (consistent with the Neumann operator)."""
    n = e.shape[axis]
    lo = torch.cat([e.narrow(axis, 0, 1), e.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([e.narrow(axis, 1, n - 1), e.narrow(axis, n - 1, 1)], axis)
    a = 0.75 * e + 0.25 * lo
    b = 0.75 * e + 0.25 * hi
    shape = list(e.shape)
    shape[axis] *= 2
    return torch.stack([a, b], axis + 1).reshape(shape)


def _prolong(e):
    """Bilinear prolongation (doubles both dims)."""
    return _prolong_axis(_prolong_axis(e, 0), 1)


def _mg_level_shapes(shape, min_size: int):
    shapes = [tuple(shape)]
    ny, nx = shape
    while ny % 2 == 0 and nx % 2 == 0 and min(ny, nx) // 2 >= min_size:
        ny, nx = ny // 2, nx // 2
        shapes.append((ny, nx))
    return shapes


def _mg_masks(shape, cfg: PoissonConfig, device):
    """Red/black masks for every multigrid level (built once)."""
    return [_color_masks(s, "neumann", None, device)
            for s in _mg_level_shapes(shape, cfg.mg_min_size)]


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


def _dct2_fast(x, axis: int, tw, rfft=None):
    """Makhoul single-FFT DCT-II (even length): permute to
    v = [x_even, reversed(x_odd)], one real FFT, twiddle.
    ``tw`` = exp(−iπk/2n), k ≤ n/2. ``rfft(v, axis)`` replaces
    ``torch.fft.rfft`` (the ``rfft_split`` variants' :class:`_HalfFFT`)."""
    n = x.shape[axis]
    lead = (slice(None),) * axis
    ev = x[lead + (slice(0, None, 2),)]
    od = x[lead + (slice(1, None, 2),)]
    v = torch.cat([ev, torch.flip(od, (axis,))], axis)
    W = torch.fft.rfft(v, dim=axis) if rfft is None else rfft(v, axis)
    # with B = e^{-iπk/2n}·W[k] (k ≤ n/2): X[k] = 2·Re(B[k]), X[n−k] = −2·Im(B[k])
    B = tw * W
    head = 2.0 * torch.real(B)
    tail = -2.0 * torch.flip(torch.imag(B.narrow(axis, 1, n // 2 - 1)), (axis,))
    return torch.cat([head, tail], axis)


def _idct2_fast(X, axis: int, tw, scale_k=None, scale_nk=None, irfft=None):
    """Exact inverse of ``_dct2_fast``: V[k] = e^{iπk/2n}·(X[k] − i·X[n−k])/2,
    one inverse real FFT, un-permute. ``tw`` = exp(+iπk/2n), k ≤ n/2.
    ``scale_k``/``scale_nk`` fold a spectral multiplier (the Poisson 1/λ)
    into this pass; ``irfft(V, axis)`` replaces ``torch.fft.irfft``."""
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
    v = torch.fft.irfft(V, n=n, dim=axis) if irfft is None else irfft(V, axis)
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


def _dct_fwd(x, axis: int):
    """DCT-II along ``axis`` of a 2D or 3D array, any length (Makhoul's
    single real FFT where the length is even), twiddles built on the call:
    the functional form that ``solvers/helmholtz.py`` builds its DST-II on,
    and the 3D solve's per-axis path. A solver that transforms repeatedly
    keeps its twiddles as buffers (:class:`NeumannDCT`)."""
    n = x.shape[axis]
    if n % 2 == 0:
        return _dct2_fast(x, axis, _bcast(_twiddle(n, n // 2 + 1, -1, x.device), x.ndim, axis))
    return _dct2(x, axis, _bcast(_twiddle(n, n, -1, x.device), x.ndim, axis))


def _dct_inv(X, axis: int):
    """Exact inverse of :func:`_dct_fwd`."""
    n = X.shape[axis]
    if n % 2 == 0:
        return _idct2_fast(X, axis, _bcast(_twiddle(n, n // 2 + 1, +1, X.device), X.ndim, axis))
    return _idct2(X, axis, _bcast(_twiddle(n, n, +1, X.device), X.ndim, axis))


def dct3d_twiddles(shape, sign: int, device) -> tuple:
    """The three twiddles of :func:`_dct3d_rfftn` (``sign=-1``) or of
    :func:`_idct3d_rfftn` (``sign=+1``): exp(sign·iπk/2n) per axis, the
    last axis over its half spectrum, shaped to broadcast."""
    n0, n1, n2 = shape
    return (_bcast(_twiddle(n0, n0, sign, device), 3, 0),
            _bcast(_twiddle(n1, n1, sign, device), 3, 1),
            _bcast(_twiddle(n2, n2 // 2 + 1, sign, device), 3, 2))


def _flip_mod(a, axis: int):
    """a[(−k) % n] along ``axis``."""
    return torch.roll(torch.flip(a, (axis,)), 1, axis)


def _dct3d_rfftn(x, w=None):
    """Full 3D DCT-II (2× scale per axis) of a real even³ array through ONE
    ``torch.fft.rfftn`` (3D Makhoul). With v the per-axis permuted
    sequence, V = rfftn(v) and Vf = V[(−k0)%n0, (−k1)%n1, k2], the two
    k2-quadrant fields G1 = w₂V + w₂*·conj(Vf) (→ C[..., k2]) and G2 =
    i(w₂V − w₂*·conj(Vf)) (→ C[..., n2−k2]) recombine over (±k0, ±k1) as
    Cj = 2·Re{w₀(w₁Gj + w₁*·Gj[k0, (−k1)%n1, k2])}. ``w`` are
    :func:`dct3d_twiddles` (sign −1), built on the call when omitted."""
    n0, n1, n2 = x.shape
    w0, w1, w2 = dct3d_twiddles(x.shape, -1, x.device) if w is None else w
    v = torch.cat([x[::2], torch.flip(x[1::2], (0,))], 0)
    v = torch.cat([v[:, ::2], torch.flip(v[:, 1::2], (1,))], 1)
    v = torch.cat([v[:, :, ::2], torch.flip(v[:, :, 1::2], (2,))], 2)
    V = torch.fft.rfftn(v)
    Vf = _flip_mod(_flip_mod(V, 0), 1)
    A, B = w2 * V, torch.conj(w2) * torch.conj(Vf)
    out = []
    for Gj in (A + B, 1j * (A - B)):
        Qj = _flip_mod(Gj, 1)
        out.append(2.0 * torch.real(w0 * (w1 * Gj + torch.conj(w1) * Qj)))
    head, tail = out
    return torch.cat([head, torch.flip(tail[:, :, 1 : n2 // 2], (2,))], 2)


def _spectral_unfold(X, wconj, axis: int):
    """One axis of the inverse Makhoul reconstruction, valid for complex
    input: ½·wconj·(X − i·X[(n−k)%n]), the reversed term zero at k = 0;
    ``wconj`` is the conjugate twiddle e^{+iπk/2n}."""
    n = X.shape[axis]
    zero = torch.zeros_like(X.narrow(axis, 0, 1))
    rev = torch.flip(X.narrow(axis, 1, n - 1), (axis,))
    Xr = torch.cat([zero, rev], axis)
    return wconj * (0.5 * (X - 1j * Xr))


def _idct3d_rfftn(X, scale=None, w=None):
    """Exact inverse of :func:`_dct3d_rfftn` (even³), ONE
    ``torch.fft.irfftn``: the axis-2 real-input reconstruction onto the k2
    half spectrum, the complex-valid unfold along axes 1 and 0, then the
    un-permute. ``scale`` folds a real spectral multiplier (the Poisson
    1/λ) in; ``w`` are :func:`dct3d_twiddles` (sign +1)."""
    n0, n1, n2 = X.shape
    w0, w1, w2 = dct3d_twiddles(X.shape, +1, X.device) if w is None else w
    if scale is not None:
        X = X * scale
    Xk = X[:, :, : n2 // 2 + 1]
    Xnk = torch.cat([X.new_zeros((n0, n1, 1)), torch.flip(X[:, :, n2 // 2 + 1 :], (2,)),
                     X[:, :, n2 // 2 : n2 // 2 + 1]], 2)
    S = w2 * (0.5 * (Xk - 1j * Xnk))
    S = _spectral_unfold(S, w1, 1)
    V = _spectral_unfold(S, w0, 0)
    v = torch.fft.irfftn(V, s=(n0, n1, n2))
    v = torch.stack([v[: n0 // 2], torch.flip(v[n0 // 2 :], (0,))], 1).reshape(n0, n1, n2)
    v = torch.stack([v[:, : n1 // 2], torch.flip(v[:, n1 // 2 :], (1,))], 2).reshape(n0, n1, n2)
    return torch.stack([v[:, :, : n2 // 2], torch.flip(v[:, :, n2 // 2 :], (2,))],
                       3).reshape(n0, n1, n2)


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


def _root(n: int, length: int, sign: int, device) -> torch.Tensor:
    """exp(sign·2πik/n) for k < ``length``, complex64, the angle in fp32."""
    k = torch.arange(length, device=device, dtype=torch.float32)
    return torch.exp((sign * 1j) * (2 * torch.pi * k / n))


def _bcast(t: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A 1D table viewed to broadcast along ``axis`` of an ``ndim`` array."""
    shape = [1] * ndim
    shape[axis] = t.shape[0]
    return t.view(shape)


def _spectrum_reverse(F, axis: int):
    """F[(n−k) mod n]: index reversal of a full FFT spectrum."""
    return torch.roll(torch.flip(F, (axis,)), 1, axis)


def _halves(x, axis: int):
    """(x[0::2], x[1::2]) along ``axis``."""
    lead = (slice(None),) * axis
    return x[lead + (slice(0, None, 2),)], x[lead + (slice(1, None, 2),)]


def _interleave(a, b, axis: int):
    """The inverse of :func:`_halves`: a and b alternate along ``axis``."""
    shape = list(a.shape)
    shape[axis] *= 2
    return torch.stack([a, b], axis + 1).reshape(shape)


class _HalfFFT(nn.Module):
    """The real FFT (and its inverse) of even-length-``n`` lines through ONE
    half-length complex FFT (even/odd packing and a Hermitian split), with
    ``depth`` further radix-2 decimation-in-time peels of that complex FFT,
    whose halves are batched along a new leading axis (the JAX package's
    ``_rfft_half``/``_irfft_half``/``_fft_split``/``_ifft_split``). The
    twiddles are buffers."""

    def __init__(self, n: int, depth: int, *, device):
        super().__init__()
        self.n, self.depth = n, depth
        m = n // 2
        self.register_buffer("w", _root(n, m, -1, device))
        self.register_buffer("wc", _root(n, m, +1, device))
        for level in range(depth):  # the peels split lengths m, m/2, …
            L = m >> level
            self.register_buffer(f"peel{level}", _root(L, L // 2, -1, device))
            self.register_buffer(f"peelc{level}", _root(L, L // 2, +1, device))

    def _fft(self, z, axis: int, level: int = 0):
        if level == self.depth:
            return torch.fft.fft(z, dim=axis)
        ze, zo = _halves(z, axis)
        ZZ = self._fft(torch.stack([ze, zo]), axis + 1, level + 1)
        E, O = ZZ[0], ZZ[1]
        wO = _bcast(getattr(self, f"peel{level}"), E.ndim, axis) * O
        return torch.cat([E + wO, E - wO], axis)

    def _ifft(self, Z, axis: int, level: int = 0):
        if level == self.depth:
            return torch.fft.ifft(Z, dim=axis)
        n = Z.shape[axis]
        A, B = Z.narrow(axis, 0, n // 2), Z.narrow(axis, n // 2, n // 2)
        wc = _bcast(getattr(self, f"peelc{level}"), A.ndim, axis)
        zz = self._ifft(torch.stack([0.5 * (A + B), 0.5 * wc * (A - B)]), axis + 1, level + 1)
        return _interleave(zz[0], zz[1], axis)

    def rfft(self, v, axis: int):
        """``torch.fft.rfft(v, dim=axis)``: length n/2 + 1 along ``axis``."""
        ve, vo = _halves(v, axis)
        Z = self._fft(torch.complex(ve, vo), axis)  # length n/2
        Zr = torch.conj(_spectrum_reverse(Z, axis))
        E = 0.5 * (Z + Zr)
        O = -0.5j * (Z - Zr)
        head = E + _bcast(self.w, E.ndim, axis) * O  # X[k], k < n/2
        return torch.cat([head, (E - O).narrow(axis, 0, 1)], axis)  # X[n/2] = E0 − O0

    def irfft(self, X, axis: int):
        """``torch.fft.irfft(X, n=n, dim=axis)`` of the half spectrum ``X``."""
        m = self.n // 2
        Xk = X.narrow(axis, 0, m)
        Xc = torch.conj(torch.flip(X.narrow(axis, 1, m), (axis,)))  # conj X[n/2 − k]
        E = 0.5 * (Xk + Xc)
        O = 0.5 * _bcast(self.wc, Xk.ndim, axis) * (Xk - Xc)
        z = self._ifft(E + 1j * O, axis)
        return _interleave(torch.real(z), torch.imag(z), axis)


def _cdct(z, axis: int, tw):
    """Complexified Makhoul DCT-II along ``axis`` (even length n):
    DCT(Re z) + i·DCT(Im z) in one full-length complex FFT,
    X[k] = tw[k]·F[k] + conj(tw[k])·F[(n−k) mod n], tw = e^{−iπk/2n}, k < n."""
    ev, od = _halves(z, axis)
    F = torch.fft.fft(torch.cat([ev, torch.flip(od, (axis,))], axis), dim=axis)
    return tw * F + torch.conj(tw) * _spectrum_reverse(F, axis)


def _icdct(X, axis: int, tw):
    """Exact inverse of :func:`_cdct`: F[k] = e^{iπk/2n}·(X[k] − i·X_rev[k])/2
    with X_rev = [0, X[n−1], …, X[1]], one complex inverse FFT, un-permute;
    ``tw`` = e^{+iπk/2n}, k < n."""
    n = X.shape[axis]
    Xrev = torch.cat([torch.zeros_like(X.narrow(axis, 0, 1)),
                      torch.flip(X.narrow(axis, 1, n - 1), (axis,))], axis)
    v = torch.fft.ifft(tw * (X - 1j * Xrev) * 0.5, dim=axis)
    return _interleave(v.narrow(axis, 0, n // 2),
                       torch.flip(v.narrow(axis, n // 2, n // 2), (axis,)), axis)


def _pack(a, axis: int):
    """Adjacent line pairs along ``axis`` as one complex line: a0 + i·a1."""
    return torch.complex(*_halves(a, axis))


def _unpack(z, axis: int):
    """Re/Im back into adjacent real lines along ``axis``."""
    return _interleave(torch.real(z), torch.imag(z), axis)


def _split_depth(variant: str) -> int:
    """Radix-2 levels of an ``rfft_split*`` variant: the name's suffix is
    the division of the FFT length (none = 2): 2 → 1, 4 → 2, 8 → 3."""
    factor = int(variant[len("rfft_split"):] or "2")
    return max(factor.bit_length() - 1, 1)


class NeumannDCT(nn.Module):
    """Exact solver of the clamped-edge (Neumann) FD Poisson problem on one
    (m, n) grid by the DCT variant ``variant`` (``DCT_VARIANTS``; "auto" is
    measured, or read from the autotuner's cache, here at construction).
    The 1/λ table and the twiddles (or the fast-diagonalization matrices)
    are built once, as buffers, on ``device``; ``forward(rhs)`` returns φ
    (mean-free) and does no host work."""

    def __init__(self, shape, dx: float, dy: float, variant: str = "rfft", *, device):
        super().__init__()
        if variant not in DCT_VARIANTS:
            raise ValueError(f"unknown dct_variant {variant!r}; one of {DCT_VARIANTS}")
        m, n = shape
        if variant == "auto":
            from cfdsim_tpu_torch.solvers.autotune import best_dct_variant

            variant = best_dct_variant((m, n), dx, dy, device=device)
        self.shape = (m, n)
        self.variant = variant
        even = m % 2 == 0 and n % 2 == 0
        # rfft2 and rfft_split* take the per-axis path on a shape with an odd
        # side, as in the JAX package; packed needs even sides
        mode = variant if even or variant in ("packed", "matmul") else "rfft"
        if mode == "packed" and not even:
            raise ValueError(f"the packed DCT variant needs even sizes, got {(m, n)}")
        self.mode = mode
        if mode == "matmul":
            from cfdsim_tpu_torch.solvers.autotune import matmul_dct_solver

            self.fdm = matmul_dct_solver(m, n, dx, dy, device=device)
            return
        if mode.startswith("rfft_split"):
            depth = _split_depth(mode)
            # the Makhoul permute needs even n, the peels n/2 divisible by 2^(depth−1)
            if min(m, n) % (1 << (depth + 1)):
                raise ValueError(f"{mode} needs sizes divisible by {1 << (depth + 1)}")
            self.half0 = _HalfFFT(m, depth - 1, device=device)
            self.half1 = _HalfFFT(n, depth - 1, device=device)
        ilam = _inv_neumann_eigenvalues(m, n, dx, dy)
        self.register_buffer("ilam", torch.from_numpy(ilam).to(device))
        if mode in ("packed", "rfft2"):
            lengths = (m, n) if mode == "packed" else (m, n // 2 + 1)
        else:
            lengths = tuple(L // 2 + 1 if L % 2 == 0 else L for L in (m, n))
        for axis, (L, length) in enumerate(zip((m, n), lengths)):
            self.register_buffer(f"fwd{axis}", _along(_twiddle(L, length, -1, device), axis))
            self.register_buffer(f"inv{axis}", _along(_twiddle(L, length, +1, device), axis))
        if mode not in ("packed", "rfft2") and n % 2 == 0:
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
        mode = self.mode
        if mode == "matmul":
            return self.fdm(rhs)
        if mode == "rfft2":
            rhs_hat = _dct2d_rfft2(rhs, self.fwd0, self.fwd1)
            return _idct2d_rfft2(rhs_hat, self.inv0, self.inv1, scale=self.ilam)
        if mode == "packed":
            # each axis transform packs line pairs along the other axis
            A = _unpack(_cdct(_pack(rhs, 0), 1, self.fwd1), 0)
            rhs_hat = _unpack(_cdct(_pack(A, 1), 0, self.fwd0), 1)
            X = rhs_hat * self.ilam
            A = _unpack(_icdct(_pack(X, 1), 0, self.inv0), 1)
            return _unpack(_icdct(_pack(A, 0), 1, self.inv1), 0)
        if mode.startswith("rfft_split"):
            h0, h1 = self.half0, self.half1
            rhs_hat = _dct2_fast(_dct2_fast(rhs, 0, self.fwd0, h0.rfft), 1, self.fwd1, h1.rfft)
            X = _idct2_fast(rhs_hat, 1, self.inv1, self.ilam_k, self.ilam_nk, h1.irfft)
            return _idct2_fast(X, 0, self.inv0, irfft=h0.irfft)
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


# ---------------------------------------------------------------------------
# periodic FFT solve
# ---------------------------------------------------------------------------

def _periodic_eigenvalues(ny: int, nx: int, dx: float, dy: float, device):
    """The discrete 5-point symbol (2cos(2πk/n)−2)/h², float32 as the JAX
    package computes it, with λ[0, 0] = 1."""
    kx = torch.fft.rfftfreq(nx, device=device)
    ky = torch.fft.fftfreq(ny, device=device)
    lam = (2.0 * torch.cos(2.0 * torch.pi * kx)[None, :] - 2.0) / (dx * dx) + (
        2.0 * torch.cos(2.0 * torch.pi * ky)[:, None] - 2.0
    ) / (dy * dy)
    lam[0, 0] = 1.0
    return lam


def _solve_periodic(rhs, lam):
    ny, nx = rhs.shape
    phi_hat = torch.fft.rfft2(rhs) / lam
    phi_hat[0, 0] = 0.0
    return torch.fft.irfft2(phi_hat, s=(ny, nx)).to(rhs.dtype)


def solve_poisson_periodic_fft(rhs, dx: float, dy: float):
    """Exact solve of the 5-point FD Poisson problem on a fully periodic
    grid with the discrete symbol λ(k) = (2cos(2πk/n)−2)/h², so the result
    is consistent with the central-difference operators."""
    ny, nx = rhs.shape
    return _solve_periodic(rhs, _periodic_eigenvalues(ny, nx, dx, dy, rhs.device))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

class PoissonSolver(nn.Module):
    """``forward(phi0, rhs) -> φ`` for one (ny, nx) grid, configuration and
    solid mask. Its tables (colour masks, multigrid level masks, the DCT
    1/λ table and twiddles, the periodic symbol, the float solid mask the
    kernels read) are buffers built once on ``device``. ``chunks_run``
    counts, on the device, the early-exit chunks that
    ``method="rbsor_pallas"`` with ``tol > 0`` ran. ``reads_host`` says
    whether a solve waits for the host: only the streaming
    ``jacobi``/``rbsor`` early exit (``tol > 0``) does, once per
    ``check_every`` sweeps, so a step through it cannot be captured into a
    CUDA graph."""

    def __init__(self, shape, dx: float, dy: float, cfg: PoissonConfig = PoissonConfig(),
                 solid_mask=None, *, device):
        super().__init__()
        check_ported(cfg)
        self.shape = tuple(shape)
        self.dx, self.dy, self.cfg = dx, dy, cfg
        method = cfg.method
        self.reads_host = method in ("jacobi", "rbsor") and cfg.tol > 0.0
        solid = None
        if solid_mask is not None:
            solid = torch.as_tensor(solid_mask, dtype=torch.bool, device=device)
            if tuple(solid.shape) != self.shape:
                raise ValueError(f"solid mask {tuple(solid.shape)} for grid {self.shape}")
        if method == "mg" and solid is not None:
            raise ValueError("multigrid is unmasked; use rbsor for masks")
        if method in ("dct", "fft"):
            solid = None  # the direct solves ignore the mask, as in the JAX package
        self.register_buffer("solid", solid)
        self.register_buffer("solid_f", None if solid is None else solid.to(torch.float32))
        self.register_buffer("chunks_run", torch.zeros((), dtype=torch.int32, device=device))
        self.dct = None
        self.n_levels = 0
        if method == "dct":
            self.dct = NeumannDCT(self.shape, dx, dy, cfg.dct_variant, device=device)
        elif method == "hybrid":
            self.dct = NeumannDCT(self.shape, dx, dy, "rfft", device=device)
            if solid is not None:
                self._colours("", _color_masks(self.shape, "neumann", solid, device))
        elif method == "fft":
            self.register_buffer("lam", _periodic_eigenvalues(*self.shape, dx, dy, device))
        elif method == "mg":
            masks = _mg_masks(self.shape, cfg, device)
            self.n_levels = len(masks)
            for level, colours in enumerate(masks):
                self._colours(str(level), colours)
        elif method in ("jacobi", "rbsor"):
            red, black = _color_masks(self.shape, cfg.bc, solid, device)
            self._colours("", (red | black,) if method == "jacobi" else (red, black))

    def _colours(self, tag: str, colours):
        for name, mask in zip(("red", "black"), colours):
            self.register_buffer(f"{name}{tag}", mask)

    def _level_colours(self, tag: str):
        return tuple(getattr(self, f"{n}{tag}") for n in ("red", "black")
                     if getattr(self, f"{n}{tag}", None) is not None)

    def _use_kernels(self, rhs) -> bool:
        flag = self.cfg.mg_pallas_smooth
        return flag is True or (flag == "auto" and rhs.device.type == "cuda")

    def _vcycle(self, phi, rhs, dx, dy, level: int, use_kernels: bool):
        cfg = self.cfg
        colours = self._level_colours(str(level))
        # plain red-black Gauss-Seidel (omega=1) is the multigrid smoother;
        # over-relaxation hurts the smoothing factor

        def smooth(p, n_sweeps):
            if n_sweeps == 0:
                return p
            if use_kernels:
                # unmasked Neumann: the blocked kernel above MAX_ELEMS, else
                # kernel A
                from cfdsim_tpu_torch.ops.kernels import poisson_rb

                return poisson_rb.rbsor_routed(p, rhs, dx, dy, iters=n_sweeps, omega=1.0)
            for _ in range(n_sweeps):
                p = _sweep(p, rhs, dx, dy, colours, 1.0, "neumann")
            return p

        phi = smooth(phi, cfg.mg_pre)
        if level == self.n_levels - 1:
            return smooth(phi, cfg.mg_coarse)
        # every node is fluid (multigrid is unmasked), so the JAX package's
        # residual and correction masks select everything
        r = rhs - lap_neumann(phi, dx, dy)
        e_c = torch.zeros_like(r[::2, ::2])
        e_c = self._vcycle(e_c, _restrict(r), 2 * dx, 2 * dy, level + 1, use_kernels)
        phi = phi + _prolong(e_c)
        return smooth(phi, cfg.mg_post)

    def forward(self, phi0, rhs):
        cfg = self.cfg
        dx, dy = self.dx, self.dy
        if tuple(rhs.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, got {tuple(rhs.shape)}")
        if cfg.method == "fft":
            return _solve_periodic(rhs, self.lam)
        if cfg.method == "dct":
            return self.dct(rhs)
        if cfg.method == "hybrid":
            # exact unmasked DCT solve, then masked red-black SOR sweeps that
            # repair the solution around embedded solids
            phi = self.dct(rhs)
            if self.solid is not None:
                phi = torch.where(self.solid, 0.0, phi)
                colours = self._level_colours("")
                for _ in range(cfg.iters):
                    phi = _sweep(phi, rhs, dx, dy, colours, cfg.omega, "neumann")
            return phi
        if cfg.method == "mg":
            use_kernels = self._use_kernels(rhs)
            phi = phi0
            for _ in range(cfg.iters):
                phi = self._vcycle(phi, rhs, dx, dy, 0, use_kernels)
            return phi
        if cfg.method == "rbsor_pallas":
            from cfdsim_tpu_torch.ops.kernels import poisson_rb

            if cfg.tol <= 0.0:
                return poisson_rb.rbsor_routed(phi0, rhs, dx, dy, iters=cfg.iters,
                                               omega=cfg.omega, bc=cfg.bc,
                                               solid_mask=self.solid_f)
            # every chunk on kernel A, which reduces the residual and keeps
            # the early-exit flag on the device
            return poisson_rb.rbsor(phi0, rhs, dx, dy, iters=cfg.iters, omega=cfg.omega,
                                    bc=cfg.bc, solid_mask=self.solid_f, tol=cfg.tol,
                                    check_every=cfg.check_every, chunks_run=self.chunks_run)
        omega = 1.0 if cfg.method == "jacobi" else cfg.omega
        colours = self._level_colours("")

        def sweep(p):
            return _sweep(p, rhs, dx, dy, colours, omega, cfg.bc)

        return _iterate(sweep, phi0, rhs, cfg, dx, dy, self.solid)


def solve_poisson(phi0, rhs, dx: float, dy: float, cfg: PoissonConfig = PoissonConfig(),
                  solid_mask=None):
    """Solve ∇²φ = rhs with the configured backend. ``phi0`` warm-starts
    the iterative backends. Builds a :class:`PoissonSolver` on every call:
    a step that solves repeatedly keeps one."""
    return PoissonSolver(tuple(rhs.shape), dx, dy, cfg, solid_mask, device=rhs.device)(phi0, rhs)
