"""3D pressure-Poisson solvers (``cfdsim_tpu.solvers.poisson3d``): red-black
SOR, geometric multigrid and the exact DCT solve on (nz, ny, nx) fields.

The convention of ``solvers/poisson.py`` in 3D: every node is an unknown,
zero normal gradient by clamped edge padding (ghost = edge), so the
operator coarsens by 2×2×2 averaging and is diagonal in the 3D DCT-II
basis. ``method="dct"`` transforms with one ``torch.fft.rfftn`` and one
``irfftn`` (``dct_variant="rfftn"``, even sizes) or per axis
(``"rfft"``, and any size with an odd side). Every method runs a fixed
number of sweeps or V-cycles, so a solve reads nothing on the host and a
step that calls it captures into a CUDA graph. All three are plain torch
(cuFFT for the transforms): the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.solvers.poisson import (
    _dct3d_rfftn,
    _dct_fwd,
    _dct_inv,
    _idct3d_rfftn,
    dct3d_twiddles,
)

METHODS_3D = ("rbsor", "mg", "dct")
DCT_VARIANTS_3D = ("rfftn", "rfft")


@dataclasses.dataclass(frozen=True)
class Poisson3DConfig:
    """Static configuration (the JAX package's fields and defaults).

    method: "rbsor" | "mg" | "dct"
    iters: sweeps (rbsor) or V-cycles (mg)
    dct_variant: "rfftn" (one real 3D FFT each way; even sizes, else the
        per-axis path) or "rfft" (per-axis transforms)
    """

    method: str = "mg"
    iters: int = 2
    omega: float = 1.5
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarse: int = 20
    mg_min_size: int = 4
    dct_variant: str = "rfftn"


def pad_edge_3d(x):
    """``x`` (nz, ny, nx) padded by one layer on every side with its edge
    values (ghost = edge): one replicate-pad kernel on a CUDA device; on the
    CPU the same values by clamped index gathers, since PyTorch's CPU
    replicate pad dispatches every plane as a parallel task."""
    if x.is_cuda:
        return F.pad(x[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    for axis, n in enumerate(x.shape):
        x = x.index_select(axis, torch.arange(-1, n + 1).clamp_(0, n - 1))
    return x


def _nb_sum(phi, ax: float, ay: float, az: float):
    """Clamped-edge neighbour sum in 3D (ghost = edge value)."""
    p = pad_edge_3d(phi)
    return (ax * (p[1:-1, 1:-1, 2:] + p[1:-1, 1:-1, :-2])
            + ay * (p[1:-1, 2:, 1:-1] + p[1:-1, :-2, 1:-1])
            + az * (p[2:, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1]))


def lap_neumann_3d(phi, dx: float, dy: float, dz: float):
    ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
    return _nb_sum(phi, ax, ay, az) - 2.0 * (ax + ay + az) * phi


def residual_3d(phi, rhs, dx: float, dy: float, dz: float):
    """max |∇²φ − rhs| over every node (a 0-dim tensor)."""
    return (lap_neumann_3d(phi, dx, dy, dz) - rhs).abs().amax()


def _parity_mask(shape) -> np.ndarray:
    nz, ny, nx = shape
    return np.add.outer(np.add.outer(np.arange(nz), np.arange(ny)), np.arange(nx)) % 2 == 0


def _sweep(phi, rhs, dx: float, dy: float, dz: float, colors, omega: float):
    """One red-black SOR sweep: each colour from the other's latest values."""
    ax, ay, az = 1.0 / dx**2, 1.0 / dy**2, 1.0 / dz**2
    denom_inv = 1.0 / (2.0 * (ax + ay + az))
    for color in colors:
        star = (_nb_sum(phi, ax, ay, az) - rhs) * denom_inv
        phi = torch.where(color, (1.0 - omega) * phi + omega * star, phi)
    return phi


def _restrict(r):
    nz, ny, nx = r.shape
    return r.reshape(nz // 2, 2, ny // 2, 2, nx // 2, 2).mean(dim=(1, 3, 5))


def _prolong_axis(e, axis: int):
    """Linear (¾, ¼) interpolation doubling ``axis``, the edge clamped; any
    length."""
    n = e.shape[axis]
    lo = torch.cat([e.narrow(axis, 0, 1), e.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([e.narrow(axis, 1, n - 1), e.narrow(axis, n - 1, 1)], axis)
    a = 0.75 * e + 0.25 * lo
    b = 0.75 * e + 0.25 * hi
    shape = list(e.shape)
    shape[axis] *= 2
    return torch.stack([a, b], axis + 1).reshape(shape)


def _prolong(e):
    return _prolong_axis(_prolong_axis(_prolong_axis(e, 0), 1), 2)


def _level_shapes(shape, min_size: int) -> list:
    """The multigrid hierarchy: halve while every side is even and the
    coarse level keeps ``min_size`` on its smallest side."""
    shapes = [tuple(shape)]
    nz, ny, nx = shape
    while nz % 2 == 0 and ny % 2 == 0 and nx % 2 == 0 and min(nz, ny, nx) // 2 >= min_size:
        nz, ny, nx = nz // 2, ny // 2, nx // 2
        shapes.append((nz, ny, nx))
    return shapes


def _inv_eigenvalues_3d(shape, dx: float, dy: float, dz: float, device) -> torch.Tensor:
    """1/λ of the clamped-edge 7-point Laplacian in the DCT-II basis, the
    constant mode zeroed; float32 arithmetic as the JAX package's traced
    code, in the cancellation-safe −4 sin²(πk/2n) form of 2cos(πk/n) − 2."""
    nz, ny, nx = shape

    def axis(n):
        s = torch.sin((np.pi / (2 * n)) * torch.arange(n, dtype=torch.float32, device=device))
        return -4.0 * s * s

    lam = (axis(nz)[:, None, None] / dz**2 + axis(ny)[None, :, None] / dy**2
           + axis(nx)[None, None, :] / dx**2)
    lam[0, 0, 0] = 1.0
    ilam = 1.0 / lam
    ilam[0, 0, 0] = 0.0
    return ilam


class Poisson3DSolver(nn.Module):
    """``solver(phi0, rhs) -> φ`` solving ∇²φ = rhs on a fixed (nz, ny, nx)
    shape; 1/λ, the twiddles and the red-black masks of every multigrid
    level are buffers on ``device``. ``phi0`` warm-starts the iterative
    methods (the DCT solve ignores it); neither input is written."""

    reads_host = False

    def __init__(self, shape, dx: float, dy: float, dz: float,
                 cfg: Poisson3DConfig = Poisson3DConfig(), *, device):
        super().__init__()
        if cfg.method not in METHODS_3D:
            raise ValueError(f"unknown 3D poisson method {cfg.method!r}")
        if cfg.dct_variant not in DCT_VARIANTS_3D:
            raise ValueError(f"unknown 3D dct_variant {cfg.dct_variant!r}; "
                             f"one of {DCT_VARIANTS_3D}")
        self.shape = tuple(shape)
        self.d = (dx, dy, dz)
        self.cfg = cfg
        if cfg.method == "dct":
            self.register_buffer("ilam", _inv_eigenvalues_3d(shape, dx, dy, dz, device))
            self.rfftn = cfg.dct_variant == "rfftn" and all(n % 2 == 0 for n in shape)
            if self.rfftn:
                for name, sign in (("fwd", -1), ("inv", +1)):
                    for i, w in enumerate(dct3d_twiddles(shape, sign, device)):
                        self.register_buffer(f"{name}{i}", w)
        else:
            shapes = _level_shapes(shape, cfg.mg_min_size) if cfg.method == "mg" else [shape]
            for level, s in enumerate(shapes):
                red = torch.as_tensor(_parity_mask(s), device=device)
                self.register_buffer(f"red{level}", red)
                self.register_buffer(f"black{level}", ~red)
            self.n_levels = len(shapes)

    def _colors(self, level: int):
        return (self.get_buffer(f"red{level}"), self.get_buffer(f"black{level}"))

    def _vcycle(self, phi, rhs, d, level: int):
        cfg = self.cfg
        dx, dy, dz = d
        colors = self._colors(level)
        for _ in range(cfg.mg_pre):
            phi = _sweep(phi, rhs, dx, dy, dz, colors, 1.0)
        if level == self.n_levels - 1:
            for _ in range(cfg.mg_coarse):
                phi = _sweep(phi, rhs, dx, dy, dz, colors, 1.0)
            return phi
        r = rhs - lap_neumann_3d(phi, dx, dy, dz)
        r_c = _restrict(r)
        e_c = self._vcycle(torch.zeros_like(r_c), r_c, (2 * dx, 2 * dy, 2 * dz), level + 1)
        phi = phi + _prolong(e_c)
        for _ in range(cfg.mg_post):
            phi = _sweep(phi, rhs, dx, dy, dz, colors, 1.0)
        return phi

    def forward(self, phi0, rhs):
        cfg = self.cfg
        if tuple(rhs.shape) != self.shape:
            raise ValueError(f"solver built for {self.shape}, rhs {tuple(rhs.shape)}")
        if cfg.method == "dct":
            if self.rfftn:
                w_fwd = (self.fwd0, self.fwd1, self.fwd2)
                w_inv = (self.inv0, self.inv1, self.inv2)
                return _idct3d_rfftn(_dct3d_rfftn(rhs, w_fwd), scale=self.ilam, w=w_inv)
            rhs_hat = _dct_fwd(_dct_fwd(_dct_fwd(rhs, 0), 1), 2)
            return _dct_inv(_dct_inv(_dct_inv(rhs_hat * self.ilam, 2), 1), 0)
        phi = phi0
        if cfg.method == "mg":
            for _ in range(cfg.iters):
                phi = self._vcycle(phi, rhs, self.d, 0)
            return phi
        dx, dy, dz = self.d
        for _ in range(cfg.iters):
            phi = _sweep(phi, rhs, dx, dy, dz, self._colors(0), cfg.omega)
        return phi


def solve_poisson_3d(phi0, rhs, dx: float, dy: float, dz: float,
                     cfg: Poisson3DConfig = Poisson3DConfig()):
    """Functional form: a :class:`Poisson3DSolver` built for this call on
    ``rhs``'s device (a step keeps its solver)."""
    return Poisson3DSolver(rhs.shape, dx, dy, dz, cfg, device=rhs.device)(phi0, rhs)
