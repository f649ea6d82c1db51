"""Distributed fast transforms on pencils (``cfdsim_tpu.parallel.transforms``).

The classic distributed-FFT layout over the (py, px) mesh: an all-to-all
within one mesh axis turns a (ny_l, nx_l) block into a pencil that holds
the *full* extent of one array axis (rows local, full x; or columns local,
full y), the 1D transform runs on the complete lines, and the inverse
all-to-all restores the block layout. The all-to-all is
``all_to_all_single`` in the axis' group: the tensor is cut along
``split_axis`` into n contiguous pieces, piece j goes to the group's rank
j, and what arrives is concatenated along ``concat_axis`` (``lax.all_to_all``
with ``tiled=True``; the identity when the axis has one shard). It goes
through ``torch.distributed.nn.functional``, so gradients flow through it.

- :func:`dct_poisson_local`, :func:`dct_poisson3d_local`: the exact
  clamped-edge (Neumann) Poisson solves of ``solvers/poisson.py`` and
  ``solvers/poisson3d.py`` made multi-rank (the 3D one keeps z local);
- :func:`make_fdm_poisson_local`, :func:`make_fdm_poisson3d_local`: the
  stretched grids' fast diagonalization of ``solvers/fdm.py`` (float32
  products with TF32 off, in its order, on its float64 1/λ);
- :func:`dst_helmholtz_local`: the Dirichlet implicit-viscous Helmholtz
  solve of ``solvers/helmholtz.py``;
- :class:`MacHelmholtzLocal`: the MAC components' implicit-viscous solve
  of ``solvers/helmholtz.py::MacHelmholtz`` on trimmed face blocks;
- :func:`fft2_pencil`: the complex FFT2 of the full spectrum in block
  layout (the pseudo-spectral, stable-fluids and periodic Poisson solves).

The 1D transforms are the single-device solvers' own (``_dct_fwd``,
``_dct_inv``, ``dst1``), cuFFT through ``torch.fft`` on the card. Layout:
ny_l divisible by px and nx_l by py (:func:`_check_pencil`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cfdsim_tpu_torch.parallel.halo import global_indices, halo_exchange_edges
from cfdsim_tpu_torch.parallel.mesh import GridMesh, _quiet
from cfdsim_tpu_torch.solvers.fdm import (
    _eig_similar_symmetric,
    full_fp32_matmul,
    neumann_operator_1d,
)
from cfdsim_tpu_torch.solvers.helmholtz import _axis_basis, dst1
from cfdsim_tpu_torch.solvers.poisson import _dct_fwd, _dct_inv


def _check_pencil(shape, py: int, px: int):
    ny_l, nx_l = shape
    if ny_l % max(px, 1) != 0 or nx_l % max(py, 1) != 0:
        raise ValueError(
            f"pencil decomposition needs local block {tuple(shape)} with rows "
            f"divisible by px={px} and cols divisible by py={py}"
        )


def _check_pencil3d(shape, py: int, px: int):
    if shape[1] % max(px, 1) != 0 or shape[2] % max(py, 1) != 0:
        raise ValueError(
            f"3D pencil decomposition needs block {tuple(shape)} with y "
            f"divisible by px={px} and x divisible by py={py}"
        )


def _a2a(t, mesh: GridMesh, axis_name: str, split: int, concat: int):
    """Tiled all-to-all along the mesh axis (identity when it has one shard)."""
    n = mesh.axis_size(axis_name)
    if n == 1:
        return t
    from torch.distributed.nn.functional import all_to_all_single

    mesh.check(t)
    send = torch.stack(t.chunk(n, split), 0).contiguous()
    recv = _quiet(all_to_all_single, torch.empty_like(send), send,
                  group=mesh.group(axis_name))
    return torch.cat(recv.unbind(0), concat)


def to_x_pencil(block, mesh: GridMesh):
    """Block (ny_l, nx_l) → x-pencil (ny_l/px, nx_g): each rank of a mesh
    row keeps a slice of its rows and gains the full global x extent."""
    return _a2a(block, mesh, "x", 0, 1)


def from_x_pencil(pencil, mesh: GridMesh):
    return _a2a(pencil, mesh, "x", 1, 0)


def to_y_pencil(block, mesh: GridMesh):
    """Block (ny_l, nx_l) → y-pencil (ny_g, nx_l/py)."""
    return _a2a(block, mesh, "y", 1, 0)


def from_y_pencil(pencil, mesh: GridMesh):
    return _a2a(pencil, mesh, "y", 0, 1)


def _a2a_complex(pencil_fn, z, mesh: GridMesh):
    """One pencil all-to-all of a complex64 block, moved as its float32
    (re, im) pairs."""
    return torch.view_as_complex(pencil_fn(torch.view_as_real(z), mesh).contiguous())


def fft2_pencil(z, mesh: GridMesh, inverse: bool = False):
    """The distributed complex FFT2 (``torch.fft.fft2``, or ``ifft2`` with
    its 1/N) of the global array, in block layout: x on full-x rows, then y
    on full-y columns."""
    fft = torch.fft.ifft if inverse else torch.fft.fft
    z = _a2a_complex(to_x_pencil, z, mesh)
    z = _a2a_complex(from_x_pencil, fft(z, dim=1), mesh)
    z = _a2a_complex(to_y_pencil, z, mesh)
    return _a2a_complex(from_y_pencil, fft(z, dim=0), mesh)


def dct2_local(block, mesh: GridMesh):
    """Distributed 2D DCT-II of the global array, in block layout (entry
    (j, i) = spectral coefficient (gy0+j, gx0+i))."""
    _check_pencil(block.shape, mesh.py, mesh.px)
    t = to_x_pencil(block, mesh)
    t = _dct_fwd(t, axis=1)
    t = from_x_pencil(t, mesh)
    t = to_y_pencil(t, mesh)
    t = _dct_fwd(t, axis=0)
    return from_y_pencil(t, mesh)


def idct2_local(block, mesh: GridMesh):
    _check_pencil(block.shape, mesh.py, mesh.px)
    t = to_y_pencil(block, mesh)
    t = _dct_inv(t, axis=0)
    t = from_y_pencil(t, mesh)
    t = to_x_pencil(t, mesh)
    t = _dct_inv(t, axis=1)
    return from_x_pencil(t, mesh)


def _pencil_kx(local_shape, mesh: GridMesh) -> torch.Tensor:
    """Global x spectral indices of this rank's y-pencil columns: the pencil
    holds columns ix·nx_l + iy·q … + q − 1, q = nx_l/py."""
    nx_l = local_shape[1]
    q = nx_l // max(mesh.py, 1)
    start = mesh.ix * nx_l + mesh.iy * q
    return torch.arange(start, start + q, dtype=torch.int32, device=mesh.device)


def dct_inv_eigenvalues_local(local_shape, dx: float, dy: float, mesh: GridMesh):
    """1/λ of the clamped-edge Laplacian on this rank's y-pencil (ny_g,
    nx_l/py), 0 for the constant mode, in the float32 −4sin² form of the
    JAX package (cancellation-safe at low modes). A step builds it once."""
    ny_l, nx_l = local_shape
    ny_g, nx_g = ny_l * mesh.py, nx_l * mesh.px
    q = nx_l // max(mesh.py, 1)
    ky = torch.arange(ny_g, dtype=torch.int32, device=mesh.device)[:, None].expand(ny_g, q)
    kx = _pencil_kx(local_shape, mesh)[None, :].expand(ny_g, q)
    sy = torch.sin((np.pi / (2 * ny_g)) * ky.to(torch.float32))
    sx = torch.sin((np.pi / (2 * nx_g)) * kx.to(torch.float32))
    lam = (-4.0 / (dy * dy)) * sy * sy + (-4.0 / (dx * dx)) * sx * sx
    zero_mode = (ky == 0) & (kx == 0)
    return torch.where(zero_mode, 0.0, 1.0 / torch.where(zero_mode, 1.0, lam))


def dct_poisson_local(rhs_b, dx: float, dy: float, mesh: GridMesh, ilam=None):
    """Exact distributed solve of the clamped-edge (Neumann) FD Poisson
    problem ∇²φ = rhs on this rank's block (``solve_poisson_neumann_dct``
    made multi-rank, the MAC projection's exact operator). Six all-to-alls:
    the eigenvalue division happens in the y-pencil layout between the
    forward and inverse y-transforms. ``ilam`` is
    :func:`dct_inv_eigenvalues_local`, built here when not given."""
    _check_pencil(rhs_b.shape, mesh.py, mesh.px)
    if ilam is None:
        ilam = dct_inv_eigenvalues_local(tuple(rhs_b.shape), dx, dy, mesh)
    t = to_x_pencil(rhs_b, mesh)
    t = _dct_fwd(t, axis=1)
    t = from_x_pencil(t, mesh)
    t = to_y_pencil(t, mesh)
    t = _dct_fwd(t, axis=0)
    t = t * ilam
    t = _dct_inv(t, axis=0)
    t = from_y_pencil(t, mesh)
    t = to_x_pencil(t, mesh)
    t = _dct_inv(t, axis=1)
    return from_x_pencil(t, mesh).to(rhs_b.dtype)


def dct_poisson3d_local(rhs_b, dx: float, dy: float, dz: float, mesh: GridMesh):
    """Exact distributed 3D clamped-edge (Neumann) Poisson solve on
    (nz, ny_l, nx_l) blocks: z stays local (the cavity3d layout), x and y
    ride the pencil all-to-alls of the 2D solve."""
    _check_pencil3d(rhs_b.shape, mesh.py, mesh.px)
    nz, ny_l, nx_l = rhs_b.shape
    ny_g, nx_g = ny_l * mesh.py, nx_l * mesh.px
    t = _dct_fwd(rhs_b, axis=0)  # z: local
    t = _a2a(t, mesh, "x", 1, 2)  # x-pencil (nz, ny_l/px, nx_g)
    t = _dct_fwd(t, axis=2)
    t = _a2a(t, mesh, "x", 2, 1)
    t = _a2a(t, mesh, "y", 2, 1)  # y-pencil (nz, ny_g, nx_l/py)
    t = _dct_fwd(t, axis=1)
    kz = torch.arange(nz, dtype=torch.int32, device=mesh.device)[:, None, None]
    ky = torch.arange(ny_g, dtype=torch.int32, device=mesh.device)[None, :, None]
    kx = _pencil_kx((ny_l, nx_l), mesh)[None, None, :]
    kz, ky, kx = torch.broadcast_tensors(kz, ky, kx)
    sz = torch.sin((np.pi / (2 * nz)) * kz.to(torch.float32))
    sy = torch.sin((np.pi / (2 * ny_g)) * ky.to(torch.float32))
    sx = torch.sin((np.pi / (2 * nx_g)) * kx.to(torch.float32))
    lam = ((-4.0 / (dz * dz)) * sz * sz + (-4.0 / (dy * dy)) * sy * sy
           + (-4.0 / (dx * dx)) * sx * sx)
    zero_mode = (kz == 0) & (ky == 0) & (kx == 0)
    t = t * torch.where(zero_mode, 0.0, 1.0 / torch.where(zero_mode, 1.0, lam))
    t = _dct_inv(t, axis=1)
    t = _a2a(t, mesh, "y", 1, 2)
    t = _a2a(t, mesh, "x", 1, 2)
    t = _dct_inv(t, axis=2)
    t = _a2a(t, mesh, "x", 2, 1)
    return _dct_inv(t, axis=0).to(rhs_b.dtype)


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _x_pencil_rows(local_shape, mesh: GridMesh) -> slice:
    """Global y indices of this rank's x-pencil rows: the pencil holds rows
    iy·ny_l + ix·r … + r − 1, r = ny_l/px."""
    r = local_shape[0] // max(mesh.px, 1)
    start = mesh.iy * local_shape[0] + mesh.ix * r
    return slice(start, start + r)


def _inv_lam(lam: np.ndarray, nullspace_tol: float) -> np.ndarray:
    """1/λ of the Neumann eigenvalues, 0 on the constant mode: the
    single-device solver's float64 table (``solvers/fdm.py``)."""
    scale = max(np.abs(lam).max(), 1.0)
    with np.errstate(divide="ignore"):
        return np.where(np.abs(lam) < nullspace_tol * scale, 0.0, 1.0 / lam)


def make_fdm_poisson_local(hx, hy, mesh: GridMesh, nullspace_tol: float = 1e-10):
    """Distributed fast-diagonalization Poisson solve for *stretched* grids
    (``solvers/fdm.py`` made multi-rank): returns ``solve(rhs_b)`` for
    blocks of ``mesh``'s layout. The dense eigenbasis products run on
    locally complete pencil axes in the single-device solver's order (y,
    x, then back y, x: eight all-to-alls), and the spectral division reads
    this rank's slice of its float64 1/λ table, so at world size 1 the
    solve is the single-device one."""
    hx = np.asarray(hx, np.float64)
    hy = np.asarray(hy, np.float64)
    lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
    ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
    inv_lam = _inv_lam(ly[:, None] + lx[None, :], nullspace_tol)
    local_shape = (len(hy) // mesh.py, len(hx) // mesh.px)
    _check_pencil(local_shape, mesh.py, mesh.px)
    dev = mesh.device
    VxT, VxiT, Vy_c, Vyi_c = (_f32(a, dev) for a in (Vx.T, Vxi.T, Vy, Vyi))
    inv_lam_c = _f32(inv_lam[_x_pencil_rows(local_shape, mesh)], dev)  # the x-pencil's rows

    def solve(rhs_b):
        _check_pencil(rhs_b.shape, mesh.py, mesh.px)
        with full_fp32_matmul():
            t = from_y_pencil(Vyi_c @ to_y_pencil(rhs_b, mesh), mesh)
            t = to_x_pencil(t, mesh) @ VxiT
            t = from_x_pencil(t * inv_lam_c, mesh)
            t = from_y_pencil(Vy_c @ to_y_pencil(t, mesh), mesh)
            return from_x_pencil(to_x_pencil(t, mesh) @ VxT, mesh).to(rhs_b.dtype)

    return solve


def make_fdm_poisson3d_local(hx, hy, hz, mesh: GridMesh, nullspace_tol: float = 1e-10):
    """Distributed 3D fast-diagonalization Neumann Poisson solve for
    stretched grids on (nz, ny_l, nx_l) blocks (``make_fdm_solver_3d`` made
    multi-rank): the products in the single-device solver's order (x, y,
    z, then back z, y, x), x and y on pencils, z local, the division on
    this rank's slice of its float64 1/λ table (six all-to-alls)."""
    hx, hy, hz = (np.asarray(a, np.float64) for a in (hx, hy, hz))
    lx, Vx, Vxi = _eig_similar_symmetric(neumann_operator_1d(hx), hx)
    ly, Vy, Vyi = _eig_similar_symmetric(neumann_operator_1d(hy), hy)
    lz, Vz, Vzi = _eig_similar_symmetric(neumann_operator_1d(hz), hz)
    inv_lam = _inv_lam(lz[:, None, None] + ly[None, :, None] + lx[None, None, :], nullspace_tol)
    ny_l, nx_l = len(hy) // mesh.py, len(hx) // mesh.px
    _check_pencil3d((len(hz), ny_l, nx_l), mesh.py, mesh.px)
    q = nx_l // max(mesh.py, 1)
    start = mesh.ix * nx_l + mesh.iy * q
    dev = mesh.device
    VxT, VxiT, Vy_c, Vyi_c, Vz_c, Vzi_c = (_f32(a, dev) for a in (Vx.T, Vxi.T, Vy, Vyi, Vz,
                                                                    Vzi))
    inv_lam_c = _f32(inv_lam[:, :, start:start + q], dev)  # the y-pencil's columns

    def solve(rhs_b):
        _check_pencil3d(rhs_b.shape, mesh.py, mesh.px)
        with full_fp32_matmul():
            t = _a2a(rhs_b, mesh, "x", 1, 2) @ VxiT  # x (pencil)
            t = _a2a(_a2a(t, mesh, "x", 2, 1), mesh, "y", 2, 1)
            t = torch.einsum("ab,zbx->zax", Vyi_c, t)  # y (pencil)
            t = torch.einsum("ab,byx->ayx", Vzi_c, t)  # z (local)
            t = torch.einsum("ab,byx->ayx", Vz_c, t * inv_lam_c)
            t = torch.einsum("ab,zbx->zax", Vy_c, t)
            t = _a2a(_a2a(t, mesh, "y", 1, 2), mesh, "x", 1, 2) @ VxT
            return _a2a(t, mesh, "x", 2, 1).to(rhs_b.dtype)

    return solve


def dst_helmholtz_local(b_b, coeff, dx: float, dy: float, mesh: GridMesh):
    """Exact distributed solve of (I − coeff·∇²) u = b with the one-node
    Dirichlet boundary frame of ``b`` preserved (the distributed
    counterpart of ``solve_helmholtz_dirichlet``). ``coeff`` is a number or
    a 0-dim tensor (dt·ν).

    The interior (ny−2, nx−2) system is DST-I-diagonal; the interior
    lengths are odd, so they cannot be pencil-split. The full even-sized
    array rides the all-to-alls instead, and each 1D DST-I runs on the
    locally complete axis' 1:-1 interior, re-embedded in the full-size
    frame (frame lines zero) for the next leg."""
    _check_pencil(b_b.shape, mesh.py, mesh.px)
    ny_l, nx_l = b_b.shape
    ny_g, nx_g = ny_l * mesh.py, nx_l * mesh.px
    axc = 1.0 / (dx * dx)
    ayc = 1.0 / (dy * dy)

    # fold the known Dirichlet boundary values into the rhs in block layout,
    # where a width-1 halo makes the boundary-adjacent lines local
    p = halo_exchange_edges(b_b, mesh, 1)  # zero halos at the global edges
    rows, cols = global_indices((ny_l, nx_l), mesh)
    interior = (rows >= 1) & (rows < ny_g - 1) & (cols >= 1) & (cols < nx_g - 1)
    r = b_b
    r = r + coeff * axc * torch.where(cols == 1, p[1:-1, :-2], 0.0)
    r = r + coeff * axc * torch.where(cols == nx_g - 2, p[1:-1, 2:], 0.0)
    r = r + coeff * ayc * torch.where(rows == 1, p[:-2, 1:-1], 0.0)
    r = r + coeff * ayc * torch.where(rows == ny_g - 2, p[2:, 1:-1], 0.0)
    r = torch.where(interior, r, 0.0)

    def dstx(t):
        return F.pad(dst1(t[:, 1:-1], axis=1), (1, 1))

    def dsty(t):
        return F.pad(dst1(t[1:-1, :], axis=0), (0, 0, 1, 1))

    t = to_x_pencil(r, mesh)  # forward x on complete rows
    t = dstx(t)
    t = from_x_pencil(t, mesh)
    t = to_y_pencil(t, mesh)  # forward y on complete columns → y-pencil
    t = dsty(t)

    # spectral division at global (ky, kx): the embedded index is the
    # position − 1; the frame lines (positions 0, n−1) carry zeros
    my, mx = ny_g - 2, nx_g - 2
    ky = torch.arange(ny_g, dtype=torch.float32, device=mesh.device)[:, None]
    kx = _pencil_kx((ny_l, nx_l), mesh).to(torch.float32)[None, :]
    denom = 1.0 + coeff * (
        2.0 * (axc + ayc)
        - axc * 2.0 * torch.cos(np.pi * kx / (mx + 1))
        - ayc * 2.0 * torch.cos(np.pi * ky / (my + 1))
    )
    # the DST-I is self-inverse up to 2/(m+1) per axis
    scale = (2.0 / (my + 1)) * (2.0 / (mx + 1))
    t = t * (scale / denom)

    t = dsty(t)  # inverse y, back to blocks
    t = from_y_pencil(t, mesh)
    t = to_x_pencil(t, mesh)  # inverse x
    t = dstx(t)
    t = from_x_pencil(t, mesh)
    return torch.where(interior, t.to(b_b.dtype), b_b)


class MacHelmholtzLocal(nn.Module):
    """The exact MAC-component Helmholtz solve (I − c·∇²) q = b of
    ``solvers/helmholtz.py::MacHelmholtz`` on this rank's block of a
    *trimmed* face array (ny, nx): ``kinds`` = (kind_y, kind_x) of
    ``_axis_basis``, exactly one of them "dst1", the component's own
    (normal) axis, whose unknowns are the interior faces 1 … n − 1 of the
    trimmed axis (its line 0 is the boundary face).

    The n − 1 interior faces cannot be pencil-split, but a pencil holds the
    whole axis: each 1D transform of the normal axis runs on lines 1 … n − 1
    of the complete axis and leaves line 0 at zero, which the division
    carries with a denominator of 1, decoupled from the interior. Forward y
    (y-pencil), forward x (x-pencil), the division by 1 − c·λ in the
    x-pencil, inverse x, inverse y: six all-to-alls. ``forward(b_b, c)``
    takes the right-hand side's block (its boundary line is ignored) and
    ``c`` a number or a 0-dim device tensor; its boundary line comes back
    zero."""

    def __init__(self, shape, kinds, dx: float, dy: float, mesh: GridMesh):
        super().__init__()
        ny, nx = shape
        if (kinds[0] == "dst1") == (kinds[1] == "dst1"):
            raise ValueError(f"one axis of a MAC component is its normal (dst1) axis: {kinds}")
        self.mesh = mesh
        self.local_shape = (ny // mesh.py, nx // mesh.px)
        _check_pencil(self.local_shape, mesh.py, mesh.px)
        self.normal = 0 if kinds[0] == "dst1" else 1
        fy, iy, lam_y = _axis_basis(kinds[0], ny - 1 if self.normal == 0 else ny, dy)
        fx, ix, lam_x = _axis_basis(kinds[1], nx - 1 if self.normal == 1 else nx, dx)
        self.fwd, self.inv = (fy, fx), (iy, ix)
        # the table on the whole trimmed array, the boundary line's λ 0
        if self.normal == 0:
            lam_y = np.concatenate([[0.0], lam_y])
        else:
            lam_x = np.concatenate([[0.0], lam_x])
        lam = lam_y[:, None] + lam_x[None, :]
        if self.normal == 0:
            lam[0, :] = 0.0
        else:
            lam[:, 0] = 0.0
        self.register_buffer("lam", torch.from_numpy(np.ascontiguousarray(
            lam[_x_pencil_rows(self.local_shape, mesh)]).astype(np.float32)).to(mesh.device))

    def _along(self, fn, t, axis: int):
        """``fn`` along ``axis``; on the normal axis, on lines 1 … n − 1 with
        line 0 zero."""
        if axis != self.normal:
            return fn(t, axis)
        inner = fn(t.narrow(axis, 1, t.shape[axis] - 1), axis)
        return torch.cat([torch.zeros_like(t.narrow(axis, 0, 1)), inner], axis)

    def forward(self, b_b, c):
        mesh = self.mesh
        if tuple(b_b.shape) != self.local_shape:
            raise ValueError(f"solver built for blocks {self.local_shape}, got "
                             f"{tuple(b_b.shape)}")
        t = from_y_pencil(self._along(self.fwd[0], to_y_pencil(b_b, mesh), 0), mesh)
        t = self._along(self.fwd[1], to_x_pencil(t, mesh), 1)
        t = self._along(self.inv[1], t / (1.0 - c * self.lam), 1)
        t = from_y_pencil(self._along(self.inv[0], to_y_pencil(from_x_pencil(t, mesh), mesh),
                                      0), mesh)
        return t.to(b_b.dtype)
