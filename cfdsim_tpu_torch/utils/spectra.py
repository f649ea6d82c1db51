"""Shell-averaged kinetic-energy spectra E(k) of box flows
(``cfdsim_tpu.utils.spectra``).

|û|²/2 binned into integer-|k| shells, so the inertial range and the
dissipation at the grid cutoff show against k^(-5/3): one ``rfftn`` and a
scatter-add over a precomputed shell-id tensor. Σ E(k) equals the mean
kinetic energy ⟨|u|²⟩/2 (Parseval). The free-slip TGV box is handled by
even/odd mirror extension to the full period. Both functions assume an
isotropic box (per-axis integer mode indices share one physical
wavenumber per mode: a cubic or square domain).
"""

from __future__ import annotations

import numpy as np
import torch


def _mirror(f, parities):
    """Symmetry extension along each axis, [0, L] → [0, 2L) periodic:
    parity +1 even (a tangential velocity at a free-slip wall), −1 odd (the
    wall-normal velocity)."""
    for ax, s in enumerate(parities):
        f = torch.cat([f, s * torch.flip(f, dims=(ax,))], dim=ax)
    return f


def _fold_weights(n_last: int, n: int, device) -> torch.Tensor:
    """rfft's folded conjugate half: every plane but k = 0 (and the Nyquist
    plane of an even n) stands for two."""
    w = torch.full((n_last,), 2.0, device=device)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return w


def _shells(kmag: np.ndarray, e_density: torch.Tensor):
    """(k, E(k)) as numpy arrays: ``e_density`` summed into shells
    rint(|k|)."""
    shell = np.rint(kmag).astype(np.int64)
    n_shells = int(shell.max()) + 1
    ids = torch.from_numpy(shell.reshape(-1)).to(e_density.device)
    e_k = torch.zeros(n_shells, dtype=e_density.dtype, device=e_density.device)
    e_k.index_add_(0, ids, e_density.reshape(-1))
    return np.arange(n_shells), e_k.cpu().numpy()


def energy_spectrum_3d(uc, vc, wc, mirror: bool = False):
    """Shell-averaged 3D spectrum from cell-centred (nz, ny, nx) velocities:
    (k, E) numpy arrays, k = 0, 1, 2, … in units of the box fundamental.
    ``mirror=True`` extends each component of a symmetry-reduced free-slip
    box (the [0, π]³ TGV octant) with its parity first."""
    if mirror:
        # axes are (z, y, x): u normal to the x walls, v to y, w to z
        uc = _mirror(uc, (+1, +1, -1))
        vc = _mirror(vc, (+1, -1, +1))
        wc = _mirror(wc, (-1, +1, +1))
    nz, ny, nx = uc.shape
    w = _fold_weights(nx // 2 + 1, nx, uc.device)

    def ps(f):
        fh = torch.fft.rfftn(f) / (nx * ny * nz)
        return fh.abs() ** 2 * w[None, None, :]

    e_density = 0.5 * (ps(uc) + ps(vc) + ps(wc))
    kz = np.fft.fftfreq(nz) * nz
    ky = np.fft.fftfreq(ny) * ny
    kx = np.arange(nx // 2 + 1)
    kmag = np.sqrt(kz[:, None, None] ** 2 + ky[None, :, None] ** 2 + kx[None, None, :] ** 2)
    return _shells(kmag, e_density)


def energy_spectrum_2d(u, v):
    """Ring-averaged 2D spectrum from a periodic (ny, nx) velocity field,
    the Kolmogorov tiers' diagnostic: (k, E) numpy arrays."""
    ny, nx = u.shape
    w = _fold_weights(nx // 2 + 1, nx, u.device)

    def ps(f):
        fh = torch.fft.rfft2(f) / (nx * ny)
        return fh.abs() ** 2 * w[None, :]

    e_density = 0.5 * (ps(u) + ps(v))
    ky = np.fft.fftfreq(ny) * ny
    kx = np.arange(nx // 2 + 1)
    kmag = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    return _shells(kmag, e_density)
