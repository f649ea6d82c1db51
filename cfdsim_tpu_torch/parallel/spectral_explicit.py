"""The periodic stable-fluids (Kolmogorov) step on rank blocks
(``models/spectral.py`` made multi-rank; the JAX package runs this tier on
a mesh only through GSPMD).

Each rank holds its (ny/py, nx/px) blocks of u and v. Per step, as the
single-device step:

1. the body force on the block;
2. the semi-Lagrangian trace (``"sl"``, or BFECC with its clamp): the
   departure point of each of the block's grid points is dt·u away, and
   with the tier's fixed dt = 0.01 that is dt·u·ny cells (3.6 cells per
   unit speed at ny = 360), growing with the flow and unbounded by any CFL
   rule. So the traced fields and the velocities are all-gathered before
   each trace (one ``all_gather`` of the stacked pair; BFECC gathers its
   forward pass once more), every rank holds them whole and samples them
   at its own block's departure points with the single-device bilinear
   wrap (``spectral.bilinear_wrap``): no departure point can miss, and
   each sample is the single-device one. The 3×3 pools of the BFECC clamp
   run on the gathered fields;
3. the means subtracted (one SUM ``all_reduce`` for the pair);
4. the spectral decay and the pseudo-pressure projection on the FULL
   complex spectrum through the pencil FFT2 of ``spectral_ps_explicit``
   (the rfft half spectrum's nx/2 + 1 columns cannot be cut into pencils),
   with this rank's block of the full-spectrum tables (:func:`block_tables`:
   the single-device rfft-grid tables, each negative-kx mode given its
   mirror's, so the result stays Hermitian); the real part of the inverse;
5. the means again.

The metrics are one MAX (max speed and the spectral divergence) and one
SUM (the energy). ``cfl_scale`` is unused: dt is fixed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.models.spectral import (
    SpectralConfig,
    SpectralMetrics,
    SpectralState,
    _pool,
    _wavenumbers,
    bilinear_wrap,
)
from cfdsim_tpu_torch.parallel.explicit import step_device
from cfdsim_tpu_torch.parallel.mesh import GridMesh, block_slices, gather_blocks, pmax, psum
from cfdsim_tpu_torch.parallel.spectral_ps_explicit import fft2_pencil
from cfdsim_tpu_torch.parallel.transforms import _check_pencil


def block_tables(cfg: SpectralConfig, mesh: GridMesh) -> dict:
    """This rank's (ny_l, nx_l) slices of the full-spectrum tables:
    ``spectral._wavenumbers``' rfft-grid tables (cycles per unit length, the
    unit k̂, the decay; float32) on the columns kx = 0 … nx/2 (the Nyquist
    column at +nx/2, as rfftfreq has it), and on the others the table of
    the mirror mode (−ky, −kx), the one the rfft half spectrum holds. A
    real field's spectrum is Hermitian, so the projection then keeps it
    Hermitian and the real part of the inverse is the single-device
    irfft2, Nyquist lines included."""
    half = _wavenumbers(cfg)
    ny, nx = cfg.ny, cfg.nx
    rows, cols = block_slices((ny, nx), mesh)
    j = np.arange(nx)[cols]
    i = np.arange(ny)[rows]
    mirrored = j > nx // 2
    src_j = np.where(mirrored, nx - j, j)
    src_i = np.where(mirrored[None, :], (-i[:, None]) % ny, i[:, None])
    return {k: t[src_i, src_j[None, :]] for k, t in half.items()}


class SpectralExplicitStep(nn.Module):
    """``step(state_b, cfl_scale) -> (state_b, SpectralMetrics)`` on this
    rank's blocks; see the module docstring."""

    reads_host = False
    collectives = True

    def __init__(self, cfg: SpectralConfig, mesh: GridMesh, *, device=None):
        super().__init__()
        if cfg.advection not in ("sl", "bfecc"):
            raise ValueError(f"unknown advection {cfg.advection!r}")
        self.cfg, self.mesh = cfg, mesh
        self.device = step_device(mesh, device)
        rows, cols = block_slices((cfg.ny, cfg.nx), mesh)
        self.local_shape = (rows.stop - rows.start, cols.stop - cols.start)
        _check_pencil(self.local_shape, mesh.py, mesh.px)
        self.n_global = float(cfg.ny * cfg.nx)
        dev = self.device
        for name, table in block_tables(cfg, mesh).items():
            self.register_buffer(name, torch.from_numpy(table).to(dev))
        y = np.arange(cfg.ny) / cfg.ny
        force_x = (cfg.forcing_scale * np.sin(cfg.forcing_wavenumber * np.pi * y)[:, None]
                   * np.ones((1, cfg.nx)))[rows, cols]
        self.register_buffer("force_x", torch.from_numpy(force_x.astype(np.float32)).to(dev))
        # this block's grid-index coordinates (global), broadcast in the trace
        self.register_buffer("iy", torch.arange(rows.start, rows.stop, dtype=torch.float32,
                                                device=dev)[:, None])
        self.register_buffer("ix", torch.arange(cols.start, cols.stop, dtype=torch.float32,
                                                device=dev)[None, :])
        self.register_buffer("dt", torch.tensor(cfg.dt, dtype=torch.float32, device=dev))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=dev))

    def _gather(self, *blocks):
        return gather_blocks(torch.stack(blocks), self.mesh).unbind(0)

    def _block(self, full):
        rows, cols = block_slices(tuple(full.shape), self.mesh)
        return full[rows, cols]

    def _trace(self, field_full, u_b, v_b, dt: float):
        """``advect_sl`` at this block's points, sampling the whole field."""
        cfg = self.cfg
        x_back = self.ix - dt * u_b * (cfg.nx / cfg.lx)
        y_back = self.iy - dt * v_b * (cfg.ny / cfg.ly)
        return bilinear_wrap(field_full, y_back, x_back)

    def _advect(self, fields_full, u_b, v_b, dt: float):
        """The block of each whole field advected by the whole velocity."""
        if self.cfg.advection == "sl":
            return [self._trace(f, u_b, v_b, dt) for f in fields_full]
        fwd = [self._trace(f, u_b, v_b, dt) for f in fields_full]
        fwd_full = self._gather(*fwd)
        out = []
        for f, fb, ff in zip(fields_full, fwd, fwd_full):
            bwd = self._trace(ff, u_b, v_b, -dt)
            o = fb + 0.5 * (self._block(f) - bwd)
            lo = self._trace(_pool(f, torch.minimum), u_b, v_b, dt)
            hi = self._trace(_pool(f, torch.maximum), u_b, v_b, dt)
            out.append(torch.minimum(torch.maximum(o, lo), hi))
        return out

    def forward(self, state: SpectralState, cfl_scale=None):
        cfg, mesh = self.cfg, self.mesh
        if state.u.device != self.device:
            raise ValueError(f"step built for {self.device}, state on {state.u.device}")
        dt = cfg.dt
        u = state.u + self.force_x
        v = state.v
        u_full, v_full = self._gather(u, v)
        u_adv, v_adv = self._advect((u_full, v_full), u, v, dt)
        means = psum(torch.stack([u_adv.sum(), v_adv.sum()]), mesh) / self.n_global
        u_adv = u_adv - means[0]
        v_adv = v_adv - means[1]
        u_hat = fft2_pencil(u_adv.to(torch.complex64), mesh) * self.decay
        v_hat = fft2_pencil(v_adv.to(torch.complex64), mesh) * self.decay
        p_hat = u_hat * self.kx_hat + v_hat * self.ky_hat
        u_hat = u_hat - p_hat * self.kx_hat
        v_hat = v_hat - p_hat * self.ky_hat
        u_new = fft2_pencil(u_hat, mesh, inverse=True).real.contiguous()
        v_new = fft2_pencil(v_hat, mesh, inverse=True).real.contiguous()
        means = psum(torch.stack([u_new.sum(), v_new.sum()]), mesh) / self.n_global
        u_new = u_new - means[0]
        v_new = v_new - means[1]
        new_state = SpectralState(u=u_new, v=v_new, t=state.t + dt, step=state.step + 1)
        if not cfg.compute_metrics:
            z = self.zero
            return new_state, SpectralMetrics(z, z, z, z)
        div_hat = u_hat * self.KX + v_hat * self.KY
        maxima = pmax(torch.stack([torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
                                   div_hat.abs().amax()]), mesh)
        energy = psum((0.5 * (u_new * u_new + v_new * v_new)).sum(), mesh) / self.n_global
        return new_state, SpectralMetrics(dt=self.dt, max_vel=maxima[0], energy=energy,
                                          max_div=maxima[1] / (cfg.nx * cfg.ny))


def make_spectral_explicit_step(cfg: SpectralConfig, mesh: GridMesh, *,
                                device=None) -> SpectralExplicitStep:
    """The explicit-communication stable-fluids step (``cases.py::
    kolmogorov``) on this rank's blocks."""
    return SpectralExplicitStep(cfg, mesh, device=device)
