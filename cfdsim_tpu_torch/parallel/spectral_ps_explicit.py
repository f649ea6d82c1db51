"""The pseudo-spectral vorticity step on rank blocks, every 2D FFT a pencil
pipeline (``cfdsim_tpu.parallel.spectral_ps_explicit``).

The distributed twin of ``models/spectral_ps.py``: each rank of the (py, px)
mesh holds its (ny/py, nx/px) block of the FULL complex vorticity spectrum
ω̂ (complex64), and every FFT2 runs as the classic pencil decomposition of
``parallel/transforms.py``: an all-to-all to full-x rows, the local 1D FFT,
back, an all-to-all to full-y columns, the local 1D FFT, back. The step
math is the single-device tier's (Strang half-decay around an SSP-RK3 step
of advection and forcing, 2/3 dealias on the nonlinear product).

Differences from the single-device tier, by construction (as in the JAX
package):

- the FULL spectrum (ny, nx) instead of the rfft half-spectrum: nx/2+1 is
  odd and cannot be cut into pencils; the conjugate half costs twice the
  spectral memory and flops and keeps every all-to-all even;
- the Kolmogorov forcing is added in real space, to the nonlinear product,
  before its forward FFT (its spectrum is the single-device f̂_ω).

Differences from the JAX step: the wavenumber, dealias, decay and forcing
tables of this rank's block are built once on the host from global indices
(float64 numpy, cast to float32, as the single-device tier builds its own),
not in the trace from ``lax.axis_index``; the spectrum stays complex64 (the
JAX step holds float32 re/im planes). An all-to-all moves the float32
pairs of ``torch.view_as_real``, the same bytes on any backend.
:func:`full_spectrum_state` and :func:`half_spectrum_state` convert to and
from the single-device state on the host.

Collectives per step: 15 FFT2s of four all-to-alls each (three RK stages
of four inverse and one forward transform), and, with metrics, one SUM and
one MAX ``all_reduce``. Layout: ny/py divisible by px
and nx/px by py (``_check_pencil``). An odd ``forcing_wavenumber`` raises,
as the single-device tier does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from cfdsim_tpu_torch.models.spectral_ps import (
    PSMetrics,
    PSState,
    PseudoSpectralConfig,
    _check,
)
from cfdsim_tpu_torch.parallel.explicit import step_device
from cfdsim_tpu_torch.parallel.mesh import GridMesh, block_slices
from cfdsim_tpu_torch.parallel.transforms import _check_pencil, fft2_pencil


def full_spectrum_state(cfg: PseudoSpectralConfig, state: PSState) -> PSState:
    """Host-side: the single-device rfft half-spectrum state → the full
    (ny, nx) complex64 spectrum of the distributed step (the hermitian half
    rebuilt through a real-space round trip, in float64 numpy)."""
    w = np.fft.irfft2(state.w_hat.detach().cpu().numpy(), s=(cfg.ny, cfg.nx))
    return _with_spectrum(state, np.fft.fft2(w))


def half_spectrum_state(cfg: PseudoSpectralConfig, state: PSState) -> PSState:
    """Host-side inverse of :func:`full_spectrum_state`."""
    w = np.real(np.fft.ifft2(state.w_hat.detach().cpu().numpy()))
    return _with_spectrum(state, np.fft.rfft2(w))


def _with_spectrum(state: PSState, wc: np.ndarray) -> PSState:
    w_hat = torch.from_numpy(wc.astype(np.complex64)).to(state.w_hat.device)
    return PSState(w_hat=w_hat, t=state.t, step=state.step)


def block_tables(cfg: PseudoSpectralConfig, mesh: GridMesh) -> dict:
    """This rank's (ny_l, nx_l) slices of the full-spectrum tables, float32
    numpy: angular KX, KY, 1/k² (0 at k = 0), the 2/3 dealias mask, and the
    real-space curl of the Kolmogorov force, f_ω = −fs·k_f π·cos(k_f π y),
    on this block's rows."""
    rows, cols = block_slices((cfg.ny, cfg.nx), mesh)
    mx = (np.fft.fftfreq(cfg.nx) * cfg.nx)[cols]
    my = (np.fft.fftfreq(cfg.ny) * cfg.ny)[rows]
    KX, KY = np.meshgrid((2.0 * np.pi / cfg.lx) * mx, (2.0 * np.pi / cfg.ly) * my)
    k2 = KX**2 + KY**2
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    dealias = (np.abs(mx)[None, :] <= cfg.nx / 3.0) & (np.abs(my)[:, None] <= cfg.ny / 3.0)
    kf = cfg.forcing_wavenumber * np.pi
    y = np.arange(cfg.ny)[rows] / cfg.ny
    f_real = (-cfg.forcing_scale * kf) * np.cos(kf * y)[:, None] * np.ones((1, len(mx)))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        KX=KX, KY=KY, inv_k2=inv_k2, dealias=dealias, f_real=f_real).items()}


class PSExplicitStep(nn.Module):
    """``step(state, cfl_scale) -> (state, PSMetrics)`` on this rank's block
    of the full spectrum (``cfl_scale`` is unused: dt is fixed)."""

    def __init__(self, cfg: PseudoSpectralConfig, mesh: GridMesh, device=None):
        super().__init__()
        _check(cfg)
        self.cfg, self.mesh = cfg, mesh
        self.device = step_device(mesh, device)
        self.reads_host, self.collectives = False, True
        _check_pencil((cfg.ny // mesh.py, cfg.nx // mesh.px), mesh.py, mesh.px)
        t = {k: torch.from_numpy(v).to(self.device) for k, v in block_tables(cfg, mesh).items()}
        # Strang splitting: the exact half-step decay exp(−λ dt/2), in float32
        lam = cfg.nu * (t["KX"] * t["KX"] + t["KY"] * t["KY"]) + cfg.linear_friction
        self.register_buffer("ehalf", torch.exp(-0.5 * lam * cfg.dt))
        self.register_buffer("ikx", 1j * t["KX"])
        self.register_buffer("iky", 1j * t["KY"])
        self.register_buffer("inv_k2", t["inv_k2"])
        self.register_buffer("dealias", t["dealias"])
        self.register_buffer("f_real", t["f_real"])
        self.register_buffer("dt", torch.tensor(cfg.dt, dtype=torch.float32, device=self.device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=self.device))

    def real_space(self, w_hat):
        """Re ifft2 of a block-layout full spectrum."""
        return fft2_pencil(w_hat, self.mesh, inverse=True).real

    def rhs(self, w_hat):
        """−dealias(u·∇ω − f_ω)̂ (the non-stiff part), and (u, v) on the block."""
        psi_hat = w_hat * self.inv_k2
        u = self.real_space(self.iky * psi_hat)
        v = self.real_space(-self.ikx * psi_hat)
        wx = self.real_space(self.ikx * w_hat)
        wy = self.real_space(self.iky * w_hat)
        rhs_real = -(u * wx + v * wy) + self.f_real
        return fft2_pencil(rhs_real.to(w_hat.dtype), self.mesh) * self.dealias, u, v

    def forward(self, state: PSState, cfl_scale=None):
        self.mesh.check(state.w_hat)
        dt = self.dt
        w = self.ehalf * state.w_hat
        # SSP-RK3 (Shu–Osher) on dω̂/dt = N(ω̂)
        n0, u, v = self.rhs(w)
        w1 = w + dt * n0
        n1, _, _ = self.rhs(w1)
        w2 = 0.75 * w + 0.25 * (w1 + dt * n1)
        n2, _, _ = self.rhs(w2)
        w_new = self.ehalf * (w / 3.0 + (2.0 / 3.0) * (w2 + dt * n2))
        new_state = PSState(w_hat=w_new, t=state.t + dt, step=state.step + 1)
        if not self.cfg.compute_metrics:
            z = self.zero
            return new_state, PSMetrics(dt=dt, max_vel=z, energy=z, enstrophy=z)
        n_tot = float(self.cfg.ny * self.cfg.nx)
        speed2 = u * u + v * v
        # enstrophy from the spectrum (Parseval: mean ω² = Σ|ω̂|²/N²)
        sums = torch.stack([speed2.sum(), (w.real * w.real + w.imag * w.imag).sum()])
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        max_vel = speed2.amax().sqrt()
        dist.all_reduce(max_vel, op=dist.ReduceOp.MAX)
        return new_state, PSMetrics(dt=dt, max_vel=max_vel, energy=0.5 * sums[0] / n_tot,
                                    enstrophy=0.5 * sums[1] / (n_tot * n_tot))


def make_ps_explicit_step(cfg: PseudoSpectralConfig, mesh: GridMesh,
                          device=None) -> PSExplicitStep:
    """The distributed step on ``mesh``'s device: its state is the block
    (``parallel.block_state``) of :func:`full_spectrum_state`."""
    return PSExplicitStep(cfg, mesh, device)
