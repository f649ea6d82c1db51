"""Pseudo-spectral 2D vorticity solver, dealiased, with an integrating
factor (``cfdsim_tpu.models.spectral_ps``).

The same periodic Kolmogorov-flow problem as ``models/spectral.py``, in
vorticity form

    ω_t + u·∇ω = ν ∇²ω − α ω + f_ω,   ∇²ψ = −ω,  u = ∂_y ψ, v = −∂_x ψ

with the nonlinear term evaluated in real space on a 2/3-dealiased grid,
Strang splitting (the viscous and friction decay exp(−(νk²+α)dt/2) exact
on each side of an SSP-RK3 step of the advection and forcing). The
Kolmogorov force fs·sin(k_f π y) x̂ enters as its curl f_ω = −fs·k_f π·
cos(k_f π y), per unit time.

The state is the vorticity spectrum ω̂ on the rfft2 grid as one complex64
tensor (ny, nx//2+1) (the JAX package stores float32 re/im planes, a
relay workaround; snapshots keep that schema, see ``io_/hdf5.py::to_host``).
The precisions follow the JAX package: the wavenumber tables are float64
numpy cast to float32, λ and exp(−λ dt/2) are computed in float32 from the
float32 tables, f̂_ω is a float64 numpy rfft2 cast to float32 planes. An
odd ``forcing_wavenumber`` raises ``ValueError``: sin(k_f π y) is then not
periodic on the unit box (the JAX package accepts it silently). The step
reads nothing on the host and captures into one CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class PSState(NamedTuple):
    w_hat: torch.Tensor  # complex64 (ny, nx//2+1)
    t: torch.Tensor
    step: torch.Tensor


class PSMetrics(NamedTuple):
    dt: torch.Tensor
    max_vel: torch.Tensor
    energy: torch.Tensor
    enstrophy: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PseudoSpectralConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    ny: int = 512
    aspect: float = 1.0
    nu: float = 1e-5
    dt: float = 2e-3
    forcing_wavenumber: int = 8  # sin(k_f π y), k_f/2 cycles per box
    forcing_scale: float = 0.1  # force per unit TIME (not per step)
    linear_friction: float = 0.0
    compute_metrics: bool = True

    @property
    def nx(self) -> int:
        return int(self.ny * self.aspect)

    @property
    def lx(self) -> float:
        return self.nx / self.ny

    @property
    def ly(self) -> float:
        return 1.0


def _wavenumbers(cfg: PseudoSpectralConfig):
    """Float32 numpy tables on the rfft2 layout: angular KX, KY, the
    inverse Laplacian 1/k² (0 at k = 0, the zero-mean gauge) and the 2/3
    dealias mask."""
    kx = 2.0 * np.pi * np.fft.rfftfreq(cfg.nx) * cfg.nx / cfg.lx
    ky = 2.0 * np.pi * np.fft.fftfreq(cfg.ny) * cfg.ny / cfg.ly
    KX, KY = np.meshgrid(kx, ky)
    k2 = KX**2 + KY**2
    inv_k2 = np.where(k2 == 0.0, 0.0, 1.0 / np.where(k2 == 0.0, 1.0, k2))
    mx = np.abs(np.fft.rfftfreq(cfg.nx) * cfg.nx)
    my = np.abs(np.fft.fftfreq(cfg.ny) * cfg.ny)
    dealias = (mx[None, :] <= cfg.nx / 3.0) & (my[:, None] <= cfg.ny / 3.0)
    return (KX.astype(np.float32), KY.astype(np.float32), inv_k2.astype(np.float32),
            dealias.astype(np.float32))


def _check(cfg: PseudoSpectralConfig):
    if cfg.forcing_wavenumber % 2:
        raise ValueError(f"forcing_wavenumber {cfg.forcing_wavenumber} is odd: sin(k_f·π·y) "
                         "is not periodic on the unit-height box")


def init_state(cfg: PseudoSpectralConfig, w0=None, seed: int = 0, noise: float = 0.0, *,
               device) -> PSState:
    """Rest (plus optional white-noise vorticity from ``default_rng(seed)``
    to seed the Kolmogorov instability), transformed and dealiased on the
    host in numpy as the JAX package does, on ``device``."""
    _check(cfg)
    shape = (cfg.ny, cfg.nx)
    w = np.zeros(shape, np.float32) if w0 is None else np.asarray(w0, np.float32)
    if noise > 0.0:
        rng = np.random.default_rng(seed)
        w = w + noise * rng.standard_normal(shape).astype(np.float32)
    kx_keep = np.abs(np.fft.rfftfreq(cfg.nx) * cfg.nx) <= cfg.nx / 3.0
    ky_keep = np.abs(np.fft.fftfreq(cfg.ny) * cfg.ny) <= cfg.ny / 3.0
    wc = np.fft.rfft2(w) * (ky_keep[:, None] & kx_keep[None, :])
    re, im = (torch.from_numpy(a.astype(np.float32)) for a in (wc.real, wc.imag))
    return PSState(w_hat=torch.complex(re, im).to(device),
                   t=torch.zeros((), dtype=torch.float32, device=device),
                   step=torch.zeros((), dtype=torch.int32, device=device))


def velocities(cfg: PseudoSpectralConfig, state: PSState):
    """(u, v) real-space fields from ω̂ (for spectra and visualisation)."""
    KX, KY, inv_k2, _ = (torch.from_numpy(a).to(state.w_hat.device)
                         for a in _wavenumbers(cfg))
    psi_hat = state.w_hat * inv_k2
    s = (cfg.ny, cfg.nx)
    return (torch.fft.irfft2(1j * KY * psi_hat, s=s),
            torch.fft.irfft2(-1j * KX * psi_hat, s=s))


class PSStep(nn.Module):
    """``step(state, cfl_scale) -> (state, PSMetrics)`` (``cfl_scale`` is
    unused: dt is fixed); the tables are buffers on ``device``."""

    def __init__(self, cfg: PseudoSpectralConfig, *, device):
        super().__init__()
        _check(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.reads_host = False
        KX, KY, inv_k2, dealias = (torch.from_numpy(a).to(device) for a in _wavenumbers(cfg))
        y = np.arange(cfg.ny) / cfg.ny
        kf = cfg.forcing_wavenumber * np.pi
        # f_ω = curl of fs·sin(k_f π y) x̂ = −fs·k_f π·cos(k_f π y), float64
        # on the host, its spectrum cast to float32 planes
        f_w = np.fft.rfft2(-cfg.forcing_scale * kf * np.cos(kf * y)[:, None]
                           * np.ones((1, cfg.nx), np.float64))
        f_w_hat = torch.complex(torch.from_numpy(f_w.real.astype(np.float32)),
                                torch.from_numpy(f_w.imag.astype(np.float32)))
        # Strang splitting: the exact half-step decay exp(−λ dt/2), in float32
        lam = cfg.nu * (KX * KX + KY * KY) + cfg.linear_friction
        self.register_buffer("ehalf", torch.exp(-0.5 * lam * cfg.dt))
        self.register_buffer("ikx", 1j * KX)
        self.register_buffer("iky", 1j * KY)
        self.register_buffer("inv_k2", inv_k2)
        self.register_buffer("dealias", dealias)
        self.register_buffer("f_w_hat", f_w_hat.to(device))
        self.register_buffer("dt", torch.tensor(cfg.dt, dtype=torch.float32, device=device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))

    def rhs(self, w_hat):
        """−dealias(u·∇ω)̂ + f̂_ω (the non-stiff part), and (u, v)."""
        s = (self.cfg.ny, self.cfg.nx)
        psi_hat = w_hat * self.inv_k2
        u = torch.fft.irfft2(self.iky * psi_hat, s=s)
        v = torch.fft.irfft2(-self.ikx * psi_hat, s=s)
        wx = torch.fft.irfft2(self.ikx * w_hat, s=s)
        wy = torch.fft.irfft2(self.iky * w_hat, s=s)
        adv_hat = torch.fft.rfft2(u * wx + v * wy)
        return (-adv_hat + self.f_w_hat) * self.dealias, u, v

    def forward(self, state: PSState, cfl_scale=None):
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
        w_real = torch.fft.irfft2(w, s=(self.cfg.ny, self.cfg.nx))
        return new_state, PSMetrics(
            dt=dt,
            max_vel=(u * u + v * v).sqrt().amax(),
            energy=0.5 * (u * u + v * v).mean(),
            enstrophy=0.5 * (w_real * w_real).mean(),
        )


def make_step(cfg: PseudoSpectralConfig, *, device) -> PSStep:
    """Build the step module on ``device``."""
    return PSStep(cfg, device=device)
