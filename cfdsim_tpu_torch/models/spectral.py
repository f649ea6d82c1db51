"""Periodic spectral "stable fluids" solver, Kolmogorov flow
(``cfdsim_tpu.models.spectral``).

The reference's FFTW solver (julia/youtube_kolmogorov_turbulence/plot.jl:
23-167), per step: (1) sinusoidal body force, (2) semi-Lagrangian
self-advection by backtracing and bilinear interpolation, (3) mean
subtraction, (4) rfft → spectral diffusion decay exp(−ν dt k²) →
pseudo-pressure projection û −= k̂(k̂·û) → irfft, (5) mean subtraction.

The backtrace is indexed by hand with the semantics of
``jax.scipy.ndimage.map_coordinates(order=1, mode="wrap")``: lower =
floor(c), w = c − lower, weights (1 − w, w), indices taken modulo the size
(period n), the four corners summed in the order (y0, x0), (y0, x1), (y1,
x0), (y1, x1), each term (wy·wx)·f; ``torch.nn.functional.grid_sample``
has no periodic mode. The wavenumber tables are float64 numpy cast to
float32, as the JAX package builds them. ``angular_wavenumbers=True``
(default) decays with k = 2π·cycles/L; ``False`` reproduces the
reference's integer wavenumbers (plot.jl:42). dt is fixed: the step reads
nothing on the host and captures into one CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class SpectralState(NamedTuple):
    u: torch.Tensor  # (ny, nx)
    v: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor


class SpectralMetrics(NamedTuple):
    dt: torch.Tensor
    max_vel: torch.Tensor
    energy: torch.Tensor
    max_div: torch.Tensor  # spectral divergence after projection (≈ 0)


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    """Static configuration (the JAX package's fields and defaults)."""

    ny: int = 360
    aspect: float = 16.0 / 9.0
    nu: float = 1e-3
    dt: float = 0.01
    forcing_wavenumber: int = 8  # force_x = scale·sin(k·π·y) (plot.jl:47)
    forcing_scale: float = 0.1
    # Ekman drag −α·u, applied spectrally as û *= exp(−α dt); 0 = reference
    linear_friction: float = 0.0
    # "sl": the reference's bilinear semi-Lagrangian backtrace (plot.jl:
    # 84-97); "bfecc": BFECC/MacCormack error compensation on the same
    # trace, clamped to the advected 3×3 bounds (Selle et al. 2008)
    advection: str = "sl"  # sl | bfecc
    angular_wavenumbers: bool = True
    compute_metrics: bool = True

    @property
    def nx(self) -> int:
        return int(self.ny * self.aspect)

    @property
    def lx(self) -> float:
        return self.nx / self.ny  # unit-height domain (plot.jl:25-28)

    @property
    def ly(self) -> float:
        return 1.0


def init_state(cfg: SpectralConfig, u0=None, v0=None, *, device) -> SpectralState:
    """Rest, or (``u0``, ``v0``) as float32, on ``device``."""
    shape = (cfg.ny, cfg.nx)

    def field(a):
        if a is None:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device).clone()

    return SpectralState(u=field(u0), v=field(v0),
                         t=torch.zeros((), dtype=torch.float32, device=device),
                         step=torch.zeros((), dtype=torch.int32, device=device))


def _wavenumbers(cfg: SpectralConfig) -> dict:
    """Float32 numpy tables on the rfft2 grid (ny, nx//2+1): KX, KY (cycles
    per unit length), the unit k̂ of the projection and the decay factor."""
    kx_c = np.fft.rfftfreq(cfg.nx) * cfg.nx / cfg.lx
    ky_c = np.fft.fftfreq(cfg.ny) * cfg.ny / cfg.ly
    KX, KY = np.meshgrid(kx_c, ky_c)
    norm = np.sqrt(KX**2 + KY**2)
    norm_safe = np.where(norm == 0.0, 1.0, norm)
    scale = 2.0 * np.pi if cfg.angular_wavenumbers else 1.0
    decay = np.exp(-cfg.dt * (cfg.nu * (scale * norm) ** 2 + cfg.linear_friction))
    tables = {"KX": KX, "KY": KY, "kx_hat": KX / norm_safe, "ky_hat": KY / norm_safe,
              "decay": decay}
    return {k: v.astype(np.float32) for k, v in tables.items()}


def bilinear_wrap(field, y, x):
    """``field`` sampled at fractional grid coordinates (y, x) with periodic
    wrap: ``map_coordinates(field, [y, x], order=1, mode="wrap")`` of JAX."""
    ny, nx = field.shape
    y0f, x0f = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0f, x - x0f
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    rows = (torch.remainder(y0, ny) * nx, torch.remainder(y0 + 1, ny) * nx)
    cols = (torch.remainder(x0, nx), torch.remainder(x0 + 1, nx))
    flat = field.reshape(-1)
    out = None
    for wy, r in ((wy0, rows[0]), (wy1, rows[1])):
        for wx, c in ((wx0, cols[0]), (wx1, cols[1])):
            term = (wy * wx) * flat.take(r + c)
            out = term if out is None else out + term
    return out


def _pool(f, op):
    """Periodic 3×3 min or max pool (``op`` is torch.minimum/maximum)."""
    f = op(op(f, torch.roll(f, 1, 0)), torch.roll(f, -1, 0))
    return op(op(f, torch.roll(f, 1, 1)), torch.roll(f, -1, 1))


class SpectralStep(nn.Module):
    """``step(state, cfl_scale) -> (state, SpectralMetrics)`` (``cfl_scale``
    is unused: dt is fixed); the tables are buffers on ``device``."""

    def __init__(self, cfg: SpectralConfig, *, device):
        super().__init__()
        if cfg.advection not in ("sl", "bfecc"):
            raise ValueError(f"unknown advection {cfg.advection!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.reads_host = False
        for name, table in _wavenumbers(cfg).items():
            self.register_buffer(name, torch.from_numpy(table).to(device))
        y = np.arange(cfg.ny) / cfg.ny  # unit-height coordinates
        force_x = (cfg.forcing_scale * np.sin(cfg.forcing_wavenumber * np.pi * y)[:, None]
                   * np.ones((1, cfg.nx)))
        self.register_buffer("force_x", torch.from_numpy(force_x.astype(np.float32)).to(device))
        # the grid-index coordinates, (ny, 1) and (1, nx), broadcast in the trace
        self.register_buffer("iy", torch.arange(cfg.ny, dtype=torch.float32,
                                                device=device)[:, None])
        self.register_buffer("ix", torch.arange(cfg.nx, dtype=torch.float32,
                                                device=device)[None, :])
        self.register_buffer("dt", torch.tensor(cfg.dt, dtype=torch.float32, device=device))
        self.register_buffer("zero", torch.zeros((), dtype=torch.float32, device=device))

    def advect_sl(self, field, u, v, dt: float):
        """Backtrace grid points by dt·velocity (in grid-index units) and
        interpolate bilinearly with periodic wrap (plot.jl:84-97)."""
        cfg = self.cfg
        x_back = self.ix - dt * u * (cfg.nx / cfg.lx)
        y_back = self.iy - dt * v * (cfg.ny / cfg.ly)
        return bilinear_wrap(field, y_back, x_back)

    def advect_bfecc(self, field, u, v, dt: float):
        """fwd + ½(field − back(fwd)), clamped to the bilinearly advected
        3×3 local bounds so the correction makes no new extrema."""
        fwd = self.advect_sl(field, u, v, dt)
        bwd = self.advect_sl(fwd, u, v, -dt)
        out = fwd + 0.5 * (field - bwd)
        lo = self.advect_sl(_pool(field, torch.minimum), u, v, dt)
        hi = self.advect_sl(_pool(field, torch.maximum), u, v, dt)
        return torch.minimum(torch.maximum(out, lo), hi)

    def forward(self, state: SpectralState, cfl_scale=None):
        cfg = self.cfg
        dt = cfg.dt
        u = state.u + self.force_x  # (1) the body force, a per-step impulse (plot.jl:81)
        v = state.v
        # (2) semi-Lagrangian self-advection (plot.jl:84-97)
        adv = self.advect_bfecc if cfg.advection == "bfecc" else self.advect_sl
        u_adv = adv(u, u, v, dt)
        v_adv = adv(v, u, v, dt)
        # (3) subtract the means (plot.jl:99-101)
        u_adv = u_adv - u_adv.mean()
        v_adv = v_adv - v_adv.mean()
        # (4) spectral diffusion and pseudo-pressure projection (plot.jl:103-124)
        u_hat = torch.fft.rfft2(u_adv) * self.decay
        v_hat = torch.fft.rfft2(v_adv) * self.decay
        p_hat = u_hat * self.kx_hat + v_hat * self.ky_hat
        u_hat = u_hat - p_hat * self.kx_hat
        v_hat = v_hat - p_hat * self.ky_hat
        s = (cfg.ny, cfg.nx)
        u_new = torch.fft.irfft2(u_hat, s=s)
        v_new = torch.fft.irfft2(v_hat, s=s)
        # (5) subtract the means again (plot.jl:126-128)
        u_new = u_new - u_new.mean()
        v_new = v_new - v_new.mean()
        new_state = SpectralState(u=u_new, v=v_new, t=state.t + dt, step=state.step + 1)
        if not cfg.compute_metrics:
            z = self.zero
            return new_state, SpectralMetrics(z, z, z, z)
        div_hat = u_hat * self.KX + v_hat * self.KY  # ∝ the spectral divergence
        return new_state, SpectralMetrics(
            dt=self.dt,
            max_vel=torch.maximum(u_new.abs().amax(), v_new.abs().amax()),
            energy=(0.5 * (u_new * u_new + v_new * v_new)).mean(),
            max_div=div_hat.abs().amax() / (cfg.nx * cfg.ny),
        )


def make_step(cfg: SpectralConfig, *, device) -> SpectralStep:
    """Build the step module on ``device``."""
    return SpectralStep(cfg, device=device)


def spectral_curl(state: SpectralState, cfg: SpectralConfig):
    """Vorticity by spectral derivatives (plot.jl:134-141), for
    visualisation only: on the kx-Nyquist column ``1j·KX·v̂`` is not
    Hermitian, where cuFFT's and pocketfft's c2r may differ."""
    t = _wavenumbers(cfg)
    KX = torch.from_numpy(t["KX"]).to(state.u.device)
    KY = torch.from_numpy(t["KY"]).to(state.u.device)
    scale = 2.0 * math.pi if cfg.angular_wavenumbers else 1.0
    u_hat = torch.fft.rfft2(state.u)
    v_hat = torch.fft.rfft2(state.v)
    curl_hat = (1j * scale) * (KX * v_hat - KY * u_hat)
    return torch.fft.irfft2(curl_hat, s=state.u.shape)
