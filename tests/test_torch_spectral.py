"""The port's stable-fluids spectral tier (``models/spectral.py`` and the
case ``kolmogorov``) against the JAX package on seeded inputs.

Tolerances:
- the bilinear periodic trace (``bilinear_wrap``) against
  ``jax.scipy.ndimage.map_coordinates(order=1, mode="wrap")``, on
  coordinates that wrap both edges of both axes: within 1e-6 of max|f|;
- the wavenumber tables equal (both float64 numpy cast to float32);
- five ``kolmogorov`` steps at 32×56 from the state after 50 jitted JAX
  steps (sl, bfecc, sl with linear friction, bfecc with the reference's
  integer wavenumbers): u and v within 1e-6 of max|u, v| (FFT and mean
  summation orders; XLA's FMAs), ``dt`` equal, ``max_vel`` and ``energy``
  within 1e-5 relative, ``max_div`` (≈ 1e-13, roundoff) within 1e-10 of
  max|û| scale, i.e. both at roundoff;
- ``spectral_curl`` within 1e-5 of max|ω| on the CPU (pocketfft on both
  sides; on the card cuFFT's c2r treats the non-Hermitian kx-Nyquist
  column its own way: visualisation only, in no gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.models import spectral as jspec
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import spectral_state_from_numpy, spectral_state_to_numpy
from cfdsim_tpu_torch.models import spectral as spec

TRACE_RTOL = 1e-6
UV_RTOL = 1e-6
METRIC_RTOL = 1e-5
CURL_RTOL = 1e-5


@pytest.mark.parametrize("shape", [(32, 56), (17, 9)])
def test_bilinear_wrap_matches_map_coordinates(shape):
    rng = np.random.default_rng(0)
    ny, nx = shape
    f = rng.standard_normal(shape).astype(np.float32)
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    # displacements of up to two periods either way: every backtrace wraps
    y = (iy + rng.uniform(-2 * ny, 2 * ny, shape)).astype(np.float32)
    x = (ix + rng.uniform(-2 * nx, 2 * nx, shape)).astype(np.float32)
    y[0, 0], x[0, 0] = -0.25, -0.75  # just below both lower edges
    y[-1, -1], x[-1, -1] = ny - 0.5, nx - 0.125  # between the last cell and the first
    want = jax.jit(lambda f, y, x: jax.scipy.ndimage.map_coordinates(
        f, [y, x], order=1, mode="wrap"))(jnp.asarray(f), jnp.asarray(y), jnp.asarray(x))
    got = spec.bilinear_wrap(torch.tensor(f), torch.tensor(y), torch.tensor(x))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TRACE_RTOL * np.abs(f).max()


def test_wavenumber_tables_match_jax():
    kw = dict(ny=32, aspect=56 / 32, linear_friction=0.1)
    for angular in (True, False):
        cfg = spec.SpectralConfig(angular_wavenumbers=angular, **kw)
        jt = jspec._wavenumbers(jspec.SpectralConfig(angular_wavenumbers=angular, **kw))
        tt = spec._wavenumbers(cfg)
        for name, w in zip(("KX", "KY", "kx_hat", "ky_hat", "decay"), jt):
            np.testing.assert_array_equal(tt[name], np.asarray(w))


SPECTRAL_CONFIGS = {
    "sl": dict(advection="sl"),
    "bfecc": dict(advection="bfecc"),
    "sl_friction": dict(advection="sl", linear_friction=0.1),
    "bfecc_integer_k": dict(advection="bfecc", angular_wavenumbers=False),
}


@pytest.mark.parametrize("config", sorted(SPECTRAL_CONFIGS))
def test_kolmogorov_steps_match_jax(config):
    kw = dict(ny=32, aspect=56 / 32, **SPECTRAL_CONFIGS[config])
    jcase, tcase = j_build("kolmogorov", **kw), build("kolmogorov", device="cpu", **kw)
    assert tcase.cfg.nx == 56 and tcase.grid.shape == (32, 56)
    step = jax.jit(jcase.step)
    s = jcase.state
    for _ in range(50):
        s, _ = step(s)
    state = spectral_state_from_numpy(np.asarray(s.u), np.asarray(s.v), s.t, s.step, "cpu")
    for _ in range(5):
        s, jm = step(s)
        state, tm = tcase.step(state, 1.0)
    scale = max(np.abs(np.asarray(s.u)).max(), np.abs(np.asarray(s.v)).max())
    for name in ("u", "v"):
        dev = np.abs(getattr(state, name).numpy() - np.asarray(getattr(s, name))).max()
        assert dev <= UV_RTOL * scale, (name, dev / scale)
    assert float(state.t) == float(s.t) and int(state.step) == int(s.step) == 55
    assert float(tm.dt) == float(jm.dt)
    for name in ("max_vel", "energy"):
        a, b = float(getattr(tm, name)), float(getattr(jm, name))
        assert abs(a - b) <= METRIC_RTOL * abs(b), (name, a, b)
    assert float(tm.max_div) <= 1e-10 * scale and float(jm.max_div) <= 1e-10 * scale


def test_metrics_off_and_the_step_leaves_its_input():
    case = build("kolmogorov", ny=16, aspect=1.5, compute_metrics=False, device="cpu")
    u0 = np.random.default_rng(1).standard_normal((16, 24)).astype(np.float32)
    state = case.state._replace(u=torch.tensor(u0))
    s, m = case.step(state, 1.0)
    assert torch.equal(state.u, torch.tensor(u0))
    assert all(float(x) == 0.0 for x in m)
    jcase = j_build("kolmogorov", ny=16, aspect=1.5, compute_metrics=False)
    _, jm = jax.jit(jcase.step)(jcase.state._replace(u=jnp.asarray(u0)))
    assert all(float(x) == 0.0 for x in jm)
    with pytest.raises(ValueError, match="advection"):
        build("kolmogorov", ny=16, advection="rk4", device="cpu")


def test_spectral_curl_matches_jax():
    rng = np.random.default_rng(2)
    cfg_kw = dict(ny=24, aspect=1.5)
    u, v = (rng.standard_normal((24, 36)).astype(np.float32) for _ in range(2))
    jcfg = jspec.SpectralConfig(**cfg_kw)
    want = np.asarray(jspec.spectral_curl(jspec.SpectralState(
        jnp.asarray(u), jnp.asarray(v), jnp.float32(0), jnp.int32(0)), jcfg))
    state = spectral_state_from_numpy(u, v, 0.0, 0, "cpu")
    got = spec.spectral_curl(state, spec.SpectralConfig(**cfg_kw))
    assert np.abs(got.numpy() - want).max() <= CURL_RTOL * np.abs(want).max()


def test_state_round_trips():
    case = build("kolmogorov", ny=16, device="cpu")
    d = spectral_state_to_numpy(case.state)
    assert set(d) == {"u", "v", "t", "step"} and d["u"].shape == (16, 28)
    back = spectral_state_from_numpy(d["u"], d["v"], d["t"], d["step"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, case.state))
