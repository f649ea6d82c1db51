"""The port's pseudo-spectral tier (``models/spectral_ps.py``, the case
``kolmogorov_ps``), the energy spectra (``utils/spectra.py``) and the
complex state's snapshots, against the JAX package and its physics.

The port keeps ω̂ as one complex64 tensor; the JAX package keeps float32
re/im planes (2, ny, nx//2+1), the schema of ``convert.ps_state_to_numpy``
and of every snapshot file.

Tolerances:
- the initial ω̂ (noise from ``default_rng``, host FFT, dealias) equal to
  the JAX planes;
- five ``kolmogorov_ps`` steps at 32² with noise from the state after 50
  jitted JAX steps: ω̂ within 1e-6 of max|ω̂| (cuFFT/pocketfft-independent
  here: both sides on the CPU; FFT summation orders, XLA's FMAs), t and dt
  equal, the metrics within 1e-5 relative; ``velocities`` within 1e-6 of
  max|u, v|;
- ``energy_spectrum_2d``/``_3d`` (with and without the mirror) within 1e-6
  of max E(k), k equal;
- physics (tests/test_spectral_ps.py:32, :85): a single mode decays by
  exp(−(νk²+α)t) within 2e-5 of its amplitude at 32²; modes beyond the 2/3
  boundary are exactly zero after one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.io_.hdf5 import restore as j_restore
from cfdsim_tpu.utils import spectra as jspectra
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import ps_state_from_numpy, ps_state_to_numpy
from cfdsim_tpu_torch.io_ import SnapshotWriter, restore
from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter, csnap_steps
from cfdsim_tpu_torch.models import spectral_ps as ps
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.utils import spectra

W_RTOL = 1e-6
METRIC_RTOL = 1e-5
UV_RTOL = 1e-6
SPECTRUM_RTOL = 1e-6


def test_initial_state_matches_jax_planes():
    kw = dict(ny=32, noise=0.5, seed=3)
    jcase, tcase = j_build("kolmogorov_ps", **kw), build("kolmogorov_ps", device="cpu", **kw)
    w = tcase.state.w_hat
    assert w.dtype == torch.complex64 and w.shape == (32, 17)
    d = ps_state_to_numpy(tcase.state)
    assert d["w_hat"].dtype == np.float32 and d["w_hat"].shape == (2, 32, 17)
    np.testing.assert_array_equal(d["w_hat"], np.asarray(jcase.state.w_hat))


@pytest.mark.parametrize("friction", [0.0, 0.2])
def test_kolmogorov_ps_steps_match_jax(friction):
    kw = dict(ny=32, noise=0.5, nu=1e-3, linear_friction=friction)
    jcase, tcase = j_build("kolmogorov_ps", **kw), build("kolmogorov_ps", device="cpu", **kw)
    step = jax.jit(jcase.step)
    s = jcase.state
    for _ in range(50):
        s, _ = step(s, None)
    state = ps_state_from_numpy(np.asarray(s.w_hat), s.t, s.step, "cpu")
    for _ in range(5):
        s, jm = step(s, None)
        state, tm = tcase.step(state, 1.0)
    want = np.asarray(s.w_hat)
    got = ps_state_to_numpy(state)["w_hat"]
    assert np.abs(got - want).max() <= W_RTOL * np.abs(want).max()
    assert float(state.t) == float(s.t) and float(tm.dt) == float(jm.dt)
    for name in ("max_vel", "energy", "enstrophy"):
        a, b = float(getattr(tm, name)), float(getattr(jm, name))
        assert abs(a - b) <= METRIC_RTOL * abs(b), (name, a, b)
    jt = jcase.extras["velocities"](s)
    tt = tcase.extras["velocities"](state)
    scale = max(np.abs(np.asarray(a)).max() for a in jt)
    for a, b in zip(tt, jt):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= UV_RTOL * scale


def test_single_mode_decay_exact():
    """tests/test_spectral_ps.py:32 at 32²: no forcing, one Fourier mode
    decays by exp(−(νk²+α)t) (its self-advection vanishes)."""
    n, m, nu, alpha, dt = 32, 3, 2e-3, 0.3, 5e-3
    cfg = ps.PseudoSpectralConfig(ny=n, aspect=1.0, nu=nu, dt=dt, forcing_scale=0.0,
                                  linear_friction=alpha)
    y = np.arange(n) / n
    w0 = np.cos(2 * np.pi * m * y)[:, None] * np.ones((1, n))
    s = ps.init_state(cfg, w0=w0, device="cpu")
    s, _ = make_chunk(cfg, ps.make_step(cfg, device="cpu"), 200)(s, 1.0)
    w = torch.fft.irfft2(s.w_hat, s=(n, n)).numpy()
    expect = w0 * np.exp(-(nu * (2 * np.pi * m) ** 2 + alpha) * dt * 200)
    np.testing.assert_allclose(w, expect, atol=2e-5 * np.abs(w0).max())


def test_dealias_mask_after_one_step():
    """tests/test_spectral_ps.py:85: modes beyond the 2/3 boundary are
    annihilated by one step."""
    cfg = ps.PseudoSpectralConfig(ny=48, aspect=1.0)
    s = ps.init_state(cfg, noise=0.1, seed=1, device="cpu")
    st, m = ps.make_step(cfg, device="cpu")(s, 1.0)
    w = st.w_hat
    assert w.shape == (48, 25) and bool(torch.isfinite(torch.view_as_real(w)).all())
    assert float(m.energy) >= 0.0
    assert float(w[:, 17:].abs().max()) == 0.0  # kx cycles > 48/3
    assert float(w[17:48 - 16, :].abs().max()) == 0.0  # |ky| cycles > 16


def test_odd_forcing_wavenumber_raises():
    """The JAX package accepts an odd k_f, whose sin(k_f π y) is not
    periodic on the box (a logged defect); the port refuses it."""
    with pytest.raises(ValueError, match="odd"):
        build("kolmogorov_ps", ny=16, forcing_wavenumber=7, device="cpu")
    cfg = ps.PseudoSpectralConfig(ny=16, forcing_wavenumber=3)
    with pytest.raises(ValueError, match="odd"):
        ps.make_step(cfg, device="cpu")


def test_energy_spectrum_2d_matches_jax():
    rng = np.random.default_rng(4)
    for shape in ((32, 32), (24, 24), (15, 15)):
        u, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        jk, je = jspectra.energy_spectrum_2d(jnp.asarray(u), jnp.asarray(v))
        tk, te = spectra.energy_spectrum_2d(torch.tensor(u), torch.tensor(v))
        np.testing.assert_array_equal(tk, jk)
        assert np.abs(te - je).max() <= SPECTRUM_RTOL * je.max()
        # Parseval: Σ E(k) = ⟨|u|²⟩/2
        assert te.sum() == pytest.approx(0.5 * float((u * u + v * v).mean()), rel=1e-5)


@pytest.mark.parametrize("mirror", [False, True])
def test_energy_spectrum_3d_matches_jax(mirror):
    rng = np.random.default_rng(5)
    u, v, w = (rng.standard_normal((8, 8, 8)).astype(np.float32) for _ in range(3))
    jk, je = jspectra.energy_spectrum_3d(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
                                         mirror=mirror)
    tk, te = spectra.energy_spectrum_3d(torch.tensor(u), torch.tensor(v), torch.tensor(w),
                                        mirror=mirror)
    np.testing.assert_array_equal(tk, jk)
    assert np.abs(te - je).max() <= SPECTRUM_RTOL * je.max()


def test_state_round_trip_and_snapshots_in_the_jax_schema(tmp_path):
    """ω̂ round-trips through ``convert``; an HDF5 snapshot holds it as
    float32 planes (2, ny, nx//2+1), which the JAX package's ``restore``
    reads, and the port's ``restore`` reads back into a complex state
    (from HDF5 and from the native container)."""
    case = build("kolmogorov_ps", ny=16, noise=0.3, device="cpu")
    state, _ = case.step(case.state, 1.0)
    d = ps_state_to_numpy(state)
    back = ps_state_from_numpy(d["w_hat"], d["t"], d["step"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, state))
    with pytest.raises(ValueError, match="planes"):
        ps_state_from_numpy(d["w_hat"][0], 0.0, 0, "cpu")
    h5 = tmp_path / "ps.h5"
    SnapshotWriter(h5).save(1, float(state.t), w_hat=state.w_hat)
    jcase = j_build("kolmogorov_ps", ny=16)
    js = j_restore(jcase.state, h5)
    assert js.w_hat.shape == (2, 16, 9) and js.w_hat.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(js.w_hat), d["w_hat"])
    assert all(torch.equal(a, b) for a, b in zip(restore(case.state, h5), state))
    native = tmp_path / "ps.csnap"
    with NativeSnapshotWriter(native) as writer:
        writer.save(1, float(state.t), w_hat=state.w_hat)
    rec = csnap_steps(native)[1][0]["w_hat"]
    assert rec.dtype == np.float32 and rec.shape == (2, 16, 9)
    assert all(torch.equal(a, b) for a, b in zip(restore(case.state, native), state))
    with pytest.raises(ValueError, match="shape"):
        restore(build("kolmogorov_ps", ny=24, device="cpu").state, native)


def test_cli_run_kolmogorov_ps_resume_bit_exact(tmp_path):
    """``run kolmogorov_ps`` for 20 steps, native snapshots, ``--resume``
    against one run of 20, bit for bit; the file holds the planes."""
    common = ["--ny", "16", "--noise", "0.3", "--chunk-steps", "10", "--snapshot-interval",
              "10", "--device", "cpu", "--io", "native", "--t-final", "100"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", "kolmogorov_ps", "--max-steps", "10", "--out", str(out_a), *common])
    report = cli.main(["run", "kolmogorov_ps", "--max-steps", "20", "--out", str(out_a),
                       "--resume", *common])
    assert report["final_step"] == 20 and not report["stopped_reason"]
    cli.main(["run", "kolmogorov_ps", "--max-steps", "20", "--out", str(out_b), *common])
    a, b = csnap_steps(out_a / "snapshots.csnap"), csnap_steps(out_b / "snapshots.csnap")
    assert sorted(a) == sorted(b) == [0, 10, 20]
    for step in a:
        assert a[step][0]["w_hat"].shape == (2, 16, 9)
        np.testing.assert_array_equal(a[step][0]["w_hat"], b[step][0]["w_hat"])


def test_inviscid_taylor_green_energy_short():
    """The steady Euler TG vortex (tests/test_spectral_ps.py:51) at 32²,
    50 steps: energy conserved to 1e-5 (the card runs the 96², 500-step
    gate)."""
    n, m = 32, 4
    cfg = ps.PseudoSpectralConfig(ny=n, aspect=1.0, nu=0.0, dt=2e-3, forcing_scale=0.0)
    y, x = np.meshgrid(np.arange(n) / n, np.arange(n) / n, indexing="ij")
    k = 2 * np.pi * m
    s0 = ps.init_state(cfg, w0=-2 * k * np.sin(k * x) * np.sin(k * y), device="cpu")
    e0 = sum(float((a * a).mean()) for a in ps.velocities(cfg, s0))
    s, _ = make_chunk(cfg, ps.make_step(cfg, device="cpu"), 50)(s0, 1.0)
    e1 = sum(float((a * a).mean()) for a in ps.velocities(cfg, s))
    assert abs(e1 - e0) / e0 < 1e-5
