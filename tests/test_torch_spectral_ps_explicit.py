"""The pencil-FFT pseudo-spectral step on gloo ranks
(``cfdsim_tpu_torch/parallel/spectral_ps_explicit.py``) against the JAX
package's single-device step, its own explicit step and the port's
single-device step, from the same seeded state: the twin of
tests/test_spectral_ps.py:99-140 (2×2 ranks, ny = 24, 5 steps).

Tolerances (the JAX test's): real-space ω within 2e-5 of max|ω| (the full
complex spectrum through pencil FFTs against the rfft half-spectrum: float32
rounding of the FFT round trips), energy and enstrophy within 1e-5
relative; the largest speed (the port's single-device step, which the JAX
test does not hold) within 1e-5 relative.

One group of 4 gloo ranks runs every rank-side check (``_ranks``) while
this process runs the JAX references. JAX is imported inside the tests:
the ranks import this module for their function and need torch alone.
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)
STEPS = 5
W_RTOL, METRIC_RTOL = 2e-5, 1e-5
# tests/test_spectral_ps.py:107-109
CFG = dict(ny=24, aspect=1.0, nu=1e-3, dt=5e-3, forcing_wavenumber=4, forcing_scale=0.3,
           linear_friction=0.2)
INIT = dict(noise=0.3, seed=2)


def _ranks(mesh):
    """The distributed runs: with and without metrics; rank 0 returns the
    gathered full spectra and the metrics of each step."""
    import dataclasses

    from cfdsim_tpu_torch.models import spectral_ps as ps
    from cfdsim_tpu_torch.parallel import (
        block_state,
        full_spectrum_state,
        gather_state,
        make_ps_explicit_step,
    )

    out = {}
    for name, cfg in (("metrics", ps.PseudoSpectralConfig(**CFG)),
                      ("no_metrics", dataclasses.replace(ps.PseudoSpectralConfig(**CFG),
                                                         compute_metrics=False))):
        step = make_ps_explicit_step(cfg, mesh)
        s = block_state(full_spectrum_state(cfg, ps.init_state(cfg, device="cpu", **INIT)),
                        mesh)
        metrics = []
        for _ in range(STEPS):
            s, m = step(s, None)
            metrics.append({k: float(v) for k, v in m._asdict().items()})
        g = gather_state(s, mesh)
        out[name] = {"w_hat": g.w_hat.numpy(), "t": float(g.t), "step": int(g.step),
                     "metrics": metrics}
    return out


def spawn_beside(fn, local):
    """``fn`` on 4 gloo ranks (2×2) while this process runs ``local()``."""
    from concurrent.futures import ThreadPoolExecutor

    from cfdsim_tpu_torch.parallel.launch import spawn

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, fn, 4, TOPOLOGY, device="cpu")
        here = local()
        return {"ranks": ranks.result(), "jax": here}


def _jax_runs():
    """The JAX single-device step and the JAX explicit step on a 2×2 mesh
    of 4 virtual CPU devices (tests/test_spectral_ps.py:114-123): real-space
    ω and the last metrics of each."""
    import jax

    from cfdsim_tpu.models import spectral_ps as jps
    from cfdsim_tpu.parallel.mesh import make_grid_mesh
    from cfdsim_tpu.parallel.spectral_ps_explicit import (
        full_spectrum_state,
        make_ps_explicit_step,
    )

    cfg = jps.PseudoSpectralConfig(**CFG)
    s0 = jps.init_state(cfg, **INIT)
    step1 = jax.jit(jps.make_step(cfg))
    stepN = jax.jit(make_ps_explicit_step(cfg, make_grid_mesh(n_devices=4, topology=TOPOLOGY)))
    a, b = s0, full_spectrum_state(cfg, s0)
    for _ in range(STEPS):
        a, ma = step1(a, None)
        b, mb = stepN(b, None)
    wa, wb = np.asarray(a.w_hat), np.asarray(b.w_hat)
    return {
        "single": {"w": np.fft.irfft2(wa[0] + 1j * wa[1], s=(CFG["ny"], CFG["ny"])),
                   "metrics": {k: float(v) for k, v in ma._asdict().items()},
                   "t": float(a.t)},
        "explicit": {"w": np.real(np.fft.ifft2(wb[0] + 1j * wb[1])),
                     "metrics": {k: float(v) for k, v in mb._asdict().items()}},
    }


@pytest.fixture(scope="module")
def results():
    return spawn_beside(_ranks, _jax_runs)


def _w(run):
    return np.real(np.fft.ifft2(run["w_hat"]))


def _check(run, ref, metric_names=("energy", "enstrophy")):
    scale = np.abs(ref["w"]).max()
    np.testing.assert_allclose(_w(run), ref["w"], rtol=0, atol=W_RTOL * scale)
    for k in metric_names:
        np.testing.assert_allclose(run["metrics"][-1][k], ref["metrics"][k], rtol=METRIC_RTOL,
                                   err_msg=k)


def test_ps_explicit_matches_jax_single_device(results):
    got, ref = results["ranks"]["metrics"], results["jax"]["single"]
    _check(got, ref)
    assert got["step"] == STEPS
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    np.testing.assert_allclose(got["metrics"][-1]["dt"], ref["metrics"]["dt"], rtol=0)


def test_ps_explicit_matches_jax_explicit_step(results):
    _check(results["ranks"]["metrics"], results["jax"]["explicit"])


def test_ps_explicit_matches_port_single_device(results):
    from cfdsim_tpu_torch.models import spectral_ps as ps

    cfg = ps.PseudoSpectralConfig(**CFG)
    step, s = ps.make_step(cfg, device="cpu"), ps.init_state(cfg, device="cpu", **INIT)
    for _ in range(STEPS):
        s, m = step(s, None)
    ref = {"w": torch.fft.irfft2(s.w_hat, s=(cfg.ny, cfg.nx)).numpy(),
           "metrics": {k: float(v) for k, v in m._asdict().items()}}
    _check(results["ranks"]["metrics"], ref, ("energy", "enstrophy", "max_vel"))


def test_ps_explicit_without_metrics(results):
    """compute_metrics=False: the same state, the metrics zero but dt."""
    runs = results["ranks"]
    np.testing.assert_array_equal(runs["no_metrics"]["w_hat"], runs["metrics"]["w_hat"])
    last = runs["no_metrics"]["metrics"][-1]
    np.testing.assert_allclose(last["dt"], CFG["dt"], rtol=1e-7)
    assert last["max_vel"] == last["energy"] == last["enstrophy"] == 0.0


def test_full_and_half_spectrum_states_match_jax():
    """The host conversions against the JAX package's, on the same state,
    and their round trip."""
    from cfdsim_tpu.models import spectral_ps as jps
    from cfdsim_tpu.parallel import spectral_ps_explicit as jex
    from cfdsim_tpu_torch.models import spectral_ps as ps
    from cfdsim_tpu_torch.parallel import full_spectrum_state, half_spectrum_state

    cfg, jcfg = ps.PseudoSpectralConfig(**CFG), jps.PseudoSpectralConfig(**CFG)
    s = ps.init_state(cfg, device="cpu", **INIT)
    full = full_spectrum_state(cfg, s)
    assert full.w_hat.dtype == torch.complex64 and full.w_hat.shape == (24, 24)
    jfull = np.asarray(jex.full_spectrum_state(jcfg, jps.init_state(jcfg, **INIT)).w_hat)
    np.testing.assert_allclose(full.w_hat.numpy(), jfull[0] + 1j * jfull[1], rtol=0,
                               atol=1e-6 * np.abs(jfull).max())
    back = half_spectrum_state(cfg, full)
    np.testing.assert_allclose(back.w_hat.numpy(), s.w_hat.numpy(), rtol=0,
                               atol=1e-6 * float(s.w_hat.abs().max()))
    assert back.t is s.t and back.step is s.step


def test_ps_explicit_refusals():
    """The pencil layout (ny_l % px, nx_l % py) and an odd forcing
    wavenumber raise when the step is built."""
    from cfdsim_tpu_torch.models import spectral_ps as ps
    from cfdsim_tpu_torch.parallel import make_ps_explicit_step
    from cfdsim_tpu_torch.parallel.mesh import GridMesh

    mesh = GridMesh(2, 4, 0, "gloo", "cpu", None, None)
    with pytest.raises(ValueError, match="pencil"):
        make_ps_explicit_step(ps.PseudoSpectralConfig(ny=12), mesh)  # (6, 3) blocks
    with pytest.raises(ValueError, match="odd"):
        make_ps_explicit_step(ps.PseudoSpectralConfig(ny=32, forcing_wavenumber=3), mesh)
