"""The port's 2D study drivers (``cfdsim_tpu_torch/examples/
kolmogorov_spectrum.py``, ``cavity_rossiter.py``, ``cavity_accuracy_1024.py``)
against the JAX package at a tiny size on the CPU: the series each returns,
its host-side analysis fed the same series, its files, and the accuracy
run's npz resume. The JAX ``cavity_accuracy_1024`` module is not imported
(it switches on JAX's persistent compilation cache when imported): its
``extrema_errors`` is held against ``cfdsim_tpu.validation.
botella_peyret_errors`` on the same state, and its npz layout (u, v, p, t,
step) is written here with numpy from a JAX state.

Tolerances: E(k) and the probe p within 1e-5 of their largest |value|
(measured 2.5e-7 and 1.2e-7 of it), the step-to-step state 1e-5 of
max |u|; the host-side analysis (the Kolmogorov slopes and peak, the
Rossiter predictions, PSD, mode table and peaks on a synthetic series fed
to the JAX driver in place of its steps) to 1e-12; the resume bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cfdsim_tpu_torch.io_.native import csnap_steps
from test_torch_examples import REPO, JaxProxy, jax_example, one_torch_thread, report_of  # noqa: F401

SERIES_RTOL = 1e-5
HOST_ATOL = 1e-12


def close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=SERIES_RTOL * np.abs(want).max())


@pytest.mark.parametrize("flags,kw", [
    (["--solver", "stable", "--advection", "bfecc", "--noise", "0.1", "--dt", "0.01"],
     dict(solver="stable", advection="bfecc", noise=0.1, dt=0.01)),
    (["--solver", "ps", "--noise", "0.1", "--alpha", "0.1", "--dt", "0.002"],
     dict(solver="ps", noise=0.1, alpha=0.1, dt=0.002)),
], ids=["stable_bfecc", "ps_friction"])
def test_kolmogorov_spectrum_matches_jax(tmp_path, flags, kw):
    """E(k) after two 5-step chunks at 32² (averaged over the stationary
    window with friction); the slopes and the arrest peak of the JAX
    driver's E(k) through the port's analysis."""
    from cfdsim_tpu_torch.examples import kolmogorov_spectrum as drv

    t_final = 10 * kw["dt"]
    out = tmp_path / "kolmogorov"
    res = drv.main(["--n", "32", "--t", str(t_final), "--chunk", "5", *flags, "--device", "cpu",
                    "--out", str(out)])
    want = jax_example("kolmogorov_spectrum").run(n=32, t_final=t_final, chunk=5,
                                                   verbose=False, **kw)
    np.testing.assert_array_equal(res["k"], want["k"])
    close(res["E_k"], want["E_k"])
    assert res["k_peak"] == want["k_peak"] and res["k_inj"] == want["k_inj"]
    s = drv.spectrum_slopes(want["k"], want["E_k"], 8, kw.get("alpha", 0.0), 32)
    for k in ("slope_inverse", "slope_direct"):
        assert abs(s[k] - want[k]) <= HOST_ATOL
    assert s["k_peak"] == want["k_peak"]
    rep = report_of(out)
    assert rep["steps"] == 10 and (rep["n_stat"] == 2 or not kw.get("alpha"))
    (fields, _), = csnap_steps(out / "snapshots.csnap").values()
    assert set(fields) == ({"u", "v"} if kw["solver"] == "stable" else {"w_hat"})


ROSSITER = dict(nx=60, ny=18, t_final=0.02, t_tail=0.0, chunk_steps=20)


def test_cavity_rossiter_matches_jax(tmp_path):
    """The three probes' p and t over one 20-step chunk at 60×18; the
    series file written atomically."""
    from cfdsim_tpu_torch.examples import cavity_rossiter as drv

    out = tmp_path / "rossiter"
    save = tmp_path / "series.npz"
    res = drv.main(["--nx", "60", "--ny", "18", "--t", "0.02", "--tail", "0", "--chunk-steps",
                    "20", "--save", str(save), "--device", "cpu", "--out", str(out)])
    want = jax_example("cavity_rossiter").run(**ROSSITER, verbose=False)
    assert res["p"].shape == want["p"].shape == (20, 3)
    close(res["p"], want["p"])
    close(res["t"], want["t"])
    series = np.load(save)
    np.testing.assert_array_equal(series["p"], res["p"])
    assert set(series.files) == {"t", "p", "probe_pts", "st_axis", "psd", "rossiter", "heller"}
    assert not list(tmp_path.glob("*.tmp.npz"))
    rep = report_of(out)
    assert rep["steps"] == 20 and min(rep["min_rho"]) > 0
    (fields, _), = csnap_steps(out / "snapshots.csnap").values()
    assert fields["U"].shape[0] == 4 and np.isfinite(fields["U"]).all()


@pytest.mark.parametrize("real_geometry", [True, False], ids=["real", "pin"])
def test_cavity_rossiter_analysis_matches_jax(real_geometry):
    """A synthetic three-tone probe series (jittered dt, 6000 steps to t =
    60) fed to the JAX driver in place of its steps: the port's PSD, mode
    table and peaks on the same series to 1e-12; ``rossiter_modes`` with and
    without the Heller correction."""
    import jax.numpy as jnp

    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.examples import cavity_rossiter as drv

    rng = np.random.default_rng(7)
    dt = 0.01 * (1 + 0.2 * rng.uniform(-1, 1, 6000))
    t = np.cumsum(dt).astype(np.float32)
    case = build("cavity_supersonic", nx=60, ny=18, real_geometry=real_geometry, device="cpu")
    U_inf = float(case.extras["U_inf"][1] / case.extras["U_inf"][0])
    tones = [(st * U_inf / 0.5, a) for st, a in ((0.2, 1.0), (0.5, 0.6), (0.8, 0.3))]
    p = np.stack([sum(a * np.sin(2 * np.pi * f * t + ph) for f, a in tones)
                  + 0.05 * rng.standard_normal(6000) for ph in (0.0, 1.0, 2.0)], 1)
    p = (1.0 + p).astype(np.float32)

    def synthetic(n, jitted, state, _):
        sl = slice(2000 * n, 2000 * (n + 1))
        ones = np.ones(2000, np.float32)
        return (state._replace(t=jnp.float32(t[sl][-1])),
                (t[sl], dt[sl].astype(np.float32), p[sl], ones, ones))

    mod = jax_example("cavity_rossiter")
    mod.jax = JaxProxy(synthetic)
    want = mod.run(nx=60, ny=18, t_final=float(t[-1]), chunk_steps=2000,
                   real_geometry=real_geometry, verbose=False)
    got = drv.tail_psd(want["t"], want["p"], 10.0, 0.5, U_inf, 2.5, real_geometry)
    for k in ("st_axis", "psd"):
        np.testing.assert_allclose(got[k], want[k], rtol=HOST_ATOL, atol=0)
    assert len(want["rows"]) == 3 and len(want["peaks"]) == 5
    np.testing.assert_allclose(np.asarray(got["rows"]), np.asarray(want["rows"]), rtol=0,
                               atol=HOST_ATOL)
    np.testing.assert_allclose(got["peaks"], want["peaks"], rtol=0, atol=HOST_ATOL)
    for mach in (1.5, 2.5, 3.0):
        for heller in (False, True):
            np.testing.assert_allclose(drv.rossiter_modes(mach, heller=heller, n_modes=4),
                                       mod.rossiter_modes(mach, heller=heller, n_modes=4),
                                       rtol=0, atol=HOST_ATOL)


def jax_mac_state(n, steps):
    """A JAX MAC cavity state after ``steps`` steps, as the JAX driver's npz
    holds it."""
    import jax.numpy as jnp

    from cfdsim_tpu.cases import lid_cavity_mac

    case = lid_cavity_mac(n=n, Re=1000.0, projection="incremental")
    s = case.state
    for _ in range(steps):
        s, _ = case.step(s, jnp.float32(1.0))
    return case, s


def test_cavity_accuracy_1024_extrema_and_jax_npz(tmp_path):
    """``extrema_errors`` against the JAX package's
    ``botella_peyret_errors`` on a JAX state's centrelines; that state in
    the JAX driver's npz layout resumes in the port, bit for bit, and its
    next chunk steps within 1e-5 of the JAX steps."""
    import jax.numpy as jnp

    from cfdsim_tpu.validation import botella_peyret_errors
    from cfdsim_tpu_torch.examples import cavity_accuracy_1024 as drv

    n = 16
    case, s = jax_mac_state(n, 5)
    npz = tmp_path / "jax_state.npz"
    np.savez(npz, u=np.asarray(s.u, np.float32), v=np.asarray(s.v, np.float32),
             p=np.asarray(s.p), t=float(s.t), step=int(s.step))
    u, v = np.asarray(s.u), np.asarray(s.v)
    want = botella_peyret_errors(u[:, n // 2], (np.arange(n) + 0.5) / n, v[n // 2, :],
                                 (np.arange(n) + 0.5) / n)
    got = drv.extrema_errors(s, n)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= HOST_ATOL

    out = tmp_path / "acc"
    rep = drv.main([str(n), "1e9", str(tmp_path / "final.npz"), "incremental", str(npz),
                    "--chunk-steps", "5", "--max-steps", "10", "--report-every", "1e-3",
                    "--device", "cpu", "--out", str(out)])
    for _ in range(5):
        s, _ = case.step(s, jnp.float32(1.0))
    final = np.load(tmp_path / "final.npz")
    assert int(final["step"]) == rep["step"] == 10 and rep["reports"]
    for k in ("u", "v"):
        close(final[k], np.asarray(getattr(s, k)))
    assert report_of(out)["max_err"] == pytest.approx(max(rep["errors"].values()))
    (step, (fields, _)), = csnap_steps(out / "snapshots.csnap").items()
    assert step == 10 and fields["u"].shape == (n, n + 1)

    resumed = drv.load_npz(npz, _port_state(n))
    for k in ("u", "v", "p"):
        np.testing.assert_array_equal(getattr(resumed, k).numpy(), np.load(npz)[k])
    assert int(resumed.step) == 5 and float(resumed.t) == float(np.load(npz)["t"])


def _port_state(n):
    from cfdsim_tpu_torch.cases import lid_cavity_mac

    return lid_cavity_mac(n=n, Re=1000.0, device="cpu").state


def test_cavity_accuracy_1024_resume_is_bit_exact(tmp_path):
    """One chunk, the npz, a resume and one chunk: the npz of two
    uninterrupted chunks, bit for bit (the npz holds the whole state)."""
    from cfdsim_tpu_torch.examples import cavity_accuracy_1024 as drv

    kw = dict(device="cpu", chunk_steps=5, report_every=1e9)
    whole = drv.run(16, 1e9, tmp_path / "whole.npz", "incremental", **kw, max_steps=10)[0]
    drv.run(16, 1e9, tmp_path / "half.npz", "incremental", **kw, max_steps=5)
    part = drv.run(16, 1e9, tmp_path / "part.npz", "incremental", tmp_path / "half.npz", **kw,
                   max_steps=10)[0]
    for k in ("u", "v", "p", "t", "step"):
        assert torch.equal(getattr(part, k), getattr(whole, k)), k
    a, b = np.load(tmp_path / "whole.npz"), np.load(tmp_path / "part.npz")
    for k in ("u", "v", "p", "t", "step"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("storage", ["bf16", "fp16"])
def test_cavity_accuracy_1024_refuses_other_storage(tmp_path, storage):
    from cfdsim_tpu_torch.examples import cavity_accuracy_1024 as drv

    with pytest.raises(NotImplementedError, match="only 'fp32'"):
        drv.main(["16", "1", str(tmp_path / "x.npz"), "chorin", "", storage, "--device", "cpu"])


def test_study_drivers_do_not_import_matplotlib(tmp_path):
    """The eight study drivers, imported and five of them run at a tiny
    size in a fresh interpreter, leave matplotlib unimported: only
    ``cylinder_fem --render`` needs it (the card's machine has none)."""
    code = f"""
import sys
import importlib
for name in ("sphere_wake", "tgv3d_les", "sphere_les_re3900", "kolmogorov_spectrum",
             "cavity_rossiter", "cavity_accuracy_1024", "cylinder_fem", "schafer_turek_2d2"):
    importlib.import_module("cfdsim_tpu_torch.examples." + name)
from cfdsim_tpu_torch.examples import (cavity_accuracy_1024, cavity_rossiter,
    kolmogorov_spectrum, sphere_wake, tgv3d_les)
out = {str(tmp_path)!r}
cpu = ["--device", "cpu"]
sphere_wake.main(["--n", "2", "--max-steps", "2", "--chunk-steps", "2", *cpu, "--out", out + "/s"])
tgv3d_les.main(["--n", "8", "--max-steps", "2", "--chunk", "2", *cpu, "--out", out + "/t"])
kolmogorov_spectrum.main(["--n", "16", "--t", "0.02", "--chunk", "2", *cpu, "--out", out + "/k"])
cavity_rossiter.main(["--nx", "40", "--ny", "12", "--max-steps", "4", "--chunk-steps", "4",
                      "--tail", "0", *cpu, "--out", out + "/r"])
cavity_accuracy_1024.main(["16", "1e9", out + "/a.npz", "--max-steps", "2", "--chunk-steps",
                           "2", *cpu, "--out", out + "/a"])
assert "matplotlib" not in sys.modules, "matplotlib imported"
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "PYTHONPATH": str(REPO),
                                         "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]
