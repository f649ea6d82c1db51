"""The port's FEM study drivers (``cfdsim_tpu_torch/examples/cylinder_fem.py``,
``schafer_turek_2d2.py``) against the JAX package's drivers of the same
name, on coarse meshes on the CPU: the per-step forces each returns, the
host-side analysis fed the same series, the frames' snapshot file and the
render.

Tolerances: fx and fy within FORCE_RTOL = 1e-4 of the largest |fx| after
two to four steps (measured 7.9e-5 on the cylinder, fy's, and 2.1e-5 on
Schäfer–Turek, fx's). The cylinder's port starts from the JAX driver's
Stokes state: each package's own Stokes GMRES stops within its 1e-5
tolerance, which alone puts the two starts 2.7e-4 apart in u and fy
1.4e-4 apart after two steps. Every step's solve must be accepted (its
relative residual below ``accept_relres``) and move u, so that a step
that keeps its previous state cannot pass as a match. ``shedding_stats``
and the Schäfer–Turek St by FFT and by zero crossings, Cd and the Cl
amplitude, on a synthetic lift fed to the JAX driver in place of its
steps, to 1e-12.
"""

import types

import numpy as np
import pytest

from cfdsim_tpu_torch.io_.native import csnap_steps
from test_torch_examples import JaxProxy, jax_example, one_torch_thread, report_of  # noqa: F401

FORCE_RTOL = 1e-4
HOST_ATOL = 1e-12
CYLINDER = dict(t_final=0.1, chunk_steps=2, h_near=0.3, h_far=1.5)


def forces_close(got_fx, got_fy, fx, fy):
    scale = FORCE_RTOL * np.abs(np.asarray(fx, np.float64)).max()
    for got, want in ((got_fx, fx), (got_fy, fy)):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=scale)


def test_cylinder_fem_matches_jax(tmp_path, monkeypatch):
    """fx, fy over one 2-step chunk at Re = 100 on a coarse mesh (h 0.3 →
    1.5), both packages from the JAX driver's Stokes state, every step
    accepted; the frame written after the chunk reads back."""
    import torch

    import cfdsim_tpu_torch.cases
    from cfdsim_tpu_torch.examples import cylinder_fem as drv

    want = jax_example("cylinder_fem").run_re(100.0, **CYLINDER, verbose=False)
    start = want["case"].state
    build = cfdsim_tpu_torch.cases.build

    def from_jax_start(*args, **kw):
        case = build(*args, **kw)
        case.state = case.state._replace(
            u=torch.tensor(np.asarray(start.u), dtype=case.state.u.dtype),
            p=torch.tensor(np.asarray(start.p), dtype=case.state.p.dtype))
        return case

    monkeypatch.setattr(cfdsim_tpu_torch.cases, "build", from_jax_start)
    out = tmp_path / "fem"
    rep = drv.main(["100", "--t-final", "0.1", "--chunk-steps", "2", "--h-near", "0.3",
                    "--h-far", "1.5", "--device", "cpu", "--out", str(out)])
    res = rep["Re_100"]
    assert res["fx"].shape == want["fx"].shape == (2,)
    forces_close(res["fx"], res["fy"], want["fx"], want["fy"])
    accept = want["case"].cfg.accept_relres
    assert np.all(res["poisson_res"] < accept), res["poisson_res"]
    assert np.abs(np.asarray(want["state"].u) - np.asarray(start.u)).max() > 0.1
    for k in ("St", "Cd", "Cl_amp"):
        assert np.isfinite(res[k])
    assert res["steps"] == 2 and report_of(out)["Re_100"]["t"] > 0
    (step, (fields, _)), = csnap_steps(out / "Re_100" / "snapshots.csnap").items()
    assert step == 2 and fields["vorticity"].shape == (200, 300)
    assert {"u", "v", "p", "speed", "fem_u", "fem_p"} <= set(fields)
    assert np.isfinite(fields["fem_u"]).all() and np.isnan(fields["speed"]).any()
    assert np.abs(np.asarray(fields["fem_u"]).reshape(-1, 2) - np.asarray(start.u)).max() > 0.1


def test_cylinder_fem_render(tmp_path):
    """``--render``: the frames as PNGs and a video of each (matplotlib)."""
    from cfdsim_tpu_torch.examples import cylinder_fem as drv

    out = tmp_path / "fem"
    res = drv.run_re(100.0, t_final=0.1, chunk_steps=1, h_near=0.3, h_far=1.5, verbose=False,
                     device="cpu", out_dir=out, io="hdf5", render=True, n_frames=2)
    frames = out / "Re_100"
    assert len(list(frames.glob("vorticity_*.png"))) == 2
    assert len(list(frames.glob("velocity_*.png"))) == 2
    assert any(frames.glob("vorticity.*")) and res["snapshots"].suffix == ".h5"


def test_shedding_stats_matches_jax():
    from cfdsim_tpu_torch.examples import cylinder_fem as drv

    rng = np.random.default_rng(3)
    t = 0.05 * np.arange(1, 3001)
    fx = (0.7 + 0.02 * np.sin(2 * np.pi * 0.4 * t) + 0.01 * rng.standard_normal(3000))
    fy = 0.4 * np.sin(2 * np.pi * 0.2 * t + 0.3) + 0.02 * rng.standard_normal(3000)
    for tail_frac in (0.5, 0.3):
        got = drv.shedding_stats(fx.astype(np.float32), fy.astype(np.float32), 0.05, tail_frac)
        want = jax_example("cylinder_fem").shedding_stats(
            fx.astype(np.float32), fy.astype(np.float32), 0.05, tail_frac)
        np.testing.assert_allclose(got, want, rtol=0, atol=HOST_ATOL)
        assert abs(got[0] - 0.2) < 0.01


ST = dict(h_near=0.03, h_far=0.1, t_final=0.008, chunk_steps=2)


def test_schafer_turek_2d2_matches_jax(tmp_path):
    """fx, fy and the Poisson residual per step over two 2-step chunks on
    a 466-triangle mesh (the JAX series from its jitted chunks)."""
    from cfdsim_tpu_torch.examples import schafer_turek_2d2 as drv

    out = tmp_path / "st"
    res = drv.main(["--h-near", "0.03", "--h-far", "0.1", "--t", "0.008", "--chunk-steps", "2",
                    "--device", "cpu", "--out", str(out)])
    mod = jax_example("schafer_turek_2d2")
    mod.jax = proxy = JaxProxy()
    want = mod.run(**ST, verbose=False)
    fx = np.concatenate([np.asarray(o[1][0]) for o in proxy.outputs])
    fy = np.concatenate([np.asarray(o[1][1]) for o in proxy.outputs])
    res_j = np.concatenate([np.asarray(o[1][2]) for o in proxy.outputs])
    coeff = 2.0 / (1.0**2 * 0.1)
    assert res["cd_series"].shape == fx.shape == (4,)
    forces_close(res["cd_series"] / coeff, res["cl_series"] / coeff, fx, fy)
    assert np.all(res["poisson_res"] < 1e-3) and np.all(res_j < 1e-3)
    assert res["n_tris"] == want["n_tris"] == 466
    assert res["cd"] == pytest.approx(want["cd"], rel=FORCE_RTOL)
    rep = report_of(out)
    assert rep["steps"] == 4 and rep["scheme"] == "projection"
    (step, (fields, _)), = csnap_steps(out / "snapshots.csnap").items()
    assert step == 4 and fields["vorticity"].shape == (120, 640) and "fem_phi" in fields


def test_schafer_turek_analysis_matches_jax(monkeypatch):
    """A synthetic lift (St 0.3 with a harmonic and noise, 2000 steps at
    dt 0.002) fed to the JAX driver in place of its case and steps: the
    port's St by FFT and by zero crossings, Cd and Cl amplitude on the same
    series, to 1e-12."""
    import cfdsim_tpu.cases

    from cfdsim_tpu_torch.examples import schafer_turek_2d2 as drv

    rng = np.random.default_rng(11)
    dt, n = 0.002, 2000
    t = dt * np.arange(1, n + 1)
    fx = (1.6 + 0.01 * np.sin(2 * np.pi * 6.0 * t) + 1e-3 * rng.standard_normal(n))
    fy = (0.5 * np.sin(2 * np.pi * 3.0 * t) + 0.05 * np.sin(2 * np.pi * 9.0 * t)
          + 1e-3 * rng.standard_normal(n))
    fx, fy = fx.astype(np.float32), fy.astype(np.float32)
    extras = {"coeff_scale": 20.0, "diameter": 0.1, "u_mean": 1.0,
              "mesh": types.SimpleNamespace(n_tris=1)}
    fake = types.SimpleNamespace(extras=extras, state=None, step=None)
    monkeypatch.setattr(cfdsim_tpu.cases, "build", lambda *a, **k: fake)

    def synthetic(i, jitted, state, _):
        sl = slice(50 * i, 50 * (i + 1))
        return state, (fx[sl], fy[sl], np.zeros(50, np.float32))

    mod = jax_example("schafer_turek_2d2")
    for t_tail in (None, 1.3):
        mod.jax = JaxProxy(synthetic)
        want = mod.run(dt=dt, t_final=n * dt, t_tail=t_tail, chunk_steps=50, verbose=False)
        got = drv.lift_statistics(fx * 20.0, fy * 20.0, dt,
                                  0.5 * n * dt if t_tail is None else t_tail, 0.1, 1.0)
        for k in ("cd", "st", "st_zc", "cl_amp"):
            assert abs(got[k] - want[k]) <= HOST_ATOL, k
        assert abs(got["st"] - 0.3) < 0.01 and abs(got["st_zc"] - 0.3) < 0.01
