"""The port's 3D study drivers (``cfdsim_tpu_torch/examples/sphere_wake.py``,
``tgv3d_les.py``, ``sphere_les_re3900.py``) against the JAX package's
drivers of the same name, at a tiny size on the CPU: the per-step series
each returns, its host-side analysis fed the same series, its files, and
the Re = 3900 study's checkpoint and resume.

Tolerances: the per-step series within 1e-5 of the series' largest |value|
(the steps match to ≤ 3.4e-7 a step; measured, of that scale: Cd 3.7e-7,
dt 1.5e-7, E 4.8e-7, the probes' v 2.3e-6); the lateral force coefficients, which
are roundoff (≤ 1e-9) on these axisymmetric starts, within 1e-5 of the
largest |Cd|, the body force's scale; the host-side analysis (the
recirculation length, the ε(t) smoothing and its peak, the spectrum slope)
fed the JAX driver's own series or state, to 1e-12; the resume bit for bit.
"""

import numpy as np
import pytest
import torch

from cfdsim_tpu_torch.io_.native import csnap_steps
from test_torch_examples import JaxProxy, jax_example, one_torch_thread, report_of  # noqa: F401

SERIES_RTOL = 1e-5
HOST_ATOL = 1e-12


def close(got, want, scale=None):
    """``got`` within SERIES_RTOL of ``scale`` (default max |want|)."""
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=SERIES_RTOL * scale)


def synthetic_wake(shape, i_from, i_to, seed):
    """A positive random u with reverse flow on x faces [i_from, i_to) of
    the four centreline rows."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.2, 1.0, shape).astype(np.float32)
    k, j = shape[0] // 2, shape[1] // 2
    u[k - 1:k + 1, j - 1:j + 1, i_from:i_to] = -rng.uniform(0.1, 0.5, (2, 2, i_to - i_from))
    return u


@pytest.mark.parametrize("flags,kw,wake", [
    ([], {}, (10, 14)),
    (["--stretched", "--heated", "--ibm", "ghost", "--theta-scheme", "tvd"],
     dict(stretched=True, heated=True, ibm_scheme="ghost", theta_scheme="tvd"), (20, 26)),
], ids=["penalized", "heated_stretched_ghost"])
def test_sphere_wake_matches_jax(tmp_path, flags, kw, wake):
    """Cd, Cl_y, Cl_z, dt (and Nu) per step of one 5-step chunk at 2
    cells/D (32×16×16); the JAX driver's recirculation length, computed on a
    synthetic reverse-flow u put in its final state, equals the port's on
    the same u."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.examples import sphere_wake as drv

    out = tmp_path / "sphere"
    res = drv.main(["--n", "2", "--t", "0.05", "--chunk-steps", "5", *flags, "--device", "cpu",
                    "--out", str(out)])
    u_syn = synthetic_wake((16, 16, 33), *wake, seed=len(flags))

    def with_synthetic_u(n, jitted, *args):
        state, series = jitted(*args)
        return state._replace(u=state.u.at[:].set(u_syn)), series

    mod = jax_example("sphere_wake")
    mod.jax = proxy = JaxProxy(with_synthetic_u)
    want = mod.run_sphere(cells_per_d=2, t_final=0.05, chunk_steps=5, verbose=False, **kw)
    (_, (fx, fy, fz, dt, nus)), = proxy.outputs
    cs = res["coeff_scale"]
    assert res["fx"].shape == (5,)
    cd_j = np.asarray(fx) * cs
    close(res["fx"] * cs, cd_j)
    for got, ref in ((res["fy"], fy), (res["fz"], fz)):
        close(got * cs, np.asarray(ref) * cs, scale=np.abs(cd_j).max())
    close(res["dt"], dt)
    close(res["nusselt"], nus, scale=max(np.abs(np.asarray(nus)).max(), 1.0))
    assert res["cd"] == pytest.approx(want["cd"], rel=SERIES_RTOL)
    assert res["cd_sn"] == want["cd_sn"]
    if kw.get("heated"):
        assert res["nu"] == pytest.approx(want["nu"], rel=SERIES_RTOL)
        assert res["nu_rm"] == want["nu_rm"]

    name = "heated_sphere_stretched" if kw.get("stretched") else "sphere"
    case = build(name, nx=32, ny=16, nz=16, domain=(16.0, 8.0, 8.0), center=(4.0, 4.0, 4.0),
                 device="cpu")
    l_r_d = drv.recirculation_length(u_syn, drv.face_x(case, kw.get("stretched", False)), 4.0,
                                     0.5)
    assert l_r_d > 0.5 and abs(l_r_d - want["l_r_d"]) <= HOST_ATOL

    rep = report_of(out)
    assert rep["steps"] == 5 and rep["cd"] == pytest.approx(res["cd"])
    (step, (fields, _)), = csnap_steps(out / "snapshots.csnap").items()
    assert step == 5 and fields["u"].shape == (16, 16, 33)
    assert ("theta" in fields) == bool(kw.get("heated"))


@pytest.mark.parametrize("model", ["smagorinsky", "dynamic"])
def test_tgv3d_les_matches_jax(tmp_path, model):
    """E(t) and the dt sequence over two 5-step chunks at 8³; the port's ε
    smoothing and spectrum slope fed the JAX driver's (t, E) and E(k)."""
    from cfdsim_tpu_torch.examples import tgv3d_les as drv

    out = tmp_path / "tgv"
    res = drv.main(["--n", "8", "--t-final", "1.0", "--chunk", "5", "--model", model,
                    "--device", "cpu", "--out", str(out)])
    want = jax_example("tgv3d_les").run_tgv(n=8, t_final=1.0, chunk=5, les_model=model,
                                             verbose=False)
    assert len(res["E"]) == len(want["E"]) == 11
    close(res["E"], want["E"])
    close(np.diff(res["t"]), np.diff(want["t"]))
    close(res["E_k"], want["E_k"])
    eps = drv.dissipation_rate(want["t"], want["E"])
    for k in ("t_eps", "eps"):
        np.testing.assert_allclose(eps[k], want[k], rtol=0, atol=HOST_ATOL)
    assert abs(eps["eps_peak"] - want["eps_peak"]) <= HOST_ATOL
    assert eps["t_peak"] == want["t_peak"]
    assert abs(drv.inertial_slope(want["k"], want["E_k"], 8) - want["slope"]) <= HOST_ATOL
    rep = report_of(out)
    assert rep["steps"] == 10 and rep["model"] == f"LES/{model}"
    (fields, _), = csnap_steps(out / "snapshots.csnap").values()
    assert fields["w"].shape == (9, 8, 8) and np.isfinite(fields["u"]).all()


def test_tgv3d_no_les_runs(tmp_path):
    from cfdsim_tpu_torch.examples import tgv3d_les as drv

    res = drv.main(["--n", "8", "--t-final", "0.2", "--chunk", "2", "--no-les", "--max-steps",
                    "2", "--device", "cpu", "--out", str(tmp_path)])
    assert report_of(tmp_path)["model"] == "no-model" and len(res["dt"]) == 2


RE3900 = dict(nx=32, ny=16, nz=16, t_final=0.05, t_tail=0.0, chunk_steps=5)


def re3900_args(out, *extra):
    return ["--nx", "32", "--ny", "16", "--nz", "16", "--chunk-steps", "5", "--tail", "0",
            "--device", "cpu", "--out", str(out), *extra]


def test_sphere_les_re3900_matches_jax_and_resumes_its_checkpoint(tmp_path):
    """Cd, Cl_y, Cl_z, t and the four probes' v over one 5-step chunk
    (from the JAX driver's series file: its analysis of so short a tail
    raises, where the port's gives NaN frequencies); then the port resumes
    the JAX driver's checkpoint: the state read bit for bit, the series rows
    kept, one chunk more."""
    from cfdsim_tpu_torch.examples import sphere_les_re3900 as drv

    jsave = str(tmp_path / "jax_series.npz")
    with pytest.raises(ValueError, match="empty sequence"):
        jax_example("sphere_les_re3900").run(**RE3900, verbose=False, save=jsave, ckpt_every=1)
    js = np.load(jsave)
    out = tmp_path / "port"
    res = drv.main(re3900_args(out, "--t", "0.05"))
    assert len(res["t"]) == 5
    close(res["cd"], js["cd"])
    for k in ("cly", "clz"):
        close(res[k], js[k], scale=np.abs(js["cd"]).max())
    close(res["t"], js["t"])
    close(res["probe_v"], js["probe_v"])
    assert np.isfinite(res["st"]) and np.isnan(res["st_wake"])
    assert np.isnan(res["st_probe"]).all() and np.isfinite(res["cd_mean"])
    rep = report_of(out)
    assert rep["steps"] == 5 and np.isnan(rep["st_wake"])
    assert csnap_steps(out / "snapshots.csnap").keys() == {5}

    ckpt = np.load(f"{jsave}.state.npz")
    resumed = drv.run(**{**RE3900, "t_final": 1e9}, save=jsave, resume=True, device="cpu",
                      max_steps=5, verbose=False)
    st = resumed["state"]
    for k in ("u", "v", "w", "p"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), ckpt[k])
    assert int(st.step) == 5 and float(st.t) == float(ckpt["t"])
    np.testing.assert_array_equal(resumed["cd"], js["cd"])
    more = drv.run(**{**RE3900, "t_final": 1e9}, save=jsave, resume=True, device="cpu",
                   max_steps=10, verbose=False)
    assert int(more["state"].step) == 10 and len(more["t"]) == 10
    np.testing.assert_array_equal(more["probe_v"][:5], js["probe_v"])


def test_sphere_les_re3900_resume_is_bit_exact(tmp_path):
    """One chunk, a checkpoint, a resume and one chunk: the series and the
    state of two uninterrupted chunks, bit for bit (the checkpoint holds
    the whole state: u, v, w, p, t, step)."""
    from cfdsim_tpu_torch.examples import sphere_les_re3900 as drv

    kw = {**RE3900, "t_final": 1e9, "verbose": False, "device": "cpu",
          "les_model": "dynamic"}
    whole = drv.run(**kw, max_steps=10)
    save = str(tmp_path / "series.npz")
    drv.run(**kw, max_steps=5, save=save, ckpt_every=1)
    part = drv.run(**kw, max_steps=10, save=save, resume=True)
    for k in ("t", "cd", "cly", "clz", "probe_v"):
        np.testing.assert_array_equal(part[k], whole[k], err_msg=k)
    for k in ("u", "v", "w", "p", "t", "step"):
        assert torch.equal(getattr(part["state"], k), getattr(whole["state"], k)), k
    series = np.load(save)
    np.testing.assert_array_equal(series["cd"], whole["cd"])
    assert series["probe_pts"].shape == (4, 3)


def test_sphere_les_re3900_resume_guard(tmp_path):
    """A checkpoint without its series file, and one whose fields do not
    fit the grid, are refused (the JAX driver loads both unchecked)."""
    from cfdsim_tpu_torch.examples import sphere_les_re3900 as drv

    save = tmp_path / "series.npz"
    grid = dict(nx=32, ny=16, nz=16)
    shapes = {"u": (16, 16, 33), "v": (16, 17, 32), "w": (17, 16, 32), "p": (16, 16, 32)}
    np.savez(f"{save}.state.npz", **{k: np.zeros(s, np.float32) for k, s in shapes.items()},
             t=0.5, step=10)
    with pytest.raises(FileNotFoundError, match="no series file"):
        drv.run(**grid, save=str(save), resume=True, device="cpu", verbose=False)
    np.savez(save, t=np.zeros(3, np.float32), cd=np.zeros(3), cly=np.zeros(3), clz=np.zeros(3),
             probe_v=np.zeros((3, 4)))
    shapes["v"] = (16, 16, 32)
    np.savez(f"{save}.state.npz", **{k: np.zeros(s, np.float32) for k, s in shapes.items()},
             t=0.5, step=10)
    with pytest.raises(ValueError, match="v has shape"):
        drv.run(**grid, save=str(save), resume=True, device="cpu", verbose=False)


def test_sphere_les_re3900_short_tail_gives_nan_frequencies():
    """The frequency analysis alone: a tail with no bin in the probe band,
    one of two samples and an empty one give NaN, not an error."""
    from cfdsim_tpu_torch.examples.sphere_les_re3900 import wake_frequencies

    t = np.linspace(0.01, 0.05, 5)
    z = np.sin(40 * t)
    pv = np.stack([z] * 4, axis=1)
    r = wake_frequencies(t, 1 + z, z, z, pv, 0.0)
    assert np.isfinite(r["st"]) and np.isnan(r["st_wake"]) and np.isnan(r["st_probe"]).all()
    r = wake_frequencies(t, 1 + z, z, z, pv, 0.035)
    assert np.isnan(r["st"]) and r["cd_mean"] == pytest.approx(np.mean(1 + z[-2:]))
    r = wake_frequencies(t, 1 + z, z, z, pv, 1.0)
    assert np.isnan(r["cd_mean"]) and np.isnan(r["st"])
