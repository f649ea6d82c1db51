"""``cfdsim_tpu_torch/validation.py`` (a numpy-only copy) against the JAX
package's ``validation.py``, the host-only ``viz`` pipeline, and the debug
utilities, on the CPU.

Tables and the numpy functions are held bit for bit; the shell spectrum,
which the JAX package computes with float32 FFTs on its device and the
port in float64 numpy, to 1e-5 relative of the spectrum's sum.
"""

import logging

import numpy as np
import pytest
import torch

from cfdsim_tpu import validation as jv
from cfdsim_tpu_torch import validation as tv
from cfdsim_tpu_torch.cases import lid_cavity
from cfdsim_tpu_torch.io_ import SnapshotWriter
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.utils import debug
from cfdsim_tpu_torch.viz import (
    make_video,
    plot_energy_history,
    render_frames_from_hdf5,
    thin_frames,
)

TABLES = [n for n in dir(jv) if n.isupper()]


def test_every_public_name_is_there():
    public = {n for n in dir(jv) if not n.startswith("_") and n not in ("np",)}
    assert public <= set(dir(tv))
    assert len(TABLES) == 5


@pytest.mark.parametrize("name", TABLES)
def test_tables_are_bit_equal(name):
    a, b = getattr(jv, name), getattr(tv, name)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (name, k)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


@pytest.mark.parametrize("Re", [100, 400, 1000])
def test_ghia_error_matches(Re):
    rng = np.random.default_rng(Re)
    n = 33
    u, v = (rng.standard_normal((n, n)).astype(np.float32) for _ in range(2))
    c = np.linspace(0.0, 1.0, n)
    assert tv.ghia_error(u, v, Re, c, c) == jv.ghia_error(u, v, Re, c, c)
    um, vm = rng.standard_normal((n, n + 1)), rng.standard_normal((n + 1, n))
    assert tv.ghia_error_mac(um, vm, Re) == jv.ghia_error_mac(um, vm, Re)


def test_ghia_error_of_the_tables_is_zero():
    n = 129
    c = np.linspace(0.0, 1.0, n)
    u = np.repeat(np.interp(c, tv.GHIA_Y, tv.GHIA_U[100])[:, None], n, 1)
    v = np.repeat(np.interp(c, tv.GHIA_X, tv.GHIA_V[100])[None, :], n, 0)
    eu, ev = tv.ghia_error(u, v, 100, c, c)
    assert eu < 1e-3 and ev < 1e-3


def test_strouhal_and_spectra_match():
    t = np.arange(2000) * 0.01
    sig = np.sin(2 * np.pi * 1.7 * t) + 0.1 * np.sin(2 * np.pi * 9.0 * t)
    assert tv.strouhal_number(sig, 0.01, 1.0, 1.0) == jv.strouhal_number(sig, 0.01, 1.0, 1.0)
    assert tv.strouhal_number(sig, 0.01, 1.0, 1.0) == pytest.approx(1.7, abs=0.06)
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal((2, 32, 48))
    for a, b in zip(tv.energy_spectrum(u, v, 2.0, 1.0), jv.energy_spectrum(u, v, 2.0, 1.0)):
        assert np.array_equal(a, b)


def test_energy_spectrum_parseval_and_peak():
    """tests/test_transport_viz.py:161, and the same shells as the JAX
    package's device FFT gives."""
    n = 64
    x = np.arange(n) * 2 * np.pi / n
    X, Y = np.meshgrid(x, x, indexing="xy")
    u = np.sin(4 * X) * np.cos(Y)
    v = -0.25 * np.cos(4 * X) * np.sin(Y)
    k, E = tv.energy_spectrum_shells(u, v)
    np.testing.assert_allclose(E.sum(), np.mean(0.5 * (u * u + v * v)), rtol=1e-5)
    assert k[np.argmax(E)] == 4
    kj, Ej = jv.energy_spectrum_shells(u, v)
    assert np.array_equal(k, kj) and np.abs(E - Ej).max() <= 1e-5 * E.sum()
    w3 = np.random.default_rng(0).standard_normal((16, 16, 16))
    k3, E3 = tv.energy_spectrum_shells(w3, w3 * 0.5, w3 * 0.25)
    tot = np.mean(0.5 * (w3**2 + 0.25 * w3**2 + 0.0625 * w3**2))
    mean_share = 0.5 * (w3.mean() ** 2 + (0.5 * w3).mean() ** 2 + (0.25 * w3).mean() ** 2)
    np.testing.assert_allclose(E3.sum(), tot - mean_share, rtol=1e-4)
    ks = np.arange(1, 30)
    assert abs(tv.spectrum_slope(ks, ks ** (-5.0 / 3.0), 2, 20) + 5 / 3) < 1e-6


@pytest.fixture(scope="module")
def snapshot_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    case = lid_cavity(n=32, Re=100.0, device="cpu")
    writer = SnapshotWriter(tmp / "cavity.h5")
    chunk = make_chunk(case.cfg, case.step, 50)
    st = case.state
    for _ in range(3):
        writer.save(int(st.step), float(st.t), u=st.u, v=st.v, p=st.p)
        st, _ = chunk(st, 1.0)
    return tmp, case


def test_render_frames_and_video(snapshot_file):
    """tests/test_transport_viz.py:74."""
    tmp, case = snapshot_file
    paths = render_frames_from_hdf5(tmp / "cavity.h5", tmp / "out", grid=case.grid,
                                    progress=False)
    assert len(paths["velocity"]) == 3 and len(paths["vorticity"]) == 3
    assert all(p.exists() for p in paths["velocity"])
    out = make_video(tmp / "out" / "velocity_frames", tmp / "movie.mp4", duration_s=1.0)
    assert out.exists() and out.stat().st_size > 0


def test_restore_helper(snapshot_file):
    """tests/test_transport_viz.py:106."""
    from cfdsim_tpu_torch.io_ import restore

    tmp, case = snapshot_file
    st = restore(case.state, tmp / "cavity.h5")
    assert int(st.step) == 100 and float(st.t) > 0.0  # the latest snapshot
    assert bool((st.u != 0).any())


def test_thin_frames_and_confirm(snapshot_file):
    """tests/test_transport_viz.py:88,192."""
    tmp, _ = snapshot_file
    d = tmp / "thin"
    d.mkdir(exist_ok=True)
    for i in range(10):
        (d / f"f_{i:03d}.png").write_bytes(b"x")
    r = thin_frames(d, keep_every=3, dry_run=True)
    assert r["deleted"] == 6 and len(list(d.glob("*.png"))) == 10
    asked = []
    r = thin_frames(d, keep_every=3, confirm=lambda q: asked.append(q) or "n")
    assert r["aborted"] and r["deleted"] == 0 and len(asked) == 1
    thin_frames(d, keep_every=3)
    assert len(list(d.glob("*.png"))) == 4


def test_energy_history_plot(tmp_path):
    hist = [{"step": s, "energy": 0.1 * np.exp(-s / 100)} for s in range(0, 500, 50)]
    assert plot_energy_history(hist, tmp_path / "energy.png").exists()


def _poisoned(case, at_step):
    """The case's step, with a NaN written into u at one step."""

    def step(state, cfl):
        new, m = case.step(state, cfl)
        if int(new.step) == at_step:
            u = new.u.clone()
            u[3, 3] = float("nan")
            new = new._replace(u=u)
        return new, m

    return step


def test_nan_watch_logs_the_step_and_takes_the_loop_route():
    case = lid_cavity(n=16, device="cpu")
    watched = debug.nan_watch(_poisoned(case, 2), name="cavity")
    assert watched.reads_host is True
    s = case.state
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    debug.log.addHandler(handler)
    try:
        for _ in range(2):
            s, _ = watched(s, 1.0)
    finally:
        debug.log.removeHandler(handler)
    hits = [r.getMessage() for r in records if "non-finite" in r.getMessage()]
    assert hits == ["cavity: non-finite state detected at step 2"]
    clean = debug.nan_watch(case.step)
    assert clean.cfg is case.cfg
    chunk = make_chunk(case.cfg, clean, 2, device="cpu")
    assert chunk.mode == "loop"
    out, _ = chunk(case.state, 1.0)
    assert int(out.step) == 2


def test_checked_returns_errors_as_data():
    case = lid_cavity(n=16, device="cpu")
    err, (state, _) = debug.checked(case.step)(case.state, 1.0)
    assert err is None and int(state.step) == 1
    bad = case.state._replace(u=torch.full_like(case.state.u, float("inf")))
    err, out = debug.checked(case.step)(bad, 1.0)
    assert isinstance(err, FloatingPointError) and out is None
    assert "non-finite value produced by" in str(err)


def test_enable_nan_checks_raises_at_the_first_bad_call():
    x = torch.zeros(3)
    debug.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            torch.log(x) * 0.0
        assert float((x + 1.0).sum()) == 3.0
    finally:
        debug.enable_nan_checks(False)
    assert bool(torch.isinf(torch.log(x)).all())  # off again: no error
