"""The port's 2D compressible tier (``models/compressible.py``, the
compressible ``ibm.py`` builders, ``monitor.check_compressible`` and the
cases ``wedge`` and ``cavity_supersonic``) against the JAX package, its
goldens and its physics, and the command line's ``run`` with ``--resume``
(the 3D ``blast3d`` too).

Tolerances:
- five steps from a developed state (50 jitted JAX steps first, both sides
  then start from the same U): U component by component within 1e-5 of
  max|component|, t within 1e-6 relative, each metric within 1e-5 of its
  magnitude (float32; XLA's jit contracts a·b + c into FMAs where eager
  torch rounds twice, and HLLC and minmod switch branches where their
  arguments cross zero, continuously); on the Sod tube for each flux ×
  reconstruction × time order, ``wedge`` at 48×24 in each of its three
  modes and ``cavity_supersonic`` at 60×24, pinned and real;
- the ghost map's arrays equal (indices) and within 1e-7 (weights); the
  masks equal;
- the goldens ``wedge_shock``, ``cavity_supersonic_pin`` and
  ``cavity_supersonic_real`` by the rule of tests/test_goldens.py (RTOL
  2e-5, noise floor 1e-6 of the largest key);
- the port's own physics: the Sod right star density 0.26557 within 3% at
  nx = 200 (tests/test_compressible.py:62), closed-box mass and energy to
  1e-4 (:115).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import ibm as jibm
from cfdsim_tpu import monitor as jmon
from cfdsim_tpu.cases import Case as JCase
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid as JGrid
from cfdsim_tpu.models import compressible as jcomp
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch import ibm
from cfdsim_tpu_torch.cases import Case, build
from cfdsim_tpu_torch.convert import (
    compressible_state_from_numpy,
    compressible_state_to_numpy,
)
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.io_ import restore
from cfdsim_tpu_torch.io_.native import csnap_steps
from cfdsim_tpu_torch.models import compressible as comp
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.monitor import check_compressible
from cfdsim_tpu_torch.solvers.riemann import cons_to_prim
from test_torch_mac import golden_deviation
from test_torch_sphere import golden_signature

GAMMA = 1.4
U_RTOL = 1e-5
T_RTOL = 1e-6
METRIC_RTOL = 1e-5
DEVELOP_STEPS = 50


def _jax_run(step, state, n_dev, n):
    """The JAX state after ``n_dev`` steps and after ``n_dev + n``, with the
    last step's metrics: the step jitted once (one compile) and called."""
    jstep = jax.jit(step)
    one = jnp.float32(1.0)
    for _ in range(n_dev):
        state, _ = jstep(state, one)
    s0 = state
    for _ in range(n):
        state, m = jstep(state, one)
    return s0, state, m


def compare_compressible_steps(jcase, tcase, n=5, n_dev=DEVELOP_STEPS):
    """Run the JAX case ``n_dev`` steps, hand both packages the same state,
    run ``n`` steps on each and hold U, t and the metrics to the bands of
    the module docstring. Returns the worst U deviation (over the band)."""
    s0, s1, jm = _jax_run(jcase.step, jcase.state, n_dev, n)
    state = type(tcase.state)(U=torch.tensor(np.asarray(s0.U)),
                              t=torch.tensor(np.float32(s0.t)),
                              step=torch.tensor(np.int32(s0.step)))
    for _ in range(n):
        state, tm = tcase.step(state, 1.0)
    want, got = np.asarray(s1.U), state.U.numpy()
    assert np.isfinite(got).all()
    worst = 0.0
    for c in range(want.shape[0]):
        scale = max(np.abs(want[c]).max(), np.finfo(np.float32).tiny)  # ρv ≡ 0 on the Sod tube
        dev = float(np.abs(got[c] - want[c]).max() / (U_RTOL * scale))
        worst = max(worst, dev)
        assert dev <= 1.0, (c, dev)
    assert abs(float(state.t) - float(s1.t)) <= T_RTOL * float(s1.t)
    assert int(state.step) == int(s1.step)
    for name, a in zip(tm._fields, tm):
        b = float(getattr(jm, name))
        assert abs(float(a) - b) <= METRIC_RTOL * max(abs(b), 1e-30), (name, float(a), b)
    return worst


def _sod_cases(nx=64, **cfg_kw):
    """The Sod tube of tests/test_compressible.py:62 on both packages:
    transmissive x, uniform y."""
    kw = dict(nx=nx, ny=8, x_max=1.0, y_max=0.04, centering="cell")
    jgrid, tgrid = JGrid(**kw), Grid(**kw)
    x = tgrid.x_coords()
    left = x < 0.5
    rho = np.repeat(np.where(left, 1.0, 0.125)[None, :], 8, 0).astype(np.float32)
    p = np.repeat(np.where(left, 1.0, 0.1)[None, :], 8, 0).astype(np.float32)
    zero = np.zeros_like(rho)

    def jbc(U, step, t):
        U = U.at[:, :, 0].set(U[:, :, 1])
        U = U.at[:, :, -1].set(U[:, :, -2])
        U = U.at[:, 0, :].set(U[:, 1, :])
        U = U.at[:, -1, :].set(U[:, -2, :])
        return U

    def tbc(U, step, t):
        U = U.clone()
        U[:, :, 0] = U[:, :, 1]
        U[:, :, -1] = U[:, :, -2]
        U[:, 0, :] = U[:, 1, :]
        U[:, -1, :] = U[:, -2, :]
        return U

    jcfg = jcomp.CompressibleConfig(grid=jgrid, cfl=0.4, **cfg_kw)
    tcfg = comp.CompressibleConfig(grid=tgrid, cfl=0.4, **cfg_kw)
    U0 = jcomp.prim_to_cons(jnp.asarray(rho), jnp.asarray(zero), jnp.asarray(zero),
                            jnp.asarray(p), GAMMA)
    jstate = jcomp.CompressibleState(U=U0, t=jnp.float32(0.0), step=jnp.int32(0))
    jcase = JCase("sod", jcfg, jcomp.make_step(jcfg, jbc), jstate, jgrid)
    tstate = compressible_state_from_numpy(np.asarray(U0), 0.0, 0, "cpu")
    tcase = Case("sod", tcfg, comp.make_step(tcfg, tbc, device="cpu"), tstate, tgrid)
    return jcase, tcase


@pytest.mark.parametrize("time_order", [1, 2])
@pytest.mark.parametrize("reconstruction", ["none", "muscl"])
@pytest.mark.parametrize("flux", ["rusanov", "hllc", "roe", "roe_ref"])
def test_sod_steps_match_jax(flux, reconstruction, time_order):
    jcase, tcase = _sod_cases(flux=flux, reconstruction=reconstruction, time_order=time_order)
    compare_compressible_steps(jcase, tcase)


WEDGE_MODES = {
    "zero_momentum": dict(),
    "ghost": dict(wall_treatment="ghost", reconstruction="muscl"),
    "wedge_aligned": dict(frame="wedge_aligned", reconstruction="muscl"),
}


@pytest.mark.parametrize("mode", sorted(WEDGE_MODES))
def test_wedge_steps_match_jax(mode):
    kw = dict(nx=48, ny=24, **WEDGE_MODES[mode])
    jcase, tcase = j_build("wedge", **kw), build("wedge", device="cpu", **kw)
    np.testing.assert_array_equal(tcase.state.U.numpy(), np.asarray(jcase.state.U))
    if mode != "wedge_aligned":
        np.testing.assert_array_equal(tcase.extras["wedge_mask"],
                                      np.asarray(jcase.extras["wedge_mask"]))
    compare_compressible_steps(jcase, tcase)


@pytest.mark.parametrize("real_geometry", [False, True])
def test_cavity_supersonic_steps_match_jax(real_geometry):
    kw = dict(nx=60, ny=24, real_geometry=real_geometry)
    jcase = j_build("cavity_supersonic", **kw)
    tcase = build("cavity_supersonic", device="cpu", **kw)
    np.testing.assert_array_equal(tcase.state.U.numpy(), np.asarray(jcase.state.U))
    key = "solid_mask" if real_geometry else "cavity_mask"
    np.testing.assert_array_equal(tcase.extras[key], np.asarray(jcase.extras[key]))
    compare_compressible_steps(jcase, tcase)


def test_ghost_map_and_masks_match_jax():
    kw = dict(nx=48, ny=24, x_max=2.0, y_max=1.0, centering="cell")
    jgrid, tgrid = JGrid(**kw), Grid(**kw)
    theta = np.deg2rad(10.0)
    want = jibm.wedge_slip_ghost_map(jgrid, theta, 0.5)
    got = ibm.wedge_slip_ghost_map(tgrid, theta, 0.5)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-7)
    cgrid = Grid(nx=60, ny=24, ng=2, x_max=2.0)
    cm = ibm.cavity_mask(cgrid, 0.5, 0.5, 0.25)
    assert cm.dtype == np.float32
    np.testing.assert_array_equal(cm, np.asarray(jibm.cavity_mask(
        JGrid(nx=60, ny=24, ng=2, x_max=2.0), 0.5, 0.5, 0.25)))
    # the ghost states written by the port's bilinear gathers
    rng = np.random.default_rng(0)
    U = jcomp.prim_to_cons(*(jnp.asarray(a, jnp.float32) for a in (
        0.5 + rng.random((24, 48)), rng.standard_normal((24, 48)),
        rng.standard_normal((24, 48)), 0.5 + rng.random((24, 48)))), GAMMA)
    jU = jibm.apply_slip_wall_ghosts(U, want, GAMMA)
    T = torch.tensor(np.asarray(U))
    tU = ibm.apply_slip_wall_ghosts(T, ibm.ghost_map_to(got, "cpu"), GAMMA)
    assert torch.equal(T, torch.tensor(np.asarray(U)))  # the input is not written
    assert np.abs(tU.numpy() - np.asarray(jU)).max() <= 1e-6 * np.abs(np.asarray(jU)).max()


@pytest.mark.parametrize("name,kwargs", [
    ("wedge_shock", dict(name="wedge", nx=120, ny=60)),
    ("cavity_supersonic_pin", dict(name="cavity_supersonic", nx=150, ny=45)),
    ("cavity_supersonic_real", dict(name="cavity_supersonic", nx=150, ny=45,
                                    real_geometry=True)),
])
def test_compressible_golden(name, kwargs):
    """tests/test_goldens.py:38, :57-61: 150 steps and the metrics of one
    more."""
    kwargs = dict(kwargs)
    sig = golden_signature(build(kwargs.pop("name"), device="cpu", **kwargs), 150)
    dev = golden_deviation(name, sig)
    assert set(sig) == set(dev), (sorted(sig), sorted(dev))
    assert max(dev.values()) <= 1.0, dev


def _run_to(case, t_end, chunk=50):
    run = make_chunk(case.cfg, case.step, chunk)
    state = case.state
    while float(state.t) < t_end:
        state, _ = run(state, 1.0)
    return state


def test_sod_star_density():
    """tests/test_compressible.py:62 at nx = 200: the right star plateau."""
    _, case = _sod_cases(nx=200, flux="hllc", reconstruction="muscl")
    st = _run_to(case, 0.2)
    rho = cons_to_prim(st.U, GAMMA)[0].numpy()
    x = case.grid.x_coords()
    sel = (x > 0.72) & (x < 0.82)
    assert rho[4, sel].mean() == pytest.approx(0.26557, rel=0.03)
    assert rho[4, (x > 0.02) & (x < 0.15)].mean() == pytest.approx(1.0, rel=0.01)


def test_closed_box_conserves_mass_and_energy():
    """tests/test_compressible.py:115: a density blob in a reflecting box,
    100 steps."""
    grid = Grid(nx=64, ny=64, centering="cell")
    cfg = comp.CompressibleConfig(grid=grid, flux="hllc", cfl=0.4)
    X, Y = grid.meshgrid()
    rho = torch.tensor(1.0 + 0.5 * np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2) / 0.01),
                       dtype=torch.float32)
    zero = torch.zeros_like(rho)
    U0 = comp.prim_to_cons(rho, zero, zero, torch.ones_like(rho), GAMMA)

    def bc(U, step, t):
        U = U.clone()
        U[:, :, 0] = U[:, :, 1]
        U[1, :, 0] = -U[1, :, 1]
        U[:, :, -1] = U[:, :, -2]
        U[1, :, -1] = -U[1, :, -2]
        U[:, 0, :] = U[:, 1, :]
        U[2, 0, :] = -U[2, 1, :]
        U[:, -1, :] = U[:, -2, :]
        U[2, -1, :] = -U[2, -2, :]
        return U

    step = comp.make_step(cfg, bc, device="cpu")
    state = compressible_state_from_numpy(U0.numpy(), 0.0, 0, "cpu")
    mass0, e0 = (float(state.U[c, 1:-1, 1:-1].sum()) for c in (0, 3))
    state, _ = make_chunk(cfg, step, 100)(state, 1.0)
    assert torch.isfinite(state.U).all()
    assert float(state.U[0, 1:-1, 1:-1].sum()) == pytest.approx(mass0, rel=1e-4)
    assert float(state.U[3, 1:-1, 1:-1].sum()) == pytest.approx(e0, rel=1e-4)


def test_check_compressible_matches_jax():
    base = dict(dt=np.full(3, 1e-3, np.float32), max_vel=np.array([1.0, 2.0, 3.0], np.float32),
                min_rho=np.full(3, 0.5, np.float32), min_p=np.full(3, 0.2, np.float32),
                energy=np.ones(3, np.float32), max_mach=np.full(3, 2.0, np.float32))
    for change in ({}, {"max_vel": np.array([1.0, 200.0, 3.0], np.float32)},
                   {"min_rho": np.array([0.5, -1.0, 0.5], np.float32)},
                   {"min_p": np.array([0.5, 1e-9, 0.5], np.float32)},
                   {"max_vel": np.array([1.0, np.nan, 3.0], np.float32)}):
        m = comp.CompressibleMetrics(**{**base, **change})
        jm = jcomp.CompressibleMetrics(**{**base, **change})
        a, b = check_compressible(m), jmon.check_compressible(jm)
        assert (a.ok, a.reason) == (b.ok, b.reason)


def test_state_round_trips_and_step_leaves_its_input():
    case = build("cavity_supersonic", nx=30, ny=12, device="cpu")
    d = compressible_state_to_numpy(case.state)
    assert d["U"].dtype == np.float32 and d["t"].dtype == np.float32
    back = compressible_state_from_numpy(d["U"], d["t"], d["step"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, case.state))
    with pytest.raises(ValueError, match="compressible"):
        compressible_state_from_numpy(d["U"][:3], 0.0, 0, "cpu")
    before = case.state.U.clone()
    case.step(case.state, 1.0)
    assert torch.equal(case.state.U, before)


@pytest.mark.parametrize("case,args,shape", [
    ("cavity_supersonic", ["--nx", "30", "--ny", "12"], (4, 16, 34)),
    ("blast3d", ["--n", "8"], (5, 8, 8, 8)),
])
def test_cli_run_cavity_supersonic_resume_bit_exact(tmp_path, case, args, shape):
    """``run`` of a compressible case (the 2D one under the compressible
    health check) for 20 steps with native snapshots and a ``--resume``
    against one run, bit for bit, in U's shape."""
    common = [*args, "--chunk-steps", "10", "--snapshot-interval", "10", "--device", "cpu",
              "--io", "native", "--t-final", "100"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", case, "--max-steps", "10", "--out", str(out_a), *common])
    report = cli.main(["run", case, "--max-steps", "20", "--out", str(out_a), "--resume",
                       *common])
    assert report["final_step"] == 20 and not report["stopped_reason"]
    cli.main(["run", case, "--max-steps", "20", "--out", str(out_b), *common])
    a, b = csnap_steps(out_a / "snapshots.csnap"), csnap_steps(out_b / "snapshots.csnap")
    assert sorted(a) == sorted(b) == [0, 10, 20]
    for step in a:
        assert {k: v.shape for k, v in a[step][0].items()} == {"U": shape}
        np.testing.assert_array_equal(a[step][0]["U"], b[step][0]["U"])
    template = build(case, device="cpu", **cli._extra_kwargs(args))
    ra, rb = (restore(template.state, p / "snapshots.csnap") for p in (out_a, out_b))
    assert all(torch.equal(x, y) for x, y in zip(ra, rb)) and int(ra.step) == 20
