"""Boussinesq convection in the port (``models/boussinesq.py``, the cases
``heated_cavity`` and ``rayleigh_benard``) against the JAX package's
``cfdsim_tpu.models.boussinesq``: five steps from a developed state, the
conducting limit, the golden ``heated_cavity_32``, a native-snapshot
resume of θ, and the command line's ``run heated_cavity``.

Tolerances (five steps from the state after 20 jitted JAX steps):
- u, v within 1e-6 of max|u, v|; θ within 1e-6 of max|θ|; p within 1e-5
  of max|p|; every metric within 1e-5 relative, except ``div_post`` (float32
  roundoff on each side, ≤ 1e-5·max|u|/h: at 32² the two packages are
  2.7e-4 and 3.3e-4 apart by 22%).
- Rayleigh–Bénard at ny = 16 starts from a 1e-3 θ disturbance: its
  velocity (max 4.4e-3) is the small difference of the buoyancy impulse
  dt·Ra·Pr·θ (1.6) and the pressure gradient that cancels it, so u, v are
  held to 5e-6 of that impulse (observed 1.4e-6; 5e-4 of max|u| itself),
  and its ``div_post`` to 1e-5 of the impulse over h.
- The golden (300 steps at 32², Ra = 1e4) by the rule of
  tests/test_goldens.py:112-124: RTOL 2e-5, the noise floor 1e-6 of the
  largest key for keys below it.
- The conducting state (Ra = 0): Nu = 1 within 1e-3 and |u| < 1e-6 (the
  twin of tests/test_boussinesq.py:51).

The de Vahl Davis gate and the onset bracket (the twins of
tests/test_boussinesq.py:23 and :97) run thousands of steps and are marked
``slow``; ``chip_smoke.py`` runs both on the card.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import boussinesq_state_from_numpy, state_to_numpy
from cfdsim_tpu_torch.io_ import restore
from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter, csnap_steps
from cfdsim_tpu_torch.models import boussinesq as bq
from cfdsim_tpu_torch.models.incompressible import make_chunk

UV_RTOL = THETA_RTOL = 1e-6
P_RTOL = 1e-5
METRIC_RTOL = 1e-5
DIV_POST_RTOL = 1e-5
RB_IMPULSE_RTOL = 5e-6
GOLDEN_RTOL = 2e-5
GOLDENS = json.loads((Path(__file__).parent / "goldens.json").read_text())


def _to_port(js):
    return boussinesq_state_from_numpy(
        *(np.asarray(getattr(js, k)) for k in ("u", "v", "p", "theta", "t", "step")),
        device="cpu")


@pytest.mark.parametrize("name, kw", [
    ("heated_cavity", dict(n=32, Ra=1e4)),
    ("heated_cavity", dict(n=32, Ra=1e4, theta_scheme="upwind")),
    ("heated_cavity", dict(n=32, Ra=1e3, flow_scheme="tvd", adaptive_dt=False, dt_base=2e-4)),
    ("rayleigh_benard", dict(ny=16)),
], ids=["central", "upwind", "tvd-fixed-dt", "rayleigh_benard"])
def test_five_steps_match_jax(name, kw):
    j = j_build(name, **kw)
    t = build(name, device="cpu", **kw)
    assert t.step.reads_host is False
    j_step = jax.jit(j.step)
    js = j.state
    for _ in range(20):
        js, _ = j_step(js, jnp.float32(1.0))
    ts = _to_port(js)
    for _ in range(5):
        js, jm = j_step(js, jnp.float32(1.0))
        ts, tm = t.step(ts, 1.0)
    got = state_to_numpy(ts)
    cfg = t.cfg
    vel = max(np.abs(np.asarray(js.u)).max(), np.abs(np.asarray(js.v)).max())
    if name == "rayleigh_benard":
        # the predictor's velocity scale, of which u is the small remainder
        vel = float(jm.dt) * cfg.rayleigh * cfg.prandtl * float(jm.theta_max)
        uv_band = RB_IMPULSE_RTOL * vel
    else:
        uv_band = UV_RTOL * vel
    for k in ("u", "v"):
        assert np.abs(got[k] - np.asarray(getattr(js, k))).max() <= uv_band, k
    want_t = np.asarray(js.theta)
    assert np.abs(got["theta"] - want_t).max() <= THETA_RTOL * np.abs(want_t).max()
    want_p = np.asarray(js.p)
    assert np.abs(got["p"] - want_p).max() <= P_RTOL * np.abs(want_p).max()
    assert got["step"] == int(js.step) and abs(got["t"] - float(js.t)) <= 1e-6
    h = min(cfg.grid.dx, cfg.grid.dy)
    for field in jm._fields:
        a, b = float(getattr(jm, field)), float(getattr(tm, field))
        if field == "div_post":
            assert a <= DIV_POST_RTOL * vel / h and b <= DIV_POST_RTOL * vel / h, (a, b)
        else:
            assert abs(a - b) <= METRIC_RTOL * max(abs(a), 1e-12), (field, a, b)
    # the runner's names
    assert torch.equal(tm.div_pre, tm.div_post) and float(tm.vort_max) == 0.0
    assert float(tm.poisson_res) == 0.0


def test_theta_ghost_matches_jax():
    from cfdsim_tpu.models.boussinesq import _theta_ghost as j_ghost

    th = np.random.default_rng(5).random((12, 16)).astype(np.float32)
    for axis in ("x", "y"):
        want = np.asarray(j_ghost(jnp.asarray(th), 1.0, 0.25, axis))
        got = bq._theta_ghost(torch.tensor(th), 1.0, 0.25, axis).numpy()
        assert np.array_equal(got, want), axis


def test_initial_states_match_jax():
    for name, kw in (("heated_cavity", dict(n=16)), ("rayleigh_benard", dict(ny=8)),
                     ("heated_cavity", dict(n=16, heated_axis="y"))):
        j = j_build(name, **kw)
        t = build(name, device="cpu", **kw)
        for k in ("u", "v", "p", "theta"):
            assert np.array_equal(np.asarray(getattr(j.state, k)), getattr(t.state, k).numpy())


def test_refused_options_raise():
    with pytest.raises(ValueError, match="theta_scheme"):
        build("heated_cavity", n=8, theta_scheme="quick", device="cpu")
    with pytest.raises(ValueError, match="heated_axis"):
        build("heated_cavity", n=8, heated_axis="z", device="cpu")


def test_zero_ra_stays_conductive():
    case = build("heated_cavity", n=32, Ra=0.0, device="cpu")
    chunk = make_chunk(case.cfg, case.step, 100)
    s = case.state
    while float(s.t) < 0.1:
        s, m = chunk(s, 1.0)
    assert float(s.u.abs().max()) < 1e-6 and float(s.v.abs().max()) < 1e-6
    assert abs(float(m.nu_hot_wall[-1]) - 1.0) <= 1e-3


def _signature(case, steps):
    """tests/test_goldens.py::_run_signature on the port."""
    chunk = make_chunk(case.cfg, case.step, steps)
    s, _ = chunk(case.state, 1.0)
    _, m = case.step(s, 1.0)
    sig = {}
    for name in s._fields:
        v = getattr(s, name)
        if v.ndim >= 2:
            sig[f"l2_{name}"] = float(torch.sqrt((v * v).mean()))
            sig[f"max_{name}"] = float(v.abs().max())
    for name in ("energy", "max_vel", "vort_max"):
        sig[name] = float(getattr(m, name))
    return sig


def test_golden_heated_cavity_32():
    ref = GOLDENS["heated_cavity_32"]
    sig = _signature(build("heated_cavity", n=32, Ra=1e4, device="cpu"), 300)
    atol = 1e-6 * max(abs(v) for v in ref.values())
    assert set(sig) == set(ref)
    for key, want in ref.items():
        tol = GOLDEN_RTOL * abs(want) if abs(want) > atol else atol
        assert abs(sig[key] - want) <= tol, (key, sig[key], want)


def test_native_snapshot_restores_theta(tmp_path):
    case = build("heated_cavity", n=16, Ra=1e3, device="cpu")
    s, _ = make_chunk(case.cfg, case.step, 40)(case.state, 1.0)
    writer = NativeSnapshotWriter(tmp_path / "bq.csnap")
    writer.save(int(s.step), float(s.t), u=s.u, v=s.v, p=s.p, theta=s.theta)
    writer.close()
    restored = restore(case.state, tmp_path / "bq.csnap")
    for k in s._fields:
        assert torch.equal(getattr(restored, k), getattr(s, k)), k
    a, _ = case.step(restored, 1.0)
    b, _ = case.step(s, 1.0)
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in a._fields)


def test_cli_run_heated_cavity_resume_bit_exact(tmp_path):
    """``run heated_cavity --n 32``, 20 steps, and a native-snapshot
    ``--resume`` of it against one uninterrupted run (tests/test_cli.py:128)."""
    common = ["--n", "32", "--chunk-steps", "10", "--snapshot-interval", "10", "--device", "cpu",
              "--io", "native"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", "heated_cavity", "--max-steps", "10", "--out", str(out_a), *common])
    report = cli.main(["run", "heated_cavity", "--max-steps", "20", "--out", str(out_a),
                       "--resume", *common])
    assert report["final_step"] == 20 and report["total_steps"] == 10
    assert report["chunk_route"] == "loop" and not report["stopped_reason"]
    cli.main(["run", "heated_cavity", "--max-steps", "20", "--out", str(out_b), *common])
    a, b = csnap_steps(out_a / "snapshots.csnap"), csnap_steps(out_b / "snapshots.csnap")
    assert sorted(a) == sorted(b) == [0, 10, 20]
    for step in a:
        assert set(a[step][0]) == {"u", "v", "p", "theta"}
        for name in a[step][0]:
            np.testing.assert_array_equal(a[step][0][name], b[step][0][name])


def _run_to(case, t_end, chunk_steps=500):
    chunk = make_chunk(case.cfg, case.step, chunk_steps)
    s, m = case.state, None
    while float(s.t) < t_end:
        s, m = chunk(s, 1.0)
    return s, m


@pytest.mark.slow
def test_de_vahl_davis_ra1e3():
    """tests/test_boussinesq.py:23: Nu = 1.118, max velocity ≈ 3.70."""
    s, m = _run_to(build("heated_cavity", n=48, Ra=1e3, device="cpu"), 0.6)
    nu_wall, nu_mid = float(m.nu_hot_wall[-1]), float(m.nu_mid[-1])
    assert abs(nu_wall - 1.118) <= 0.02 * 1.118 and abs(nu_mid - 1.118) <= 0.02 * 1.118
    assert abs(nu_wall - nu_mid) <= 5e-3 * nu_mid
    assert abs(float(m.max_vel[-1]) - 3.70) <= 0.05 * 3.70
    assert float(m.theta_min[-1]) > -1e-3 and float(m.theta_max[-1]) < 1.0 + 1e-3
    assert float(m.div_post[-1]) < 1e-3


@pytest.mark.slow
def test_rayleigh_benard_onset_bracket():
    """tests/test_boussinesq.py:97: Ra = 1200 decays, Ra = 3000 grows."""
    _, m = _run_to(build("rayleigh_benard", ny=32, aspect=2.0, Ra=1200.0, device="cpu"), 1.0)
    assert float(m.max_vel[-1]) < 1e-3 and abs(float(m.nu_hot_wall[-1]) - 1.0) <= 1e-3
    _, m = _run_to(build("rayleigh_benard", ny=32, aspect=2.0, Ra=3000.0, device="cpu"), 5.0)
    assert float(m.max_vel[-1]) > 5.0 and float(m.nu_hot_wall[-1]) > 1.3
    assert abs(float(m.nu_hot_wall[-1]) - float(m.nu_mid[-1])) <= 0.02 * float(m.nu_mid[-1])
