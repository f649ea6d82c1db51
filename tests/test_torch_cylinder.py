"""The immersed-cylinder slice of the port against the JAX package: the IBM
geometry, the upwind and SUPG convection, the inflow BCs, five steps of
the case in three configurations, five steps of the multigrid cavity with
kernel smoothing, the CLI and the state's round trip.

Tolerances:
- masks and initial fields: bit for bit (the same numpy code).
- operators (upwind, SUPG, τ, IBM, BCs), one call eagerly on both sides:
  atol 1e-6 relative to the output's max (observed: bit-equal, except the
  BCs' sin, ≤ 1 ulp).
- five steps from the same initial state (``STEP_*``): u and v atol 1e-5,
  the cavity's band (tests/test_torch_cavity.py; observed ≤ 1.9e-6). p
  relative 1e-4 of max|p|: after the divide by dt ~ 2e-5 the pressure is
  O(1e3-1e4), and a warm-started 100-sweep solve carries last-bit
  differences of the rhs (XLA's FMA contraction, sums in another order)
  from step to step (observed ≤ 5.4e-5). Metrics relative 5e-5 (observed
  ≤ 5.5e-6), except: the forces, held to 2e-5 of the larger of |fx|, |fy|
  (fy is a small cancellation of O(fx) terms; observed ≤ 6.1e-6); and
  ``poisson_res``. For the exact DCT solve it is the rhs's mean (the
  direct solve drops the k=0 mode; the channel's, agreeing to ≤ 5e-4
  relative) plus the FFT's rounding noise amplified by ∇², whose size
  depends on the summation order (observed ≤ 4.7e-6 of max|rhs| =
  div_pre/dt at the cylinder's first step): held to 1e-2 relative (the
  cavity's band) plus 1e-5 of max|rhs|. For the iterative solves, relative
  2e-3 (observed ≤ 6.1e-4, the multigrid cavity).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import boundary as jb
from cfdsim_tpu import ibm as jibm
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid as JGrid
from cfdsim_tpu.ops import convection as jconv
from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch import boundary as tb
from cfdsim_tpu_torch import ibm as tibm
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import state_from_numpy, state_to_numpy
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ops import convection as tconv
from cfdsim_tpu_torch.ops.kernels import poisson_rb as rb
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

OP_RTOL = 1e-6
STEP_ATOL = 1e-5
P_RTOL = 1e-4
METRIC_RTOL = 5e-5
FORCE_RTOL = 2e-5
DIRECT_RES_RTOL = 1e-2
DIRECT_RES_NOISE = 1e-5
ITER_RES_RTOL = 2e-3
GEOMETRY = dict(nx=120, ny=36)  # the 600×180 grid of the 20×4 domain at 1/5
RB_PALLAS = dict(method="rbsor_pallas", iters=100, tol=1e-8, check_every=50, omega=1.7)


def _grids(nx=120, ny=36):
    kw = dict(nx=nx, ny=ny, x_max=20.0, y_max=4.0)
    return JGrid(**kw), Grid(**kw)


def _close(got, want, rtol=OP_RTOL):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= rtol * max(1.0, float(np.abs(want).max()))


def test_masks_and_potential_flow_bit_equal():
    jg, tg = _grids()
    js, ji = jibm.cylinder_masks(jg, (4.0, 2.0), 0.5)
    ts, ti = tibm.cylinder_masks(tg, (4.0, 2.0), 0.5)
    assert np.array_equal(ts, np.asarray(js)) and ts.dtype == bool
    assert np.array_equal(ti, np.asarray(ji)) and ti.dtype == np.float32
    assert ts.sum() > 0 and (ti > 0).sum() > ts.sum()
    for a, b in zip(tibm.potential_flow_cylinder(tg, (4.0, 2.0), 0.5, 1.0, ti),
                    jibm.potential_flow_cylinder(jg, (4.0, 2.0), 0.5, 1.0, ji)):
        assert np.array_equal(a, np.asarray(b)) and a.dtype == np.float32


def _fields(shape=(36, 120), seed=3):
    rng = np.random.default_rng(seed)
    u, v, phi = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    u[5:9, 7:11] = 0.0  # stagnation cells: τ = dt/2 there
    v[5:9, 7:11] = 0.0
    return u, v, phi


@pytest.mark.parametrize("op", ["upwind", "supg", "supg_refparity", "supg_tau"])
def test_convection_matches_jax(op):
    u, v, phi = _fields()
    dx, dy, dt = 20.0 / 119, 4.0 / 35, 2e-5
    nu = float(np.float32(np.float32(1.0 / 600) + np.float32(1e-3)))
    ju, jv, jp = (jnp.asarray(a) for a in (u, v, phi))
    tu, tv, tphi = (torch.from_numpy(a) for a in (u, v, phi))
    jtau = jconv.supg_tau(ju, jv, dx, dy, jnp.float32(dt), jnp.full(u.shape, nu, jnp.float32))
    ttau = tconv.supg_tau(tu, tv, dx, dy, torch.tensor(dt, dtype=torch.float32), nu)
    if op == "upwind":
        want = jconv.convection_upwind(ju, jv, jp, dx, dy)
        got = tconv.convection_upwind(tu, tv, tphi, dx, dy)
    elif op == "supg_tau":
        want, got = jtau, ttau
        assert float(got[6, 8]) == pytest.approx(dt / 2)
    else:
        parity = op == "supg_refparity"
        want = jconv.convection_supg(ju, jv, jp, dx, dy, jtau, ref_parity=parity)
        got = tconv.convection_supg(tu, tv, tphi, dx, dy, ttau, ref_parity=parity)
    _close(got, want)


@pytest.mark.parametrize("step", [0, 1, 3, 5])
def test_ibm_ramp_and_apply_match_jax(step):
    _, tg = _grids()
    _, ibm = tibm.cylinder_masks(tg, (4.0, 2.0), 0.5)
    u, v, _ = _fields()
    js = jibm.ibm_ramp(jnp.int32(step), 4)
    ts = tibm.ibm_ramp(torch.tensor(step, dtype=torch.int32), 4)
    assert float(ts) == float(js)
    for got, want in zip(tibm.apply_ibm(torch.from_numpy(u), torch.from_numpy(v),
                                        torch.from_numpy(ibm), ts),
                         jibm.apply_ibm(jnp.asarray(u), jnp.asarray(v), jnp.asarray(ibm), js)):
        _close(got, want)
    assert float(tibm.ibm_ramp(torch.tensor(step, dtype=torch.int32), 0)) == 1.0


@pytest.mark.parametrize("step", [0, 7, 500, 1500])
def test_cylinder_inflow_bcs_match_jax(step):
    jg, tg = _grids()
    jbc = jb.cylinder_inflow_bcs(1.0, jg.y_coords(), jg.y_max, 0.01, 1000)
    tbc = tb.cylinder_inflow_bcs(1.0, tg.y_coords(), tg.y_max, 0.01, 1000, device="cpu")
    u, v, _ = _fields()
    want = jbc(jnp.asarray(u), jnp.asarray(v), jnp.int32(step))
    got = tbc(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()),
              torch.tensor(step, dtype=torch.int32))
    for g, w in zip(got, want):
        _close(g, w)
    if step:
        assert float(got[0][:, 0].std()) > 0  # the perturbation is on


def test_channel_bcs_match_jax():
    u, v, _ = _fields()
    profile = np.linspace(0.0, 1.0, u.shape[0]).astype(np.float32)
    for tprof, jprof in ((None, None), (torch.from_numpy(profile), jnp.asarray(profile))):
        want = jb.channel_bcs(1.5, jprof)(jnp.asarray(u), jnp.asarray(v))
        got = tb.channel_bcs(1.5, tprof)(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()))
        for g, w in zip(got, want):
            _close(g, w)


def _compare_steps(name, kw, jkw=None, steps=5, iterative=False):
    j_case = j_build(name, **(jkw or kw))
    t_case = build(name, device="cpu", **kw)
    for k in ("u", "v", "p"):
        assert np.array_equal(getattr(t_case.state, k).numpy(), np.asarray(getattr(j_case.state, k)))
    js, ts = j_case.state, t_case.state
    j_step = jax.jit(j_case.step)
    for _ in range(steps):
        js, jm = j_step(js, jnp.float32(1.0))
        ts, tm = t_case.step(ts, torch.tensor(1.0))
        force = max(abs(float(jm.fx)), abs(float(jm.fy)))
        for name_ in jm._fields:
            want, got = float(getattr(jm, name_)), float(getattr(tm, name_))
            if name_ == "poisson_res" and not iterative:
                tol = (DIRECT_RES_RTOL * abs(want)
                       + DIRECT_RES_NOISE * float(jm.div_pre) / float(jm.dt))
            elif name_ in ("fx", "fy", "fz"):
                tol = FORCE_RTOL * force
            elif name_ == "poisson_res":
                tol = ITER_RES_RTOL * abs(want)
            else:
                tol = max(METRIC_RTOL * abs(want), STEP_ATOL if name_ == "dt" else 0.0)
            assert abs(got - want) <= tol, (name_, got, want)
    out = state_to_numpy(ts)
    for k in ("u", "v", "t"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(js, k)), rtol=0, atol=STEP_ATOL,
                                   err_msg=k)
    jp = np.asarray(js.p)
    assert np.abs(out["p"] - jp).max() <= P_RTOL * np.abs(jp).max()
    assert int(out["step"]) == int(js.step) == steps
    return t_case, ts


def test_cylinder_default_matches_jax():
    """Upwind, exact DCT projection, cleanup 2, fixed-dt warm-up and the
    IBM ramp (all five steps inside both)."""
    _compare_steps("cylinder", GEOMETRY)


def test_cylinder_warmup_and_ramp_ends_match_jax():
    """Both dt branches (warm-up, then adaptive) and the ramp reaching 1."""
    _compare_steps("cylinder", dict(GEOMETRY, warmup_steps=2, ibm_ramp_steps=3))


def test_cylinder_ref_parity_kernel_path_matches_jax():
    """Ref-parity SUPG, masked Poisson through kernel A's plain version with
    the early exit (against the Pallas kernel in interpret mode)."""
    kw = dict(GEOMETRY, ref_parity=True, scheme="supg")
    case, _ = _compare_steps("cylinder", dict(kw, poisson=PoissonConfig(**RB_PALLAS)),
                             dict(kw, poisson=JConfig(**RB_PALLAS)), iterative=True)
    assert case.cfg.scheme == "supg_refparity" and case.cfg.masked_poisson
    assert int(case.step.poisson.chunks_run) == 5 * 2  # tol 1e-8 is never reached


def test_cavity_multigrid_kernel_smoothing_matches_jax():
    kw = dict(n=64, Re=100.0)
    _compare_steps("cavity", dict(kw, poisson=PoissonConfig(method="mg", iters=2,
                                                            mg_pallas_smooth=True)),
                   dict(kw, poisson=JConfig(method="mg", iters=2, mg_pallas_smooth=True)),
                   iterative=True)


def test_channel_matches_jax():
    _compare_steps("channel", dict(nx=64, ny=16))


def test_cylinder_defaults_match_jax():
    import dataclasses

    j_case = j_build("cylinder", **GEOMETRY)
    t_case = build("cylinder", device="cpu", **GEOMETRY)
    jd, td = dataclasses.asdict(j_case.cfg), dataclasses.asdict(t_case.cfg)
    for cfg in (jd, td):
        cfg.pop("grid")
    assert td == jd
    ref = build("cylinder", device="cpu", ref_parity=True, **GEOMETRY).cfg.poisson
    assert dataclasses.asdict(ref) == dataclasses.asdict(
        j_build("cylinder", ref_parity=True, **GEOMETRY).cfg.poisson)


def test_mg_cavity_routes_every_level_to_a_kernel(monkeypatch):
    """With kernel smoothing, the fine level above MAX_ELEMS goes to the
    blocked kernel and every coarser level to kernel A: at 64² with the
    threshold at 32², per V-cycle 2 blocked calls and 2 per coarser level."""
    calls = []
    monkeypatch.setattr(rb, "MAX_ELEMS", 32 * 32)
    real_a, real_b = rb.rbsor, rb.rbsor_blocked
    monkeypatch.setattr(rb, "rbsor", lambda *a, **k: calls.append("A") or real_a(*a, **k))
    monkeypatch.setattr(rb, "rbsor_blocked", lambda *a, **k: calls.append("B") or real_b(*a, **k))
    case = build("cavity", n=64, poisson=PoissonConfig(method="mg", iters=2,
                                                       mg_pallas_smooth=True), device="cpu")
    case.step(case.state, 1.0)
    levels = 5  # 64, 32, 16, 8, 4
    assert calls.count("B") == 2 * 2 and calls.count("A") == 2 * 2 * (levels - 1)


def test_cli_run_cylinder(tmp_path, capsys):
    report = cli.main(["run", "cylinder", "--device", "cpu", "--nx", "60", "--ny", "18",
                       "--max-steps", "3", "--chunk-steps", "3", "--out", str(tmp_path)])
    assert report["final_step"] == 3 and report["stopped_reason"] == ""
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


def test_cli_run_cavity_with_multigrid_spec(tmp_path):
    report = cli.main(["run", "cavity", "--n", "32", "--poisson", "mg:2", "--max-steps", "4",
                       "--chunk-steps", "2", "--device", "cpu", "--out", str(tmp_path)])
    assert report["final_step"] == 4 and report["stopped_reason"] == ""


@pytest.mark.parametrize("mode", ["--all", "--cylinder", "--profile"])
def test_cli_bench_modes_refuse_the_cpu(mode):
    with pytest.raises(SystemExit, match="measures a CUDA device"):
        cli.main(["bench", mode, "--device", "cpu"])


def test_cylinder_state_round_trips_through_numpy():
    case = build("cylinder", device="cpu", nx=60, ny=18)
    s, _ = case.step(case.state, 1.0)
    back = state_from_numpy(**state_to_numpy(s), device="cpu")
    for k in ("u", "v", "p", "t", "step"):
        assert torch.equal(getattr(back, k), getattr(s, k))
    a, ma = case.step(s, 1.0)
    b, mb = case.step(back, 1.0)
    assert torch.equal(a.u, b.u) and torch.equal(a.p, b.p) and float(ma.fx) == float(mb.fx)


@pytest.mark.parametrize("kw, error", [
    (dict(storage="fp16"), ValueError),
    (dict(use_les=True, diffusion="implicit", implicit_solver="dst"), ValueError),
    (dict(diffusion="semi"), ValueError),
    (dict(scheme="upwinds"), ValueError),
    (dict(scheme="upwind", fused_predictor=True), ValueError),
], ids=["unknown-storage", "les-dst", "unknown-diffusion", "unknown-scheme", "fused-upwind"])
def test_unported_options_raise(kw, error):
    with pytest.raises(error):
        build("cylinder", device="cpu", nx=60, ny=18, **kw)
