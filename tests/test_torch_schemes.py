"""The limiters, TVD convection, Smagorinsky viscosity and body forcing of
the port against the JAX package on the same seeded numpy inputs, on the
CPU.

Tolerances (float32 both sides):
- limiters, one call: 1e-6 of the output's max (observed: bit-equal; the
  selects pick the same branch on the same inputs).
- ``convection_tvd`` and ``smagorinsky_viscosity``, one call: 2e-6 of the
  output's max (observed: TVD bit-equal to the eager JAX call and 9.5e-8
  from the jitted one, LES ≤ 9.2e-8: XLA's jit contracts a·b + c into one
  FMA where torch rounds twice).
- five steps from a developed 32² state (``_compare_steps``): u, v and t
  atol 1e-5, the cavity's band (tests/test_torch_cavity.py); p 1e-4 of max
  |p|; every metric relative 5e-5, the body forces 2e-5 of the larger of
  |fx|, |fy| and ``poisson_res`` of the exact DCT solve as in
  tests/test_torch_cylinder.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import boundary as jb
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.models import incompressible as jinc
from cfdsim_tpu.ops import convection as jconv
from cfdsim_tpu.ops import les as jles
from cfdsim_tpu.ops import limiters as jlim
from cfdsim_tpu_torch import boundary as tb
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import state_from_numpy
from cfdsim_tpu_torch.models import incompressible as tinc
from cfdsim_tpu_torch.ops import convection as tconv
from cfdsim_tpu_torch.ops import les as tles
from cfdsim_tpu_torch.ops import limiters as tlim

LIMITER_RTOL = 1e-6
OP_RTOL = 2e-6
STEP_ATOL = 1e-5
P_RTOL = 1e-4
METRIC_RTOL = 5e-5
FORCE_RTOL = 2e-5
DIRECT_RES_RTOL = 1e-2
DIRECT_RES_NOISE = 1e-5


def _slopes(seed=0, n=4000):
    """Pairs of slopes with every sign pattern, exact ties and zeros."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    a[:50] = b[:50]  # ties
    a[50:100] = -b[50:100]  # a + b = 0: van Leer's guarded denominator
    a[100:150] = 0.0
    b[150:200] = 0.0
    return a, b


@pytest.mark.parametrize("name", ["minmod", "superbee", "superbee_slope", "vanleer_slope",
                                  "minmod3"])
def test_limiter_matches_jax(name):
    a, b = _slopes()
    args = (a, b, np.roll(a, 7)) if name == "minmod3" else (a, b)
    want = np.asarray(getattr(jlim, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tlim, name)(*(torch.from_numpy(x) for x in args)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LIMITER_RTOL * np.abs(want).max()


def test_limiter_registry_and_tvd_property():
    assert set(tlim.SLOPE_LIMITERS) == set(jlim.SLOPE_LIMITERS)
    a, b = (torch.from_numpy(x) for x in _slopes(1))
    for fn in tlim.SLOPE_LIMITERS.values():
        s = fn(a, b)
        opposite = a * b <= 0
        assert bool((s[opposite] == 0).all())
        # a limited slope never exceeds twice the smaller one-sided slope
        assert bool((s.abs() <= 2.0 * torch.minimum(a.abs(), b.abs()) + 1e-6).all())


def _fields(shape=(33, 48), seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _close(got, want, rtol=OP_RTOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("shape", [(33, 48), (16, 16)], ids=str)
def test_convection_tvd_matches_jax(shape):
    u, v, phi = _fields(shape)
    dx, dy = 0.03, 0.05
    want = jconv.convection_tvd(*(jnp.asarray(x) for x in (u, v, phi)), dx, dy)
    got = tconv.convection_tvd(*(torch.from_numpy(x) for x in (u, v, phi)), dx, dy)
    _close(got, want)
    frame = np.ones(shape, bool)
    frame[1:-1, 1:-1] = False
    assert not got.numpy()[frame].any()


def test_convection_tvd_is_upwind_exact_on_a_linear_field():
    """On φ linear in x and constant velocity the limited slope is the exact
    gradient: u·∇φ away from the frame's neighbours."""
    ny, nx, dx = 12, 20, 0.1
    phi = torch.arange(nx, dtype=torch.float32).mul(dx).repeat(ny, 1)
    u = torch.full((ny, nx), 2.0)
    v = torch.zeros(ny, nx)
    got = tconv.convection_tvd(u, v, phi, dx, 0.1)
    assert torch.allclose(got[2:-2, 2:-2], torch.full((ny - 4, nx - 4), 2.0), atol=1e-5)


@pytest.mark.parametrize("cs", [0.17, 0.1])
def test_smagorinsky_matches_jax(cs):
    u, v, _ = _fields()
    dx, dy = 20.0 / 47, 4.0 / 32
    want = jles.smagorinsky_viscosity(jnp.asarray(u), jnp.asarray(v), dx, dy, cs)
    got = tles.smagorinsky_viscosity(torch.from_numpy(u), torch.from_numpy(v), dx, dy, cs)
    _close(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) > 0.0
    assert not got[0].any() and not got[:, -1].any()


def _developed(j_step, j_state, steps=30):
    """A developed state: ``steps`` JAX steps from rest, as numpy."""
    step = jax.jit(j_step)
    for _ in range(steps):
        j_state, _ = step(j_state, jnp.float32(1.0))
    return j_state


def _compare_flow_steps(j_step, t_step, j_state, steps=5):
    """Five steps on both sides from the same developed state; returns the
    two final states and the last metrics."""
    js = j_state
    ts = state_from_numpy(*(np.asarray(getattr(js, k)) for k in ("u", "v", "p", "t", "step")),
                          device="cpu")
    step = jax.jit(j_step)
    for _ in range(steps):
        js, jm = step(js, jnp.float32(1.0))
        ts, tm = t_step(ts, torch.tensor(1.0))
        force = max(abs(float(jm.fx)), abs(float(jm.fy)))
        for name in jm._fields:
            want, got = float(getattr(jm, name)), float(getattr(tm, name))
            if name == "poisson_res":
                tol = (DIRECT_RES_RTOL * abs(want)
                       + DIRECT_RES_NOISE * float(jm.div_pre) / float(jm.dt))
            elif name in ("fx", "fy", "fz"):
                tol = FORCE_RTOL * force
            else:
                tol = max(METRIC_RTOL * abs(want), STEP_ATOL if name == "dt" else 0.0)
            assert abs(got - want) <= tol, (name, got, want)
    for k in ("u", "v", "t"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=0,
                                   atol=STEP_ATOL, err_msg=k)
    jp = np.asarray(js.p)
    assert np.abs(ts.p.numpy() - jp).max() <= P_RTOL * np.abs(jp).max()
    assert int(ts.step) == int(js.step)
    return js, ts, tm


# Re=10 at 32² puts the explicit viscous bound (0.2·h²/ν ≈ 2.1e-3) under the
# CFL dt, so the LES case's dt follows mean(ν_t); Re=100 leaves dt at dt_max
CASES = {
    "tvd": ("cavity", dict(n=32, Re=100.0, scheme="tvd")),
    "les-explicit": ("cavity", dict(n=32, Re=10.0, use_les=True)),
    "les-supg": ("cavity", dict(n=32, Re=100.0, use_les=True, scheme="supg")),
    "tvd-cylinder": ("cylinder", dict(nx=96, ny=32, scheme="tvd")),
    "les-cylinder": ("cylinder", dict(nx=96, ny=32, use_les=True, scheme="supg",
                                      ref_parity=True, warmup_steps=2, ibm_ramp_steps=3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_case_steps_match_jax(name):
    case, kw = CASES[name]
    j_case, t_case = j_build(case, **kw), build(case, device="cpu", **kw)
    assert dataclasses.asdict(t_case.cfg) | {"grid": None, "poisson": None} == (
        dataclasses.asdict(j_case.cfg) | {"grid": None, "poisson": None})
    start = _developed(j_case.step, j_case.state, steps=30 if case == "cavity" else 3)
    _, ts, tm = _compare_flow_steps(j_case.step, t_case.step, start)
    if name == "les-explicit":  # the viscous bound with mean(ν_t) in it is the active one
        h = t_case.grid.dx
        assert float(tm.dt) < 0.2 * h * h / t_case.cfg.nu < t_case.cfg.dt_max


@pytest.mark.parametrize("diffusion", ["explicit", "implicit"])
@pytest.mark.parametrize("kind", ["numbers", "fields"])
def test_forcing_matches_jax(diffusion, kind):
    """``forcing=(fx, fy)`` on both diffusion branches, as numbers and as
    (ny, nx) fields (a Kolmogorov-like shear force)."""
    n = 32
    from cfdsim_tpu.grid import Grid as JGrid
    from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig
    from cfdsim_tpu_torch.grid import Grid
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    kw = dict(nu=0.01, scheme="central", diffusion=diffusion, cfl_target=0.5,
              dt_max=0.5 / (n - 1), max_velocity=5.0)
    j_cfg = jinc.IncompressibleConfig(grid=JGrid(nx=n, ny=n), poisson=JConfig(method="dct"), **kw)
    t_cfg = tinc.IncompressibleConfig(grid=Grid(nx=n, ny=n), poisson=PoissonConfig(method="dct"),
                                      **kw)
    if kind == "numbers":
        forcing = (0.3, -0.1)
        j_forcing = forcing
    else:
        y = np.linspace(0.0, 1.0, n, dtype=np.float32)
        fx = np.repeat(np.sin(4 * np.pi * y)[:, None], n, 1).astype(np.float32)
        forcing = (fx, np.zeros_like(fx))
        j_forcing = tuple(jnp.asarray(f) for f in forcing)
    j_step = jinc.make_step(j_cfg, jb.lid_cavity_bcs(1.0), forcing=j_forcing)
    t_step = tinc.make_step(t_cfg, tb.lid_cavity_bcs(1.0), forcing=forcing, device="cpu")
    start = _developed(j_step, jinc.init_state(j_cfg))
    js, ts, _ = _compare_flow_steps(j_step, t_step, start)
    # the force is felt: the same steps without it end elsewhere
    plain = tinc.make_step(t_cfg, tb.lid_cavity_bcs(1.0), device="cpu")
    s = state_from_numpy(*(np.asarray(getattr(start, k)) for k in ("u", "v", "p", "t", "step")),
                         device="cpu")
    for _ in range(5):
        s, _ = plain(s, 1.0)
    assert float((s.u - ts.u).abs().max()) > 1e-4


def test_fused_predictor_refuses_forcing():
    from cfdsim_tpu_torch.grid import Grid

    cfg = tinc.IncompressibleConfig(grid=Grid(nx=16, ny=16), nu=0.01, fused_predictor=True)
    with pytest.raises(ValueError, match="no forcing"):
        tinc.make_step(cfg, tb.lid_cavity_bcs(1.0), forcing=(1.0, 0.0), device="cpu")
