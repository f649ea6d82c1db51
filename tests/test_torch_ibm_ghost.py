"""The 2D ghost-cell IBM of the port (``ibm_ghost.py`` and the hooks in the
MAC steps) against the JAX package's ``cfdsim_tpu.ibm_ghost``: the
stencil arrays, the three forcing functions on seeded fields (a probe on
the last row and column included), five steps of ``cylinder_mac`` and of
``cylinder_oscillating`` (uniform and stretched) with ghost forcing, and
the mutual exclusion of ghost stencils and penalization masks.

Tolerances:
- stencil arrays: ``gy``, ``gx``, ``pidx`` and ``solid`` equal; ``pw`` and
  ``scale`` equal in float32 (the same float64 numpy, cast once);
- the forcing functions: within 1e-6 of max|field| (float32 arithmetic
  on both sides; the static probe is a sum of four products, which XLA
  may contract into FMAs);
- five steps (from the state after 20 jitted JAX steps): u, v within 1e-6
  of max|u|, p within 1e-5 of max|p|, metrics within 1e-5 relative (the
  forces against the larger of |fx|, |fy|; ``div_pre`` also allowed the
  float32 floor 1e-6·max|u|/h of a divergence), ``poisson_res`` within
  1e-2 relative plus 1e-5 of max|rhs| (tests/test_torch_mac.py), and
  ``div_post`` at float32 roundoff on each side, 1e-5·max|u|/h (the bound
  ``chip_smoke.py`` holds the MAC paths to; the ghost cylinder at 96×48
  gives 4.2e-5 on both sides, 1e-5·max|u|/h = 1.9e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import ibm_ghost as jg
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu_torch import ibm_ghost as tg
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import mac_state_from_numpy, mac_state_to_numpy
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.models import mac_stretched as ms

FIELD_RTOL = 1e-6
UV_RTOL = 1e-6
P_RTOL = 1e-5
METRIC_RTOL = 1e-5
DIV_POST_RTOL = 1e-5
RES_RTOL, RES_NOISE = 1e-2, 1e-5


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("domain, center, radius", [
    ((8.0, 4.0), (2.0, 2.0), 0.5),
    ((1.0, 1.0), (0.93, 0.91), 0.15),  # the probes leave the grid at x_hi, y_hi
])
def test_stencil_arrays_equal_jax(domain, center, radius):
    xf = np.linspace(0.0, domain[0], 97)
    yf = np.linspace(0.0, domain[1], 49)
    j = jg.cylinder_ghost_ibm(xf, yf, center, radius)
    t = tg.cylinder_ghost_ibm(xf, yf, center, radius, device="cpu")
    for js, ts in ((j.u, t.u), (j.v, t.v)):
        assert len(_np(ts.gx)) > 0
        for name in ("solid", "gy", "gx", "pidx"):
            assert np.array_equal(np.asarray(getattr(js, name)), _np(getattr(ts, name))), name
        for name in ("pw", "scale"):
            a, b = np.asarray(getattr(js, name)), _np(getattr(ts, name))
            assert b.dtype == np.float32 and np.array_equal(a, b), name
        # the ghost faces are unique: the scatter needs no accumulate
        flat = _np(ts.gy) * ts.solid.shape[1] + _np(ts.gx)
        assert len(np.unique(flat)) == len(flat)
        assert ts.gy.dtype == ts.pidx.dtype == torch.int64


def _fields(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, scale):
    err = float(np.abs(got - np.asarray(want)).max()) / scale
    assert err <= FIELD_RTOL, err
    return err


@pytest.mark.parametrize("strength", [1.0, 0.4])
def test_apply_ghost_forcing_2d_matches_jax(strength):
    xf = np.linspace(0.0, 8.0, 97)
    yf = np.linspace(0.0, 4.0, 49)
    j = jg.cylinder_ghost_ibm(xf, yf, (2.0, 2.0), 0.5)
    t = tg.cylinder_ghost_ibm(xf, yf, (2.0, 2.0), 0.5, device="cpu")
    for comp, shape in (("u", (48, 97)), ("v", (49, 96))):
        f = _fields(shape, 3)
        jo, jd = jg.apply_ghost_forcing_2d(jnp.asarray(f), getattr(j, comp), jnp.float32(strength))
        to, td = tg.apply_ghost_forcing_2d(torch.tensor(f), getattr(t, comp),
                                           torch.tensor(strength))
        scale = float(np.abs(f).max())
        _close(_np(to), jo, scale)
        _close(_np(td), jd, scale)
    # the module form of a step gives the same
    mod = tg.GhostForcing2D(t.u, device="cpu")
    f = torch.tensor(_fields((48, 97), 4))
    a = mod(f, torch.tensor(strength))
    b = tg.apply_ghost_forcing_2d(f, t.u, torch.tensor(strength))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _coords(xs, ys):
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    return X.astype(np.float32), Y.astype(np.float32)


# a body in the middle of the grid, and one whose probes leave the grid at
# its last column and row (the clip bounds of the corner lookup)
MOVING = [((2.1, 1.9), 0.5, 0.3), ((7.8, 3.85), 0.45, -0.2)]


@pytest.mark.parametrize("center, radius, u_b", MOVING)
def test_moving_ghost_forcing_2d_matches_jax(center, radius, u_b):
    nx, ny = 96, 48
    dx, dy = 8.0 / nx, 4.0 / ny
    xf = np.linspace(0.0, 8.0, nx + 1)
    yc = (np.arange(ny) + 0.5) * dy
    X, Y = _coords(xf, yc)
    f = _fields((ny, nx + 1), 2)
    jargs = ((jnp.float32(center[0]), jnp.float32(center[1])), radius, 1.5 * dx,
             jnp.float32(u_b), jnp.float32(1.0))
    targs = ((torch.tensor(np.float32(center[0])), torch.tensor(np.float32(center[1]))), radius,
             1.5 * dx, torch.tensor(np.float32(u_b)), torch.tensor(1.0))
    jo, jd = jg.moving_ghost_forcing_2d(jnp.asarray(f), jnp.asarray(X), jnp.asarray(Y), 0.0, dx,
                                        0.5 * dy, dy, *jargs)
    to, td = tg.moving_ghost_forcing_2d(torch.tensor(f), torch.tensor(X), torch.tensor(Y), 0.0,
                                        dx, 0.5 * dy, dy, *targs)
    scale = float(np.abs(f).max())
    _close(_np(to), jo, scale)
    _close(_np(td), jd, scale)
    assert float(np.abs(np.asarray(jd)).max()) > 0.0  # the body forced something

    # the stretched variant: searchsorted on float32 coordinates
    xs = np.concatenate([np.linspace(0.0, 3.0, 30, endpoint=False),
                         np.linspace(3.0, 8.0, nx + 1 - 30)])
    X, Y = _coords(xs, yc)
    jo, jd = jg.moving_ghost_forcing_2d_nonuniform(
        jnp.asarray(f), jnp.asarray(X), jnp.asarray(Y), xs, yc, *jargs)
    to, td = tg.moving_ghost_forcing_2d_nonuniform(
        torch.tensor(f), torch.tensor(X), torch.tensor(Y),
        torch.tensor(xs.astype(np.float32)), torch.tensor(yc.astype(np.float32)), *targs)
    _close(_np(to), jo, scale)
    _close(_np(td), jd, scale)


def _to_port(js):
    return mac_state_from_numpy(*(np.asarray(getattr(js, k)) for k in ("u", "v", "p", "t",
                                                                      "step")), device="cpu")


def compare_ghost_steps(j_step, t_step, j_state, h, pre=20, steps=5):
    """``pre`` jitted JAX steps, then ``steps`` steps on both sides from that
    state; asserts the bands of the module docstring."""
    j_step = jax.jit(j_step)
    one = jnp.float32(1.0)
    for _ in range(pre):
        j_state, _ = j_step(j_state, one)
    ts = _to_port(j_state)
    for _ in range(steps):
        j_state, jm = j_step(j_state, one)
        ts, tm = t_step(ts, 1.0)
    got = mac_state_to_numpy(ts)
    out = {}
    for k, band in (("u", UV_RTOL), ("v", UV_RTOL), ("p", P_RTOL)):
        want = np.asarray(getattr(j_state, k))
        scale = np.abs(np.asarray(j_state.u)).max() if k != "p" else np.abs(want).max()
        out[k] = float(np.abs(got[k] - want).max() / scale)
        assert out[k] <= band, (k, out[k])
    assert got["step"] == int(j_state.step) and abs(got["t"] - float(j_state.t)) <= 1e-6
    dt = float(jm.dt)
    floor = 1e-6 * float(np.abs(got["u"]).max()) / h
    for name in jm._fields:
        a, b = float(getattr(jm, name)), float(getattr(tm, name))
        if name == "div_post":
            assert b <= DIV_POST_RTOL * float(tm.max_vel) / h, (b, float(tm.max_vel))
            assert a <= DIV_POST_RTOL * float(jm.max_vel) / h, (a, float(jm.max_vel))
        elif name == "poisson_res":
            assert abs(a - b) <= RES_RTOL * abs(a) + RES_NOISE * float(jm.div_pre) / dt, (a, b)
        elif name == "div_pre":
            assert abs(a - b) <= METRIC_RTOL * a + floor, (a, b)
        elif name in ("fx", "fy"):
            scale = max(abs(float(jm.fx)), abs(float(jm.fy)), 1e-12)
            assert abs(a - b) <= METRIC_RTOL * scale, (name, a, b)
        else:
            assert abs(a - b) <= METRIC_RTOL * max(abs(a), 1e-12), (name, a, b)
    return out


@pytest.mark.parametrize("name, kw", [
    ("cylinder_mac", dict(nx=96, ny=48, Re=100.0, domain=(8.0, 4.0), center=(2.0, 2.0),
                          ibm_ramp_steps=5, warmup_steps=0)),
    ("cylinder_oscillating", dict(nx=96, ny=48, domain=(8.0, 4.0), center=(4.0, 2.0))),
    ("cylinder_oscillating", dict(nx=64, ny=48, domain=(8.0, 4.0), center=(4.0, 2.0),
                                  stretched=True)),
], ids=["cylinder_mac", "oscillating", "oscillating_stretched"])
def test_ghost_cases_five_steps_match_jax(name, kw):
    j = j_build(name, ibm_scheme="ghost", **kw)
    t = build(name, ibm_scheme="ghost", device="cpu", **kw)
    assert t.step.reads_host is False
    h = (float(min(np.diff(t.extras["x_faces"]).min(), np.diff(t.extras["y_faces"]).min()))
         if "x_faces" in t.extras else min(t.grid.dx, t.grid.dy))
    out = compare_ghost_steps(j.step, t.step, j.state, h)
    assert max(out.values()) <= P_RTOL


def test_ghost_case_feels_drag():
    """The twin of tests/test_ibm_ghost.py:233: the ghost cylinder steps
    with drag in the stream direction."""
    case = build("cylinder_mac", nx=96, ny=48, Re=100.0, domain=(8.0, 4.0), center=(2.0, 2.0),
                 ibm_scheme="ghost", ibm_ramp_steps=5, warmup_steps=0, device="cpu")
    s = case.state
    for _ in range(30):
        s, m = case.step(s, 1.0)
    assert bool(torch.isfinite(s.u).all()) and float(m.fx) > 0.0


def test_ghost_and_masks_mutually_exclusive():
    n = 16
    xf = np.linspace(0.0, 1.0, n + 1)
    ghost = tg.cylinder_ghost_ibm(xf, xf, (0.5, 0.5), 0.2, device="cpu")
    masks = dict(ibm_mask_u=np.zeros((n, n + 1), np.float32),
                 ibm_mask_v=np.zeros((n + 1, n), np.float32))
    case = build("cavity_mac", n=n, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        mac.make_step(case.cfg, mac.cavity_bcs(), ibm_ghost=ghost, device="cpu", **masks)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=0.01)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ms.make_step(cfg, mac.cavity_bcs(), xf, xf, ibm_ghost=ghost, device="cpu", **masks)


def test_stretched_ghost_equals_uniform_ghost_on_uniform_faces():
    """The twin of tests/test_ibm_ghost.py:271: on uniform faces the
    stretched step with ghost stencils reproduces the uniform MAC step."""
    from cfdsim_tpu_torch.grid import Grid
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    n = 32
    xf = np.linspace(0.0, 1.0, n + 1)
    ghost = tg.cylinder_ghost_ibm(xf, xf, (0.5, 0.5), 0.15, device="cpu")
    bcs = mac.cavity_bcs(1.0)
    scfg = ms.StretchedMACConfig(nx=n, ny=n, nu=0.01, cfl_target=0.5, dt_max=0.5 / n)
    step_s = ms.make_step(scfg, bcs, xf, xf, ibm_ghost=ghost, device="cpu")
    ucfg = mac.MACConfig(grid=Grid(nx=n, ny=n, centering="cell"), nu=0.01, cfl_target=0.5,
                         dt_max=0.5 / n, poisson=PoissonConfig(method="dct"))
    step_u = mac.make_step(ucfg, bcs, ibm_ghost=ghost, device="cpu")
    ss, su = ms.init_state(scfg, device="cpu"), mac.init_state(ucfg, device="cpu")
    for _ in range(10):
        ss, m_s = step_s(ss, 1.0)
        su, m_u = step_u(su, 1.0)
    assert float((ss.u - su.u).abs().max()) <= 5e-6
    assert float((ss.v - su.v).abs().max()) <= 5e-6
    assert abs(float(m_s.fx) - float(m_u.fx)) <= 1e-5
