"""The 3D staggered tier of the port (``models/mac3d.py``, the case
``cavity3d_mac``) against the JAX package's ``cfdsim_tpu.models.mac3d``:
five steps from a developed state over {chorin, incremental} × {euler,
rk2} × {central, upwind, tvd} and static Smagorinsky LES; the free-slip
and external-flow BCs; the exact divergence/gradient adjoint; the options
that wait for ROADMAP.md item 17.

Tolerances (five steps at 16³ from the state after 20 jitted JAX steps):
u, v, w within 1e-6 of max|u, v, w| (observed ≤ 6e-7); p within 1e-5 of
max|p| (FFT summation order); metrics within 1e-5 relative (``div_pre``
also allowed the float32 floor 1e-6·max|u|/h of a divergence; the forces
of the largest of |fx|, |fy|, |fz|, as tests/test_torch_mac.py holds
them); ``div_post``
at float32 roundoff on each side, ≤ 1e-5·max|u|/h (observed 1.4e-6-1.9e-6
at 16³, up to 25% apart), except under the external-flow BCs, whose
outflow faces are rewritten after the projection (0.028 on both sides,
held at 1e-5 relative like the other metrics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid3D as JGrid3D
from cfdsim_tpu.models import mac3d as jm3
from cfdsim_tpu.solvers.poisson3d import Poisson3DConfig as JConfig
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import mac3d_state_from_numpy, state_to_numpy
from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.models import mac3d as tm3
from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig, lap_neumann_3d

UV_RTOL = 1e-6
P_RTOL = 1e-5
METRIC_RTOL = 1e-5
DIV_POST_RTOL = 1e-5
FIELDS = ("u", "v", "w", "p", "t", "step")


def _to_port(js):
    return mac3d_state_from_numpy(*(np.asarray(getattr(js, k)) for k in FIELDS), device="cpu")


def compare_mac3d_steps(j_step, t_step, j_state, h, pre=20, steps=5, exact_div=True):
    """``pre`` jitted JAX steps, then ``steps`` steps on both sides; asserts
    the bands of the module docstring (``exact_div=False``: BCs that rewrite
    faces after the projection, whose ``div_post`` is compared like any
    metric)."""
    j_step = jax.jit(j_step)
    for _ in range(pre):
        j_state, _ = j_step(j_state, jnp.float32(1.0))
    ts = _to_port(j_state)
    for _ in range(steps):
        j_state, jm = j_step(j_state, jnp.float32(1.0))
        ts, tm = t_step(ts, 1.0)
    got = state_to_numpy(ts)
    vel = max(np.abs(np.asarray(getattr(j_state, k))).max() for k in ("u", "v", "w"))
    out = {}
    for k in ("u", "v", "w"):
        out[k] = float(np.abs(got[k] - np.asarray(getattr(j_state, k))).max() / vel)
        assert out[k] <= UV_RTOL, (k, out[k])
    want_p = np.asarray(j_state.p)
    out["p"] = float(np.abs(got["p"] - want_p).max() / np.abs(want_p).max())
    assert out["p"] <= P_RTOL, out["p"]
    assert got["step"] == int(j_state.step) and abs(got["t"] - float(j_state.t)) <= 1e-6
    for name in jm._fields:
        a, b = float(getattr(jm, name)), float(getattr(tm, name))
        if name == "div_post" and exact_div:
            assert a <= DIV_POST_RTOL * vel / h and b <= DIV_POST_RTOL * vel / h, (a, b)
        elif name == "div_pre":
            assert abs(a - b) <= METRIC_RTOL * a + 1e-6 * vel / h, (a, b)
        elif name in ("fx", "fy", "fz"):  # the port's force rule: of the largest component
            scale = max(abs(float(getattr(jm, f))) for f in ("fx", "fy", "fz"))
            assert abs(a - b) <= METRIC_RTOL * max(scale, 1e-12), (name, a, b)
        else:
            assert abs(a - b) <= METRIC_RTOL * max(abs(a), 1e-12), (name, a, b)
    return out


OPTIONS = [dict(projection=p, time_scheme=t, scheme=s)
           for p in ("chorin", "incremental") for t in ("euler", "rk2")
           for s in ("central", "upwind", "tvd")]
OPTIONS += [dict(use_les=True, Re=1000.0), dict(use_les=True, Re=1000.0, scheme="tvd",
                                                time_scheme="rk2")]


@pytest.mark.parametrize("kw", OPTIONS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_cavity3d_mac_five_steps_match_jax(kw):
    kw = {"n": 16, **kw}
    j = j_build("cavity3d_mac", **kw)
    t = build("cavity3d_mac", device="cpu", **kw)
    assert t.step.reads_host is False
    compare_mac3d_steps(j.step, t.step, j.state, 1.0 / 16)


def test_cavity3d_mac_mg_projection_matches_jax():
    """The 3D tier with an iterative projection: its ``div_post`` is the
    solve's residual, so it is compared relative (1e-3) rather than held to
    roundoff."""
    j = j_build("cavity3d_mac", n=16, poisson=JConfig(method="mg", iters=2))
    t = build("cavity3d_mac", n=16, poisson="mg:2", device="cpu")
    js = j.state
    step = jax.jit(j.step)
    for _ in range(20):
        js, _ = step(js, jnp.float32(1.0))
    ts = _to_port(js)
    for _ in range(5):
        js, jm = step(js, jnp.float32(1.0))
        ts, tm = t.step(ts, 1.0)
    vel = float(jm.max_vel)
    for k in ("u", "v", "w"):
        assert float(np.abs(getattr(ts, k).numpy() - np.asarray(getattr(js, k))).max()) <= (
            UV_RTOL * vel), k
    assert abs(float(tm.div_post) - float(jm.div_post)) <= 1e-3 * float(jm.div_post)


def _tg3(n):
    """A Taylor–Green field on [0, π]³ that the free-slip box holds."""
    h = np.pi / n
    f, c = np.arange(n + 1) * h, (np.arange(n) + 0.5) * h
    u = np.sin(f)[None, None, :] * np.cos(c)[None, :, None] * np.cos(c)[:, None, None]
    v = -np.cos(c)[None, None, :] * np.sin(f)[None, :, None] * np.cos(c)[:, None, None]
    w = np.zeros((n + 1, n, n))
    return u.astype(np.float32), v.astype(np.float32), w.astype(np.float32)


@pytest.mark.parametrize("bcs", ["free_slip", "external"])
def test_other_bcs_match_jax(bcs):
    n = 16
    kw = dict(nx=n, ny=n, nz=n, x_max=np.pi, y_max=np.pi, z_max=np.pi, centering="cell")
    common = dict(nu=0.02, scheme="tvd", cfl_target=0.3)
    jcfg = jm3.MAC3DConfig(grid=JGrid3D(**kw), poisson=JConfig(method="dct"), **common)
    tcfg = tm3.MAC3DConfig(grid=Grid3D(**kw), poisson=Poisson3DConfig(method="dct"), **common)
    if bcs == "free_slip":
        jb, tb = jm3.free_slip_bcs3d(), tm3.free_slip_bcs3d()
        u, v, w = _tg3(n)
    else:
        prof = (1.0 + 0.01 * np.random.default_rng(1).standard_normal((n, n))).astype(np.float32)
        fw = np.random.default_rng(2).random((n, n)).astype(np.float32) + 0.5
        jb = jm3.external_flow_bcs3d(1.0, inlet_profile=jnp.asarray(prof), face_weights=fw)
        tb = tm3.external_flow_bcs3d(1.0, inlet_profile=prof, face_weights=fw, device="cpu")
        # a stream with a Taylor–Green disturbance, so the pressure is O(0.1)
        u, v, w = (0.3 * q for q in _tg3(n))
        u = u + np.float32(1.0)
    js = jm3.init_state(jcfg)._replace(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w))
    t_step = tm3.make_step(tcfg, tb, device="cpu")
    # the outflow faces are rewritten after the projection (mass-consistent
    # zero gradient), so the external flow's div_post is not at roundoff
    compare_mac3d_steps(jm3.make_step(jcfg, jb), t_step, js, np.pi / n, pre=10,
                        exact_div=bcs == "free_slip")


def test_penalization_masks_match_jax():
    """The ``ibm_mask_{u,v,w}`` hook and its body forces (fx, fy, fz)."""
    n = 16
    kw = dict(nx=n, ny=n, nz=n, centering="cell")
    rng = np.random.default_rng(3)
    masks = [(rng.random(s) < 0.05).astype(np.float32)
             for s in ((n, n, n + 1), (n, n + 1, n), (n + 1, n, n))]
    jcfg = jm3.MAC3DConfig(grid=JGrid3D(**kw), nu=1.0 / 400)
    tcfg = tm3.MAC3DConfig(grid=Grid3D(**kw), nu=1.0 / 400)
    js_step = jm3.make_step(jcfg, jm3.cavity3d_bcs(), *(jnp.asarray(m) for m in masks),
                            ibm_ramp_steps=10)
    ts_step = tm3.make_step(tcfg, tm3.cavity3d_bcs(), *masks, ibm_ramp_steps=10, device="cpu")
    compare_mac3d_steps(js_step, ts_step, jm3.init_state(jcfg), 1.0 / n)


def test_step_leaves_its_input_unchanged():
    case = build("cavity3d_mac", n=8, scheme="tvd", time_scheme="rk2",
                 projection="incremental", device="cpu")
    s, _ = case.step(case.state, 1.0)
    before = {k: getattr(s, k).clone() for k in s._fields}
    case.step(s, 1.0)
    assert all(torch.equal(getattr(s, k), before[k]) for k in s._fields)


def test_divergence_gradient_adjoint():
    """tests/test_3d.py:111: div(grad φ) through the MAC pair is the
    clamped-edge 7-point operator the DCT solve diagonalizes."""
    phi = torch.tensor(np.random.RandomState(0).randn(8, 10, 12).astype(np.float32))
    dx, dy, dz = 0.1, 0.07, 0.09
    gu = torch.nn.functional.pad((phi[:, :, 1:] - phi[:, :, :-1]) / dx, (1, 1))
    gv = torch.nn.functional.pad((phi[:, 1:, :] - phi[:, :-1, :]) / dy, (0, 0, 1, 1))
    gw = torch.nn.functional.pad((phi[1:] - phi[:-1]) / dz, (0, 0, 0, 0, 1, 1))
    div = tm3.divergence_mac3d(gu, gv, gw, dx, dy, dz)
    lap = lap_neumann_3d(phi, dx, dy, dz)
    assert float((div - lap).abs().max()) <= 1e-5 * float(lap.abs().max())


def test_les_with_constant_nu_is_the_laplacian():
    """tests/test_3d.py:171: the flux-form diffusion with a constant ν is
    ν times the 7-point face Laplacian."""
    n = 8
    rng = np.random.default_rng(4)
    u, v, w = (torch.tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((n, n, n + 1), (n, n + 1, n), (n + 1, n, n)))
    bcs = tm3.cavity3d_bcs()
    u, v, w = bcs.set_normal(u, v, w)
    ghosts = bcs.ghosts(u, v, w)
    d = (0.1, 0.12, 0.08)
    les = tm3._diffuse_les3d(u, v, w, ghosts, torch.full((n, n, n), 0.3), *d)
    lap = tm3.diffuse3d(u, v, w, ghosts, *d)
    for a, b in zip(les, lap):
        assert float((a - 0.3 * b).abs().max()) <= 1e-5 * float((0.3 * b).abs().max())
    nu_t = tm3.smagorinsky_viscosity_mac3d(u, v, w, ghosts, *d, 0.17)
    want = jm3.smagorinsky_viscosity_mac3d(
        *(jnp.asarray(q.numpy()) for q in (u, v, w)),
        tuple(jnp.asarray(g.numpy()) for g in ghosts), *d, 0.17)
    assert float(np.abs(nu_t.numpy() - np.asarray(want)).max()) <= 1e-6 * float(nu_t.max())


def test_item_17_options_raise():
    n = 8
    case = build("cavity3d_mac", n=n, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        build("cavity3d_mac", n=n, use_les=True, les_model="dynamic", device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        tm3.make_step(case.cfg, tm3.cavity3d_bcs(), ibm_ghost=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        tm3.make_step(case.cfg, tm3.cavity3d_bcs(), moving_body=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        tm3.make_step(case.cfg, tm3.cavity3d_bcs(), moving_scheme="ghost", device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tm3.make_step(case.cfg, tm3.cavity3d_bcs(), ibm_mask_u=np.zeros((n, n, n + 1)),
                      ibm_ghost=object(), device="cpu")
    for bad in (dict(scheme="quick"), dict(time_scheme="rk3"), dict(projection="p"),
                dict(les_model="wale")):
        with pytest.raises(ValueError):
            build("cavity3d_mac", n=n, device="cpu", **bad)
