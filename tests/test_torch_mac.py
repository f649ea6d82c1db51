"""The staggered (MAC) tier of the port (``models/mac.py``) against the JAX
package's ``cfdsim_tpu.models.mac``: five steps from a developed state
carried across by ``convert.py``, in every option of the step; the golden
``cavity_mac_48_re1000``; the exact projection and the adjoint pair.

Tolerances (five steps at 32², from the state after 20 jitted JAX steps):
- u and v within 1e-5 of max|u| (observed ≤ 2.2e-7);
- p within 1e-4 of max|p| (observed ≤ 5.6e-6: the solve amplifies the
  last-bit differences of div u*/dt);
- metrics within 1e-4 relative, with ``div_pre`` also allowed the float32
  floor of a divergence, 1e-6·max|u|/h (under incremental projection it is
  a small residual, 0.015 at 32², where the packages were 2.4e-6 apart);
  except the two at float32 roundoff:
  ``div_post`` (the exact projection leaves fp32 noise, observed 1-4e-6 on
  both sides and up to 40% apart) is held to ≤ 1e-5 of ``div_pre`` on each
  side, and ``poisson_res`` (the direct solve's residual: the rhs's mean,
  which it drops, plus noise) to 1e-2 relative plus 1e-5 of max|rhs|.
  Under an iterative solve (``mg:2``) ``div_post`` is the solve's own
  residual and is held to 2e-3 relative, the band of
  tests/test_torch_cylinder.py, plus the divergence floor above.
The golden is held under the rule of tests/test_goldens.py:112-124
(RTOL 2e-5, the noise floor 1e-6 of the largest key).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid as JGrid
from cfdsim_tpu.models import mac as jmac
from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import mac_state_from_numpy, mac_state_to_numpy
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, lap_neumann

UV_RTOL = 1e-5
P_RTOL = 1e-4
METRIC_RTOL = 1e-4
DIV_POST_RTOL = 1e-5
RES_RTOL, RES_NOISE = 1e-2, 1e-5
ITER_RTOL = 2e-3
GOLDEN_RTOL = 2e-5
GOLDENS = json.loads((Path(__file__).parent / "goldens.json").read_text())


def _to_port(js):
    return mac_state_from_numpy(*(np.asarray(getattr(js, k)) for k in ("u", "v", "p", "t",
                                                                      "step")), device="cpu")


def compare_steps(j_step, t_step, j_state, h, pre=20, steps=5, exact=True):
    """``pre`` jitted JAX steps from ``j_state``, then ``steps`` steps on
    both sides from that state (``h`` the smallest spacing, ``exact`` whether
    the pressure solve is direct); asserts the bands of the module
    docstring and returns the worst relative differences."""
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
    for name in jm._fields:
        a, b = float(getattr(jm, name)), float(getattr(tm, name))
        if name == "div_post" and not exact:
            floor = 1e-6 * float(np.abs(got["u"]).max()) / h
            assert abs(a - b) <= ITER_RTOL * abs(a) + floor, (name, a, b)
        elif name == "div_post":
            assert b <= DIV_POST_RTOL * max(float(tm.div_pre), 1.0), (b, float(tm.div_pre))
            assert a <= DIV_POST_RTOL * max(float(jm.div_pre), 1.0)
        elif name == "poisson_res":
            assert abs(a - b) <= RES_RTOL * abs(a) + RES_NOISE * float(jm.div_pre) / dt, (a, b)
        elif name == "div_pre":
            floor = 1e-6 * float(np.abs(got["u"]).max()) / h
            assert abs(a - b) <= METRIC_RTOL * a + floor, (a, b)
        elif name in ("fx", "fy"):
            scale = max(abs(float(jm.fx)), abs(float(jm.fy)), 1e-12)
            assert abs(a - b) <= METRIC_RTOL * scale, (name, a, b)
        else:
            assert abs(a - b) <= METRIC_RTOL * max(abs(a), 1e-12), (name, a, b)
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scheme="upwind", projection="incremental"),
    dict(scheme="tvd", time_scheme="rk2"),
    dict(projection="incremental", time_scheme="rk2"),
    dict(diffusion="implicit"),
    dict(scheme="upwind", diffusion="implicit", projection="incremental"),
    dict(Re=1000.0, use_les=True),
    dict(Re=1000.0, use_les=True, scheme="tvd", time_scheme="rk2"),
    dict(poisson="mg:2"),
    dict(poisson=JConfig(method="dct", dct_variant="packed")),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_cavity_mac_five_steps_match_jax(kw):
    kw = {"n": 32, "Re": 100.0, **kw}
    port_kw = dict(kw)
    if isinstance(kw.get("poisson"), JConfig):
        port_kw["poisson"] = PoissonConfig(method="dct", dct_variant=kw["poisson"].dct_variant)
    j = j_build("cavity_mac", **kw)
    t = build("cavity_mac", device="cpu", **port_kw)
    compare_steps(j.step, t.step, j.state, 1.0 / 32, exact=kw.get("poisson") != "mg:2")


def _tg_fields(n):
    """A Taylor–Green-like field on [0, π]² that the free-slip box holds."""
    h = np.pi / n
    xu, yu = np.arange(n + 1) * h, (np.arange(n) + 0.5) * h
    xv, yv = (np.arange(n) + 0.5) * h, np.arange(n + 1) * h
    u = np.sin(xu)[None, :] * np.cos(yu)[:, None]
    v = -np.cos(xv)[None, :] * np.sin(yv)[:, None]
    return u.astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("projection", ["chorin", "incremental"])
def test_free_slip_implicit_kit_matches_jax(projection):
    n = 32
    kw = dict(nx=n, ny=n, x_max=np.pi, y_max=np.pi, centering="cell")
    jg, tg = JGrid(**kw), Grid(**kw)
    common = dict(nu=0.05, diffusion="implicit", projection=projection, cfl_target=0.5)
    jcfg = jmac.MACConfig(grid=jg, poisson=JConfig(method="dct"), **common)
    tcfg = mac.MACConfig(grid=tg, poisson=PoissonConfig(method="dct"), **common)
    j_step = jmac.make_step(jcfg, jmac.free_slip_bcs(),
                            implicit_kit=jmac.free_slip_implicit_kit(jg))
    t_step = mac.make_step(tcfg, mac.free_slip_bcs(),
                           implicit_kit=mac.free_slip_implicit_kit(tg, device="cpu"),
                           device="cpu")
    u0, v0 = _tg_fields(n)
    compare_steps(j_step, t_step, jmac.init_state(jcfg, u0=u0, v0=v0), np.pi / n, pre=5)


@pytest.mark.parametrize("profile", [False, True])
def test_channel_bcs_match_jax(profile):
    kw = dict(nx=48, ny=16, x_max=3.0, y_max=1.0, centering="cell")
    jg, tg = JGrid(**kw), Grid(**kw)
    y = ((np.arange(16) + 0.5) / 16).astype(np.float32)
    prof = (6.0 * y * (1.0 - y)).astype(np.float32) if profile else None
    common = dict(nu=0.01, scheme="tvd", cfl_target=0.4, dt_max=0.4 / 16)
    j_step = jmac.make_step(jmac.MACConfig(grid=jg, **common),
                            jmac.channel_bcs(1.0, None if prof is None else jnp.asarray(prof)))
    t_step = mac.make_step(mac.MACConfig(grid=tg, **common),
                           mac.channel_bcs(1.0, None if prof is None else torch.from_numpy(prof)),
                           device="cpu")
    compare_steps(j_step, t_step, jmac.init_state(jmac.MACConfig(grid=jg, **common)), 1.0 / 16)


def test_bcs_match_jax_bit_for_bit():
    """set_normal and extend of every BC family on one field, eagerly on
    both sides."""
    rng = np.random.default_rng(0)
    u = rng.standard_normal((12, 17)).astype(np.float32)
    v = rng.standard_normal((13, 16)).astype(np.float32)
    y = (np.arange(12, dtype=np.float32) + np.float32(0.5)) * np.float32(0.5)
    families = [(jmac.cavity_bcs(1.0), mac.cavity_bcs(1.0)),
                (jmac.free_slip_bcs(), mac.free_slip_bcs()),
                (jmac.channel_bcs(1.5), mac.channel_bcs(1.5)),
                (jmac.external_flow_bcs(1.0, y, 6.0, perturb_ramp_steps=10),
                 mac.external_flow_bcs(1.0, y, 6.0, perturb_ramp_steps=10, device="cpu"))]
    for step in (0, 3, 17):
        js, ts = jnp.int32(step), torch.tensor(step, dtype=torch.int32)
        for jb, tb in families:
            with jax.disable_jit():
                ju, jv = jb.set_normal(jnp.asarray(u), jnp.asarray(v), js, None)
                jue, jve = jb.extend(ju, jv, js, None)
            tu, tv = tb.set_normal(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()), ts, None)
            tue, tve = tb.extend(tu, tv, ts, None)
            for a, b in ((ju, tu), (jv, tv), (jue, tue), (jve, tve)):
                assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6 * max(
                    1.0, float(np.abs(np.asarray(a)).max()))


def test_operators_match_jax():
    """The advection schemes, both diffusions, the LES viscosity and the
    diagnostics on one random field."""
    rng = np.random.default_rng(1)
    ny, nx, dx, dy = 14, 18, 0.07, 0.05
    f = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         (("u", (ny, nx + 1)), ("v", (ny + 1, nx)), ("ue", (ny + 2, nx + 1)),
          ("ve", (ny + 1, nx + 2)), ("nu", (ny, nx)))}
    J = {k: jnp.asarray(a) for k, a in f.items()}
    T = {k: torch.from_numpy(a) for k, a in f.items()}
    pairs = []
    for scheme in ("central", "upwind", "tvd"):
        pairs.append((jax.jit(jmac._advect, static_argnums=(4, 5, 6))(
            J["u"], J["v"], J["ue"], J["ve"], dx, dy, scheme),
            mac._advect(T["u"], T["v"], T["ue"], T["ve"], dx, dy, scheme)))
    pairs.append((jmac._diffuse(J["ue"], J["ve"], dx, dy), mac._diffuse(T["ue"], T["ve"], dx, dy)))
    nu = jnp.abs(J["nu"]) * 0.01
    pairs.append((jmac._diffuse_les(J["ue"], J["ve"], nu, dx, dy),
                  mac._diffuse_les(T["ue"], T["ve"], torch.from_numpy(np.array(nu)), dx, dy)))
    pairs.append(((jmac.smagorinsky_viscosity_mac(J["u"], J["v"], J["ue"], J["ve"], dx, dy, 0.17),),
                  (mac.smagorinsky_viscosity_mac(T["u"], T["v"], T["ue"], T["ve"], dx, dy, 0.17),)))
    pairs.append(((jmac.divergence_mac(J["u"], J["v"], dx, dy),
                   jmac.vorticity_mac(J["u"], J["v"], dx, dy)),
                  (mac.divergence_mac(T["u"], T["v"], dx, dy),
                   mac.vorticity_mac(T["u"], T["v"], dx, dy))))
    pairs.append((jmac.center_velocities(J["u"], J["v"]), mac.center_velocities(T["u"], T["v"])))
    for want, got in pairs:
        for a, b in zip(want, got):
            a = np.asarray(a)
            assert a.shape == tuple(b.shape)
            assert np.abs(a - b.numpy()).max() <= 1e-6 * max(1.0, np.abs(a).max())


def _signature(state, metrics):
    sig = {}
    for name in ("u", "v", "p"):
        f = getattr(state, name)
        sig[f"l2_{name}"] = float(torch.sqrt(torch.mean(f * f)))
        sig[f"max_{name}"] = float(f.abs().max())
    for name in ("energy", "max_vel", "fx", "fy", "vort_max"):
        sig[name] = float(getattr(metrics, name))
    return sig


def golden_deviation(name, sig):
    """{key: |Δ| over the key's tolerance} under the rule of
    tests/test_goldens.py:112-124."""
    ref = GOLDENS[name]
    atol = 1e-6 * max(abs(v) for v in ref.values())
    return {k: abs(sig[k] - w) / (GOLDEN_RTOL * abs(w) if abs(w) > atol else atol)
            for k, w in ref.items()}


def test_golden_cavity_mac_48_re1000():
    case = build("cavity_mac", n=48, Re=1000.0, device="cpu")
    s = case.state
    for _ in range(300):
        s, _ = case.step(s, 1.0)
    _, m = case.step(s, 1.0)
    dev = golden_deviation("cavity_mac_48_re1000", _signature(s, m))
    assert max(dev.values()) <= 1.0, dev


def test_projection_is_exact():
    case = build("cavity_mac", n=32, Re=100.0, device="cpu")
    s = case.state
    while float(s.t) < 1.0:
        s, m = case.step(s, 1.0)
    assert float(m.div_post) < 1e-4
    assert float(m.div_post) < 1e-4 * max(1.0, float(m.div_pre))


def test_divergence_mac_adjoint_gradient():
    rng = np.random.RandomState(0)
    phi = torch.from_numpy(rng.randn(12, 10).astype(np.float32))
    dx, dy = 0.1, 0.07
    gu = torch.nn.functional.pad((phi[:, 1:] - phi[:, :-1]) / dx, (1, 1))
    gv = torch.nn.functional.pad((phi[1:, :] - phi[:-1, :]) / dy, (0, 0, 1, 1))
    div = mac.divergence_mac(gu, gv, dx, dy)
    lap = lap_neumann(phi, dx, dy)
    assert float((div - lap).abs().max()) <= 1e-5 * float(lap.abs().max())


def test_state_round_trips_and_step_leaves_its_input():
    """``convert.py`` carries a MAC state both ways, and a step (rk2 and
    incremental: the values JAX reuses) leaves the state it was given as it
    was, though its BCs write in place."""
    case = build("cavity_mac", n=16, Re=100.0, time_scheme="rk2", projection="incremental",
                 device="cpu")
    s, _ = case.step(case.state, 1.0)
    s, _ = case.step(s, 1.0)
    back = mac_state_from_numpy(**mac_state_to_numpy(s), device="cpu")
    for k in s._fields:
        assert torch.equal(getattr(back, k), getattr(s, k)), k
    before = {k: getattr(s, k).clone() for k in s._fields}
    case.step(s, 1.0)
    for k in s._fields:
        assert torch.equal(getattr(s, k), before[k]), k
    with pytest.raises(ValueError, match="not a MAC state"):
        mac_state_from_numpy(np.zeros((4, 4)), np.zeros((5, 4)), np.zeros((4, 4)), 0.0, 0, "cpu")


@pytest.mark.parametrize("kw, error", [
    (dict(storage="bf16"), NotImplementedError),
    (dict(time_scheme="rk3"), ValueError),
    (dict(projection="pressure"), ValueError),
    (dict(diffusion="implicit", use_les=True), ValueError),
    (dict(diffusion="implicit", time_scheme="rk2"), ValueError),
    (dict(scheme="quick"), ValueError),
], ids=["bf16", "rk3", "projection", "implicit-les", "implicit-rk2", "scheme"])
def test_refused_options_raise(kw, error):
    with pytest.raises(error):
        case = build("cavity_mac", n=8, device="cpu", **kw)
        case.step(case.state, 1.0)


def test_ghost_ibm_is_not_ported():
    """Of the ghost-cell IBM only the 3D half is not ported (ROADMAP.md item
    17): the 2D cases build and step with it, the 3D step refuses it."""
    for name, kw in (("cylinder_mac", dict(nx=48, ny=16)),
                     ("cylinder_oscillating", dict(nx=32, ny=16))):
        case = build(name, ibm_scheme="ghost", device="cpu", **kw)
        state, _ = case.step(case.state, 1.0)
        assert bool(torch.isfinite(state.u).all()), name
    cube = build("cavity3d_mac", n=8, device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        type(cube.step)(cube.cfg, cube.extras["bcs"], ibm_ghost=object(), device="cpu")
