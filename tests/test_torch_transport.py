"""The coupled scalar-transport step of the port (``models/transport.py``,
the ``transport`` case) against the JAX package on the CPU, and a chunk of
coupled steps (nested state and metrics) against the plain loop.

Tolerances: five steps from a developed 32² state: the flow at the
cavity's band (u, v atol 1e-5; p 1e-4 of max |p|), θ atol 1e-5 on a field
in [0, 1] (observed ≤ 1e-7), the θ metrics relative 5e-5. The physics
twins keep the bands of tests/test_transport_viz.py:24-70.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu_torch.cases import build, transport
from cfdsim_tpu_torch.convert import coupled_state_from_numpy, coupled_state_to_numpy
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.models import transport as tr
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.utils.tree import leaves, named_leaves, rebuild, tree_map

STEP_ATOL = 1e-5
P_RTOL = 1e-4
METRIC_RTOL = 5e-5


def _from_jax(js):
    f = js.flow
    return coupled_state_from_numpy(*(np.asarray(x) for x in (f.u, f.v, f.p, f.t, f.step)),
                                    np.asarray(js.theta), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(n=32, Re=100.0, Pe=100.0),
    dict(n=32, Re=100.0, Pe=50.0, scheme="central", hot_lid=2.0),
    dict(n=33, Re=400.0, Pe=400.0, diffusion="implicit"),
], ids=["upwind", "central-hot2", "implicit-flow"])
def test_coupled_steps_match_jax(kw):
    j_case, t_case = j_build("transport", **kw), build("transport", device="cpu", **kw)
    assert np.array_equal(t_case.state.theta.numpy(), np.asarray(j_case.state.theta))
    step = jax.jit(j_case.step)
    js = j_case.state
    for _ in range(30):
        js, _ = step(js, jnp.float32(1.0))
    ts = _from_jax(js)
    for _ in range(5):
        js, jm = step(js, jnp.float32(1.0))
        ts, tm = t_case.step(ts, torch.tensor(1.0))
        for name in ("theta_min", "theta_max", "theta_mean"):
            want, got = float(getattr(jm, name)), float(getattr(tm, name))
            assert abs(got - want) <= METRIC_RTOL * abs(want) + 1e-7, name
        for name in ("dt", "energy", "max_vel", "div_post"):  # the runner's passthroughs
            want, got = float(getattr(jm, name)), float(getattr(tm, name))
            assert abs(got - want) <= METRIC_RTOL * abs(want), name
    out = coupled_state_to_numpy(ts)
    for k in ("u", "v", "t"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(js.flow, k)), rtol=0,
                                   atol=STEP_ATOL, err_msg=k)
    np.testing.assert_allclose(out["theta"], np.asarray(js.theta), rtol=0, atol=STEP_ATOL)
    jp = np.asarray(js.flow.p)
    assert np.abs(out["p"] - jp).max() <= P_RTOL * np.abs(jp).max()
    assert int(ts.step) == int(js.step) == 35 and float(ts.t) == float(ts.flow.t)


def test_transport_maximum_principle_and_mixing():
    """tests/test_transport_viz.py:24."""
    case = transport(n=48, Re=100.0, Pe=100.0, device="cpu")
    st, m = make_chunk(case.cfg, case.step, 800)(case.state, 1.0)
    assert float(st.theta.min()) >= -1e-5 and float(st.theta.max()) <= 1.0 + 1e-5
    assert float(m.theta_mean[-1]) > 0.01
    assert bool(torch.isfinite(st.theta).all())
    assert m.theta_max.shape == m.flow.dt.shape == m.dt.shape == (800,)


def test_transport_pure_diffusion_decay():
    """tests/test_transport_viz.py:36."""
    g = Grid(nx=64, ny=64)
    cfg = tr.TransportConfig(grid=g, kappa=0.01, scheme="central")
    step = tr.make_transport_step(cfg, bc_fn=lambda th: th)  # frame untouched
    x = np.linspace(0, 1, 64)
    X, Y = np.meshgrid(x, x)
    theta0 = torch.tensor(np.sin(np.pi * X) * np.sin(np.pi * Y), dtype=torch.float32)
    u = torch.zeros_like(theta0)
    dt = torch.tensor(0.2 * g.dx**2 / cfg.kappa, dtype=torch.float32)
    n = 50
    theta = theta0
    for _ in range(n):
        theta = step(theta, u, u, dt)
    expected = np.exp(-2.0 * cfg.kappa * np.pi**2 * n * float(dt))
    assert float(theta[32, 32]) / float(theta0[32, 32]) == pytest.approx(expected, rel=0.05)


def test_chunk_of_coupled_steps_equals_the_loop():
    """The chunk's copies, stacked rows and rebuilt records work on the
    leaves of the nested state and metrics: 6 steps through a chunk give
    the bits of 6 step calls, and the stacked metrics are the per-step ones."""
    case = transport(n=24, Re=100.0, Pe=100.0, device="cpu")
    state, stacked = make_chunk(case.cfg, case.step, 6)(case.state, 1.0)
    s, rows = case.state, []
    for _ in range(6):
        s, m = case.step(s, 1.0)
        rows.append(m)
    assert isinstance(state, tr.CoupledState) and isinstance(stacked, tr.CoupledMetrics)
    assert type(stacked.flow) is type(rows[0].flow)
    for (name, a), b in zip(named_leaves(state), leaves(s)):
        assert torch.equal(a, b), name
    for i, m in enumerate(rows):
        for (name, a), b in zip(named_leaves(stacked), leaves(m)):
            assert torch.equal(a[i], b), (i, name)


def test_tree_helpers():
    case = transport(n=8, device="cpu")
    names = [n for n, _ in named_leaves(case.state)]
    assert names == ["flow.u", "flow.v", "flow.p", "flow.t", "flow.step", "theta"]
    flat = leaves(case.state)
    assert len(flat) == 6 and flat[-1] is case.state.theta
    again = rebuild(case.state, flat)
    assert isinstance(again, tr.CoupledState) and again.flow.u is case.state.flow.u
    doubled = tree_map(lambda x: x * 2, case.state)
    assert torch.equal(doubled.theta, case.state.theta * 2)
    assert leaves(3.0) == [3.0]


def test_coupled_state_round_trips_through_numpy():
    case = transport(n=16, device="cpu")
    s, _ = case.step(case.state, 1.0)
    back = coupled_state_from_numpy(**coupled_state_to_numpy(s), device="cpu")
    for (name, a), b in zip(named_leaves(back), leaves(s)):
        assert torch.equal(a, b) and a.dtype == b.dtype, name


def test_coupled_step_carries_the_flow_steps_facts():
    case = transport(n=16, fused_predictor=True, device="cpu")
    assert case.step.reads_host is False and case.step.device == torch.device("cpu")
    assert case.step.cfg is case.cfg[0] and case.cfg[1].kappa == pytest.approx(0.01)
    assert dict(case.step.named_buffers()).keys() >= {"flow_step.imask", "flow_step.dt_base"}
