"""The stretched MAC tier of the port (``models/mac_stretched.py``) against
the JAX package: five steps of ``cavity_stretched`` and
``cylinder_stretched``, the stretched step on uniform faces against the
uniform MAC step (the twin of tests/test_stretched.py:61-100), the exact
projection, and the float64 set-up (faces and metrics) bit for bit.

Tolerances: five steps as in tests/test_torch_mac.py; the stretched step on
uniform faces within atol 5e-6 of the MAC step after 15 steps
(test_stretched.py's band); the face generators and metrics bit for bit.
"""

import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.models import mac_stretched as jms
from cfdsim_tpu_torch.cases import build, lid_cavity_mac
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.models import mac_stretched as ms

from test_torch_mac import compare_steps  # noqa: E402


@pytest.mark.parametrize("kw", [dict(n=32), dict(n=32, scheme="tvd", Re=400.0),
                                dict(n=32, time_scheme="rk2", projection="incremental"),
                                dict(n=32, scheme="upwind", beta=2.0)],
                         ids=["default", "tvd", "rk2-incremental", "upwind-beta2"])
def test_cavity_stretched_five_steps_match_jax(kw):
    j, t = j_build("cavity_stretched", **kw), build("cavity_stretched", device="cpu", **kw)
    compare_steps(j.step, t.step, j.state, float(np.diff(t.extras["x_faces"]).min()))


def test_cylinder_stretched_five_steps_match_jax():
    kw = dict(nx=64, ny=32)
    j, t = j_build("cylinder_stretched", **kw), build("cylinder_stretched", device="cpu", **kw)
    for k in ("ibm_mask_u", "ibm_mask_v"):
        assert np.array_equal(np.asarray(j.extras[k]), t.extras[k])
    assert t.extras["h_near"] == j.extras["h_near"]
    h = min(np.diff(t.extras["x_faces"]).min(), np.diff(t.extras["y_faces"]).min())
    compare_steps(j.step, t.step, j.state, float(h))


@pytest.mark.parametrize("scheme, Re", [("central", 100.0), ("tvd", 400.0)])
def test_stretched_uniform_matches_mac_step(scheme, Re):
    n = 32
    xf = np.linspace(0, 1, n + 1)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=1.0 / Re, scheme=scheme, cfl_target=0.5,
                                dt_max=0.5 / n)
    step_s = ms.make_step(cfg, mac.cavity_bcs(1.0), xf, xf, device="cpu")
    case_u = lid_cavity_mac(n=n, Re=Re, scheme=scheme, device="cpu")
    ss, su = ms.init_state(cfg, device="cpu"), case_u.state
    for _ in range(15):
        ss, _ = step_s(ss, 1.0)
        su, _ = case_u.step(su, 1.0)
    assert float((ss.u - su.u).abs().max()) <= 5e-6
    assert float((ss.v - su.v).abs().max()) <= 5e-6


def test_stretched_projection_exact():
    n = 40
    xf = ms.wall_clustered_faces(n, 1.0, beta=2.0)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=0.01, cfl_target=0.5, dt_max=0.1 / n)
    step = ms.make_step(cfg, mac.cavity_bcs(1.0), xf, xf, device="cpu")
    s = ms.init_state(cfg, device="cpu")
    for _ in range(40):
        s, m = step(s, 1.0)
    assert bool(torch.isfinite(s.u).all())
    assert float(m.div_post) < 1e-3 * max(1.0, float(m.div_pre))


def test_faces_and_metrics_equal_jax():
    pairs = [(ms.wall_clustered_faces(33, 2.5, beta=2.0, x_min=-1.0),
              jms.wall_clustered_faces(33, 2.5, beta=2.0, x_min=-1.0)),
             (ms.stretched_faces(40, 10.0, refine=[(3.0, 1.0, 3.0), (5.0, 2.0, 1.5)]),
              jms.stretched_faces(40, 10.0, refine=[(3.0, 1.0, 3.0), (5.0, 2.0, 1.5)]))]
    for a, b in pairs:
        assert np.array_equal(a, b)
        for x, y in zip(ms._metrics(a), jms._metrics(b)):
            assert np.array_equal(x, y)
    xf = pairs[0][0]
    assert xf[0] == -1.0 and xf[-1] == 1.5 and np.all(np.diff(xf) > 0)


def test_faces_must_match_the_config():
    cfg = ms.StretchedMACConfig(nx=8, ny=8, nu=0.01)
    with pytest.raises(ValueError, match="faces"):
        ms.make_step(cfg, mac.cavity_bcs(), np.linspace(0, 1, 10), np.linspace(0, 1, 9),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        ms.make_step(cfg, mac.cavity_bcs(), np.linspace(0, 1, 9), np.linspace(0, 1, 9),
                     moving_scheme="ghost", device="cpu")


def test_stretched_state_is_a_mac_state():
    case = build("cavity_stretched", n=16, device="cpu")
    assert isinstance(case.state, mac.MACState)
    assert tuple(case.state.u.shape) == (16, 17) and tuple(case.state.v.shape) == (17, 16)
    assert case.step.reads_host is False
