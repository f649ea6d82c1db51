"""3D heat transport in the port (``models/transport3d.py``,
``models/boussinesq3d.py``; the cases ``heated_sphere``,
``heated_sphere_stretched`` and ``heated_cube``) against the JAX package:
five steps from a developed state, the golden ``heated_sphere_nu``, a
native-snapshot resume of θ and the command line's ``run heated_sphere
--resume``.

Tolerances (five steps from the state after 20 jitted JAX steps):
- u, v, w within 1e-6 of max|u, v, w|; θ within 1e-6 of max|θ| (the θ
  extrema too); p within 1e-5 of max|p|; the other metrics within 1e-5
  relative (the forces of the largest component, as
  tests/test_torch_mac3d.py holds them);
- ``div_post``: at float32 roundoff on each side (1e-5·max|u|/h) in the
  closed cube; under the external-flow BCs (whose outflow faces are
  rewritten after the projection) within 1e-5 relative plus
  1e-6·max|u|/h, the float32 floor of a difference of O(max|u|) faces
  (tests/test_torch_sphere.py);
- the golden (60 steps at 32×16×16) by the rule of
  tests/test_goldens.py:112-124: RTOL 2e-5, the noise floor 1e-6 of the
  largest key for keys below it (fy, ~3e-9; vort_max, 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.models import transport3d as jt3
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import (
    boussinesq3d_state_from_numpy,
    state_to_numpy,
    transport3d_state_from_numpy,
)
from cfdsim_tpu_torch.io_ import restore
from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter, csnap_steps
from cfdsim_tpu_torch.models import transport3d as tt3
from cfdsim_tpu_torch.models.incompressible import make_chunk
from test_torch_mac import golden_deviation
from test_torch_sphere import golden_signature

UV_RTOL = THETA_RTOL = 1e-6
P_RTOL = 1e-5
METRIC_RTOL = 1e-5
DIV_POST_RTOL = 1e-5
DIV_FLOOR = 1e-6
FIELDS = ("u", "v", "w", "p", "theta", "t", "step")

SMALL = dict(nx=24, ny=12, nz=12, domain=(6.0, 3.0, 3.0), center=(2.0, 1.5, 1.5),
             ibm_ramp_steps=4)


def _to_port(js, convert):
    return convert(*(np.asarray(getattr(js, k)) for k in FIELDS), device="cpu")


def compare_theta_steps(j, t, convert, h, exact_div, pre=20, steps=5):
    """``pre`` jitted JAX steps of ``j`` (a case), then ``steps`` on both
    sides; the bands of the module docstring."""
    j_step = jax.jit(j.step)
    js = j.state
    for _ in range(pre):
        js, _ = j_step(js, jnp.float32(1.0))
    ts = _to_port(js, convert)
    for _ in range(steps):
        js, jm = j_step(js, jnp.float32(1.0))
        ts, tm = t.step(ts, 1.0)
    got = state_to_numpy(ts)
    vel = max(np.abs(np.asarray(getattr(js, k))).max() for k in ("u", "v", "w"))
    theta_max = float(np.abs(np.asarray(js.theta)).max())
    for k in ("u", "v", "w"):
        assert np.abs(got[k] - np.asarray(getattr(js, k))).max() <= UV_RTOL * vel, k
    assert np.abs(got["theta"] - np.asarray(js.theta)).max() <= THETA_RTOL * theta_max
    want_p = np.asarray(js.p)
    assert np.abs(got["p"] - want_p).max() <= P_RTOL * np.abs(want_p).max()
    assert got["step"] == int(js.step) and abs(got["t"] - float(js.t)) <= 1e-6
    forces = [f for f in ("fx", "fy", "fz") if f in jm._fields]
    scale = max([abs(float(getattr(jm, f))) for f in forces] + [1e-12])
    for name in jm._fields:
        a, b = float(getattr(jm, name)), float(getattr(tm, name))
        if name == "div_post" and exact_div:
            assert a <= DIV_POST_RTOL * vel / h and b <= DIV_POST_RTOL * vel / h, (a, b)
        elif name == "div_post":
            assert abs(a - b) <= METRIC_RTOL * a + DIV_FLOOR * vel / h, (a, b)
        elif name in forces:
            assert abs(a - b) <= METRIC_RTOL * scale, (name, a, b)
        elif name in ("theta_min", "theta_max"):
            assert abs(a - b) <= THETA_RTOL * theta_max, (name, a, b)
        else:
            assert abs(a - b) <= METRIC_RTOL * max(abs(a), 1e-12), (name, a, b)
    return tm


@pytest.mark.parametrize("name, kw", [
    ("heated_sphere", dict(ibm_scheme="penalize")),
    ("heated_sphere", dict(ibm_scheme="ghost")),
    ("heated_sphere", dict(ibm_scheme="penalize", theta_scheme="tvd")),
    ("heated_sphere", dict(ibm_scheme="ghost", theta_scheme="central", scheme="upwind")),
    ("heated_sphere_stretched", dict(ibm_scheme="penalize", refine_strength=2.0,
                                     refine_width=1.0)),
    ("heated_sphere_stretched", dict(ibm_scheme="ghost", theta_scheme="tvd",
                                     refine_strength=2.0, refine_width=1.0)),
], ids=["penalize", "ghost", "tvd-theta", "ghost-central-theta", "stretched-penalize",
        "stretched-ghost-tvd"])
def test_heated_sphere_five_steps_match_jax(name, kw):
    kw = {**SMALL, **kw}
    j = j_build(name, **kw)
    t = build(name, device="cpu", **kw)
    assert t.step.reads_host is False
    h = t.extras.get("h_min", t.grid.dx)
    tm = compare_theta_steps(j, t, transport3d_state_from_numpy, h, exact_div=False)
    assert float(tm.nusselt) > 0.0 and float(tm.q_body) > 0.0  # the body heats the stream


@pytest.mark.parametrize("kw", [dict(), dict(theta_scheme="upwind", flow_scheme="tvd")],
                         ids=["central", "upwind-tvd"])
def test_heated_cube_five_steps_match_jax(kw):
    kw = {"n": 16, "Ra": 1e4, **kw}
    j = j_build("heated_cube", **kw)
    t = build("heated_cube", device="cpu", **kw)
    assert t.step.reads_host is False
    for k in ("u", "v", "w", "p", "theta"):
        assert np.array_equal(np.asarray(getattr(j.state, k)), getattr(t.state, k).numpy()), k
    tm = compare_theta_steps(j, t, boussinesq3d_state_from_numpy, 1.0 / 16, exact_div=True)
    assert torch.equal(tm.div_pre, tm.div_post) and float(tm.vort_max) == 0.0


def test_theta_ghost_and_refusals_match_jax():
    th = np.random.default_rng(6).random((6, 7, 8)).astype(np.float32)
    want = np.asarray(jt3._theta_ghost_open(jnp.asarray(th), 0.25))
    assert np.array_equal(tt3._theta_ghost_open(torch.tensor(th), 0.25).numpy(), want)
    with pytest.raises(ValueError, match="theta_scheme"):
        build("heated_sphere", nx=16, ny=8, nz=8, theta_scheme="quick", device="cpu")
    with pytest.raises(ValueError, match="ibm_scheme"):
        build("heated_sphere_stretched", nx=16, ny=8, nz=8, ibm_scheme="box", device="cpu")
    with pytest.raises(ValueError, match="FDM"):
        from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

        build("heated_sphere_stretched", nx=16, ny=8, nz=8, device="cpu",
              poisson=Poisson3DConfig(method="mg"))
    case = build("heated_sphere", nx=16, ny=8, nz=8, domain=(4.0, 2.0, 2.0),
                 center=(1.0, 1.0, 1.0), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt3.make_step(case.cfg, case.extras["bcs"], ibm_mask_c=np.zeros((8, 8, 16)),
                      ibm_ghost_c=object(), device="cpu")


def test_golden_heated_sphere_nu():
    """tests/test_goldens.py:42: ``heated_sphere`` with penalization, 60
    steps at 32×16×16."""
    case = build("heated_sphere", nx=32, ny=16, nz=16, Re=100.0, domain=(8.0, 4.0, 4.0),
                 center=(2.0, 2.0, 2.0), ibm_ramp_steps=4, device="cpu")
    sig = golden_signature(case, 60)
    dev = golden_deviation("heated_sphere_nu", sig)
    assert set(sig) == set(dev), (sorted(sig), sorted(dev))
    assert max(dev.values()) <= 1.0, dev


def test_native_snapshot_restores_theta(tmp_path):
    case = build("heated_sphere", nx=16, ny=8, nz=8, domain=(4.0, 2.0, 2.0),
                 center=(1.0, 1.0, 1.0), ibm_scheme="ghost", ibm_ramp_steps=2, device="cpu")
    s, _ = make_chunk(case.cfg, case.step, 10)(case.state, 1.0)
    writer = NativeSnapshotWriter(tmp_path / "t3.csnap")
    writer.save(int(s.step), float(s.t), u=s.u, v=s.v, w=s.w, p=s.p, theta=s.theta)
    writer.close()
    restored = restore(case.state, tmp_path / "t3.csnap")
    for k in s._fields:
        assert torch.equal(getattr(restored, k), getattr(s, k)), k
    a, _ = case.step(restored, 1.0)
    b, _ = case.step(s, 1.0)
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in a._fields)


def test_cli_run_heated_sphere_resume_bit_exact(tmp_path):
    """``run heated_sphere`` with ghost stencils, 16 steps, and a
    native-snapshot ``--resume`` of it against one uninterrupted run."""
    common = ["--nx", "16", "--ny", "8", "--nz", "8", "--domain", "(4.0,2.0,2.0)",
              "--center", "(1.0,1.0,1.0)", "--ibm-scheme", "ghost", "--theta-scheme", "tvd",
              "--chunk-steps", "8", "--snapshot-interval", "8", "--device", "cpu",
              "--io", "native"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", "heated_sphere", "--max-steps", "8", "--out", str(out_a), *common])
    report = cli.main(["run", "heated_sphere", "--max-steps", "16", "--out", str(out_a),
                       "--resume", *common])
    assert report["final_step"] == 16 and report["total_steps"] == 8
    assert not report["stopped_reason"]
    cli.main(["run", "heated_sphere", "--max-steps", "16", "--out", str(out_b), *common])
    a, b = csnap_steps(out_a / "snapshots.csnap"), csnap_steps(out_b / "snapshots.csnap")
    assert sorted(a) == sorted(b) == [0, 8, 16]
    for step in a:
        assert set(a[step][0]) == {"u", "v", "w", "p", "theta"}
        for name in a[step][0]:
            np.testing.assert_array_equal(a[step][0][name], b[step][0][name])
