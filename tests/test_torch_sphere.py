"""The port's immersed sphere and the stretched 3D MAC tier against the JAX
package: the 3D ``ibm.py`` builders, ``make_fdm_solver_3d``, five steps
each of ``sphere`` and ``sphere_stretched`` (penalization and ghost-cell
IBM; dynamic LES on both IBMs), ``cavity3d_stretched`` ({central, tvd} ×
{euler, rk2}, static and dynamic LES), and a moving sphere (penalization
and ghost forcing, uniform and stretched), and the golden
``sphere_ghost_ibm``.

Tolerances:
- the builders: the masks and potential-flow fields equal (the same
  float64 numpy cast once); the oscillating sphere's centre and velocity
  within 1e-6 relative (torch's and XLA's float32 sine and cosine differ in
  the last bit: 1.2404702 against 1.2404701 at t = 0.37);
- the FDM solve: within 1e-6 of max|φ| (the same float32 products, summed
  by cuBLAS/MKL and XLA in their own orders), and its residual ≤ 1e-4 of
  max|rhs|;
- five steps (from the state after 20 jitted JAX steps;
  ``tests/test_torch_mac3d.py::compare_mac3d_steps``): u, v, w within 1e-6
  of max|u, v, w|, p within 1e-5 of max|p|, metrics within 1e-5 relative
  (the forces of the largest component); ``div_post`` at float32 roundoff
  on each side (1e-5·max|u|/h) in the closed cavity and the moving-body
  box; under the external-flow BCs, whose outflow faces are rewritten
  after the projection, within 1e-5 relative plus 1e-6·max|u|/h: that
  divergence (5e-4 at these grids) is a difference of O(max|u|) outflow
  faces, whose float32 rounding alone is ~1e-7·max|u|/h (the two sides
  differ by up to 8e-5 of it, 4.5e-8 absolute);
- the golden (60 steps at 36×20×20) by the rule of
  tests/test_goldens.py:112-124: RTOL 2e-5, the noise floor 1e-6 of the
  largest key for keys below it (fy, ~4.6e-9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import ibm as jibm
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid3D as JGrid3D
from cfdsim_tpu.models import mac3d as jm3
from cfdsim_tpu.models import mac_stretched3d as js3
from cfdsim_tpu.solvers.fdm import make_fdm_solver_3d as j_fdm3
from cfdsim_tpu_torch import ibm as tibm
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.models import mac3d as tm3
from cfdsim_tpu_torch.models import mac_stretched3d as ts3
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.models.mac_stretched import stretched_faces, wall_clustered_faces
from cfdsim_tpu_torch.solvers.fdm import make_fdm_solver_3d
from test_torch_mac import golden_deviation
from test_torch_mac3d import compare_mac3d_steps

BODY_RTOL = 1e-6
DIV_FLOOR = 1e-6  # of max|u|/h: the float32 floor of the outflow column's divergence
FDM_RTOL = 1e-6
FDM_RESIDUAL_RTOL = 1e-4

# a D = 1 sphere at 4 cells per diameter: small enough for 5 steps a case
SMALL = dict(nx=24, ny=12, nz=12, domain=(6.0, 3.0, 3.0), center=(2.0, 1.5, 1.5),
             ibm_ramp_steps=4)


def _stretched_faces():
    return (stretched_faces(24, 6.0, refine=[(2.0, 1.0, 2.0)]),
            stretched_faces(12, 3.0, refine=[(1.5, 1.0, 2.0)]),
            stretched_faces(12, 3.0, refine=[(1.5, 1.0, 2.0)]))


@pytest.mark.parametrize("profile", ["sharp", "shell"])
def test_sphere_builders_equal_jax(profile):
    xf, yf, zf = _stretched_faces()
    ctr = (2.1, 1.45, 1.55)
    want = jibm.sphere_masks_faces(xf, yf, zf, ctr, 0.5, profile=profile)
    got = tibm.sphere_masks_faces(xf, yf, zf, ctr, 0.5, profile=profile)
    for a, b in zip(want, got):
        assert b.dtype == np.float32 and np.array_equal(np.asarray(a), b)
    assert np.array_equal(np.asarray(jibm.sphere_mask_cells(xf, yf, zf, ctr, 0.5, profile)),
                          tibm.sphere_mask_cells(xf, yf, zf, ctr, 0.5, profile))
    flow_j = jibm.potential_flow_sphere_faces(xf, yf, zf, ctr, 0.5, 1.3, *want)
    flow_t = tibm.potential_flow_sphere_faces(xf, yf, zf, ctr, 0.5, 1.3, *got)
    for a, b in zip(flow_j, flow_t):
        assert np.array_equal(np.asarray(a), b)
    kw = dict(nx=24, ny=12, nz=12, x_max=6.0, y_max=3.0, z_max=3.0, centering="cell")
    mj = jibm.sphere_masks_mac3d(JGrid3D(**kw), ctr, 0.5, profile)
    mt = tibm.sphere_masks_mac3d(Grid3D(**kw), ctr, 0.5, profile)
    for a, b in zip(mj, mt):
        assert np.array_equal(np.asarray(a), b)
    for a, b in zip(jibm.potential_flow_sphere_mac3d(JGrid3D(**kw), ctr, 0.5, 1.0, *mj),
                    tibm.potential_flow_sphere_mac3d(Grid3D(**kw), ctr, 0.5, 1.0, *mt)):
        assert np.array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="profile"):
        tibm.sphere_mask_cells(xf, yf, zf, ctr, 0.5, profile="box")


def test_oscillating_sphere_equals_jax():
    for axis in (0, 1, 2):
        jb = jibm.oscillating_sphere((1.0, 2.0, 3.0), 0.5, 0.3, 2.5, axis=axis)
        tb = tibm.oscillating_sphere((1.0, 2.0, 3.0), 0.5, 0.3, 2.5, axis=axis)
        for t in (0.0, 0.37, 1.9):
            for f in ("center", "velocity"):
                a = [float(x) for x in getattr(jb, f)(jnp.float32(t))]
                b = [float(x) for x in getattr(tb, f)(torch.tensor(t))]
                np.testing.assert_allclose(b, a, rtol=BODY_RTOL, atol=BODY_RTOL)


def test_fdm_3d_matches_jax():
    xf, yf, zf = _stretched_faces()
    hx, hy, hz = (np.diff(f) for f in (xf, yf, zf))
    rhs = np.random.default_rng(0).standard_normal((12, 12, 24))
    vol = hz[:, None, None] * hy[None, :, None] * hx[None, None, :]
    rhs = (rhs - (vol * rhs).sum() / vol.sum()).astype(np.float32)  # the solvable part
    want = np.asarray(jax.jit(j_fdm3(hx, hy, hz))(jnp.asarray(rhs)))
    solver = make_fdm_solver_3d(hx, hy, hz, device="cpu")
    got = solver(torch.tensor(rhs)).numpy()
    assert float(np.abs(got - want).max()) <= FDM_RTOL * float(np.abs(want).max())
    # the discrete operator of the stretched projection: ∇·(∇φ) on the metrics
    cfg = ts3.StretchedMAC3DConfig(nx=24, ny=12, nz=12, nu=0.1)
    step = ts3.make_step(cfg, tm3.cavity3d_bcs(), xf, yf, zf, device="cpu")
    phi = torch.tensor(got)
    gu = torch.nn.functional.pad((phi[:, :, 1:] - phi[:, :, :-1]) * step.inv_dcx, (1, 1))
    gv = torch.nn.functional.pad((phi[:, 1:, :] - phi[:, :-1, :]) * step.inv_dcy, (0, 0, 1, 1))
    gw = torch.nn.functional.pad((phi[1:] - phi[:-1]) * step.inv_dcz, (0, 0, 0, 0, 1, 1))
    res = step.divergence(gu, gv, gw) - torch.tensor(rhs)
    assert float(res.abs().max()) <= FDM_RESIDUAL_RTOL * float(np.abs(rhs).max())
    with pytest.raises(ValueError, match="built for"):
        solver(torch.zeros(12, 12, 12))


CASE_STEPS = [
    ("sphere", dict(ibm_scheme="penalize")),
    ("sphere", dict(ibm_scheme="ghost")),
    ("sphere", dict(ibm_scheme="penalize", use_les=True, les_model="dynamic", Re=3900.0)),
    ("sphere_stretched", dict(ibm_scheme="penalize", refine_strength=2.0, refine_width=1.0)),
    ("sphere_stretched", dict(ibm_scheme="ghost", refine_strength=2.0, refine_width=1.0)),
    ("sphere_stretched", dict(ibm_scheme="ghost", refine_strength=2.0, refine_width=1.0,
                              use_les=True, les_model="dynamic", Re=3900.0)),
]


@pytest.mark.parametrize("name, kw", CASE_STEPS,
                         ids=["penalize", "ghost", "penalize-dynamic-les", "stretched-penalize",
                              "stretched-ghost", "stretched-ghost-dynamic-les"])
def test_sphere_cases_five_steps_match_jax(name, kw):
    kw = {**SMALL, **kw}
    j = j_build(name, **kw)
    t = build(name, device="cpu", **kw)
    assert t.step.reads_host is False and t.extras["coeff_scale"] == j.extras["coeff_scale"]
    h = t.extras.get("h_min", t.grid.dx)
    compare_mac3d_steps(j.step, t.step, j.state, h, exact_div=False, div_floor=DIV_FLOOR)


CAVITY_OPTIONS = [dict(scheme=s, time_scheme=ts) for s in ("central", "tvd")
                  for ts in ("euler", "rk2")]
CAVITY_OPTIONS += [dict(use_les=True, Re=4000.0), dict(use_les=True, les_model="dynamic",
                                                       Re=4000.0, scheme="tvd"),
                   dict(projection="incremental", scheme="upwind")]


@pytest.mark.parametrize("kw", CAVITY_OPTIONS,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_cavity3d_stretched_five_steps_match_jax(kw):
    kw = {"n": 16, **kw}
    j = j_build("cavity3d_stretched", **kw)
    t = build("cavity3d_stretched", device="cpu", **kw)
    assert t.step.reads_host is False
    compare_mac3d_steps(j.step, t.step, j.state, float(np.diff(t.extras["x_faces"]).min()))


def test_cavity3d_mac_dynamic_les_matches_jax():
    """``mac3d`` with the dynamic model, no body (the contraction unmasked)."""
    kw = dict(n=16, use_les=True, les_model="dynamic", Re=4000.0, scheme="tvd")
    j = j_build("cavity3d_mac", **kw)
    t = build("cavity3d_mac", device="cpu", **kw)
    assert t.step.les_fluid_mask is None
    compare_mac3d_steps(j.step, t.step, j.state, 1.0 / 16)


def _moving_pair(stretched: bool, scheme: str):
    """A sphere oscillating along x in a free-slip box, on both sides."""
    args = ((1.5, 1.0, 1.0), 0.35, 0.25, 2.0)
    jb, tb = jibm.oscillating_sphere(*args), tibm.oscillating_sphere(*args)
    common = dict(nu=0.01, scheme="tvd", cfl_target=0.3)
    body = dict(moving_scheme=scheme, ibm_ramp_steps=3)
    if stretched:
        xf = stretched_faces(24, 3.0, refine=[(1.5, 0.8, 2.0)])
        yf = zf = stretched_faces(16, 2.0, refine=[(1.0, 0.8, 2.0)])
        cj = js3.StretchedMAC3DConfig(nx=24, ny=16, nz=16, **common)
        ct = ts3.StretchedMAC3DConfig(nx=24, ny=16, nz=16, **common)
        js = js3.make_step(cj, jm3.free_slip_bcs3d(), xf, yf, zf, moving_body=jb, **body)
        ts = ts3.make_step(ct, tm3.free_slip_bcs3d(), xf, yf, zf, moving_body=tb,
                           device="cpu", **body)
        return js, ts, js3.init_state(cj), float(np.diff(xf).min())
    kw = dict(nx=24, ny=16, nz=16, x_max=3.0, y_max=2.0, z_max=2.0, centering="cell")
    cj = jm3.MAC3DConfig(grid=JGrid3D(**kw), **common)
    ct = tm3.MAC3DConfig(grid=Grid3D(**kw), **common)
    js = jm3.make_step(cj, jm3.free_slip_bcs3d(), moving_body=jb, **body)
    ts = tm3.make_step(ct, tm3.free_slip_bcs3d(), moving_body=tb, device="cpu", **body)
    return js, ts, jm3.init_state(cj), 0.125


@pytest.mark.parametrize("scheme", ["penalize", "ghost"])
@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_moving_sphere_five_steps_match_jax(stretched, scheme):
    j_step, t_step, j_state, h = _moving_pair(stretched, scheme)
    assert t_step.reads_host is False
    compare_mac3d_steps(j_step, t_step, j_state, h)


def test_refusals_keep_the_jax_value_errors():
    cfg = ts3.StretchedMAC3DConfig(nx=8, ny=8, nz=8, nu=0.1, use_les=True,
                                   les_model="dynamic")
    faces = wall_clustered_faces(8, 1.0)
    body = tibm.oscillating_sphere((0.5, 0.5, 0.5), 0.2, 0.1, 1.0)
    with pytest.raises(ValueError, match="moving_body"):
        ts3.make_step(cfg, tm3.cavity3d_bcs(), faces, faces, faces, moving_body=body,
                      device="cpu")
    with pytest.raises(ValueError, match="faces for"):
        ts3.make_step(dataclasses.replace(cfg, nx=9), tm3.cavity3d_bcs(), faces, faces, faces,
                      device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts3.make_step(dataclasses.replace(cfg, use_les=False), tm3.cavity3d_bcs(), faces, faces,
                      faces, ibm_mask_u=np.zeros((8, 8, 9)), ibm_ghost=object(), device="cpu")
    with pytest.raises(ValueError, match="ibm_scheme"):
        build("sphere", nx=16, ny=8, nz=8, ibm_scheme="box", device="cpu")


def golden_signature(case, steps: int) -> dict:
    """tests/test_goldens.py::_run_signature on the port: ``steps`` steps,
    the L2 and max of every field, and the metrics of one more step."""
    s, _ = make_chunk(case.cfg, case.step, steps)(case.state, 1.0)
    _, m = case.step(s, 1.0)
    sig = {}
    for name in s._fields:
        v = getattr(s, name)
        if v.ndim >= 2:
            sig[f"l2_{name}"] = float(torch.sqrt((v * v).mean()))
            sig[f"max_{name}"] = float(v.abs().max())
    for name in ("energy", "max_vel", "fx", "fy", "nusselt", "q_body", "vort_max"):
        if hasattr(m, name):
            sig[name] = float(getattr(m, name))
    return sig


def test_golden_sphere_ghost_ibm():
    """tests/test_goldens.py:48: ``sphere_stretched`` with ghost stencils,
    60 steps at 36×20×20."""
    case = build("sphere_stretched", nx=36, ny=20, nz=20, Re=100.0, domain=(8.0, 4.0, 4.0),
                 center=(2.0, 2.0, 2.0), refine_strength=2.0, refine_width=1.0,
                 ibm_scheme="ghost", ibm_ramp_steps=4, device="cpu")
    sig = golden_signature(case, 60)
    dev = golden_deviation("sphere_ghost_ibm", sig)
    assert set(sig) == set(dev), (sorted(sig), sorted(dev))
    assert max(dev.values()) <= 1.0, dev
