"""The implicit (backward-Euler) viscous step of the port against the JAX
package: both back ends (the exact DST Helmholtz solve and damped Jacobi
with the BCs inside each sweep), ``auto``, and LES with implicit diffusion,
on the CPU.

Tolerances: five steps from a developed 32² state, float32 both sides: u,
v and t atol 1e-5 (the cavity's band, tests/test_torch_cavity.py; observed
≤ 4e-7), p 1e-4 of max |p|, metrics relative 5e-5 with ``poisson_res`` as
in tests/test_torch_cylinder.py. The physics twins keep the bands of the
JAX tests they mirror (tests/test_helmholtz.py:40-58,
tests/test_incompressible.py:101-123).
"""

import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu_torch.cases import build, lid_cavity
from cfdsim_tpu_torch.models.incompressible import chunk_route, make_chunk
from cfdsim_tpu_torch.validation import ghia_error
from test_torch_schemes import _compare_flow_steps, _developed

CASES = {
    "dst": dict(n=32, Re=100.0, diffusion="implicit", implicit_solver="dst"),
    "auto-is-dst": dict(n=32, Re=100.0, diffusion="implicit"),
    "jacobi": dict(n=32, Re=100.0, diffusion="implicit", implicit_solver="jacobi"),
    "jacobi-4-sweeps": dict(n=32, Re=10.0, diffusion="implicit", implicit_solver="jacobi",
                            implicit_iters=4),
    "les-auto-is-jacobi": dict(n=32, Re=100.0, diffusion="implicit", use_les=True),
    "les-jacobi-upwind": dict(n=33, Re=1000.0, diffusion="implicit", use_les=True,
                              implicit_solver="jacobi", scheme="upwind"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_implicit_steps_match_jax(name):
    kw = CASES[name]
    j_case, t_case = j_build("cavity", **kw), build("cavity", device="cpu", **kw)
    assert t_case.step.use_dst == name.endswith("dst")
    start = _developed(j_case.step, j_case.state)
    _, _, tm = _compare_flow_steps(j_case.step, t_case.step, start)
    # no viscous bound: dt is the CFL dt clipped to the case's dt_max
    assert float(tm.dt) == pytest.approx(t_case.cfg.dt_max, rel=1e-6)


def test_implicit_cylinder_with_ibm_matches_jax():
    """Implicit DST diffusion under the cylinder's inflow/outflow BCs, IBM
    and warm-up dt."""
    kw = dict(nx=96, ny=32, diffusion="implicit", warmup_steps=2, ibm_ramp_steps=3)
    j_case, t_case = j_build("cylinder", **kw), build("cylinder", device="cpu", **kw)
    start = _developed(j_case.step, j_case.state, steps=1)
    _compare_flow_steps(j_case.step, t_case.step, start)


def test_implicit_dst_matches_tight_jacobi():
    """tests/test_helmholtz.py:40: the DST back end agrees with a very tight
    Jacobi solve to float32 levels (atol 5e-5)."""
    kw = dict(n=48, Re=100.0, diffusion="implicit", device="cpu")
    c_dst = lid_cavity(implicit_solver="dst", **kw)
    c_jac = lid_cavity(implicit_solver="jacobi", implicit_iters=400, **kw)
    s = c_dst.state
    for _ in range(3):
        s_dst, _ = c_dst.step(s, 1.0)
        s_jac, _ = c_jac.step(s, 1.0)
        assert float((s_dst.u - s_jac.u).abs().max()) <= 5e-5
        s = s_dst


def test_implicit_dst_step_drops_viscous_dt_limit():
    """tests/test_helmholtz.py:58."""
    case = lid_cavity(n=32, Re=10.0, diffusion="implicit", device="cpu")
    h = case.grid.dx
    s = case.state
    for _ in range(50):
        s, m = case.step(s, 1.0)
    assert bool(torch.isfinite(s.u).all())
    assert float(m.max_vel) < 1.5
    assert float(m.dt) > 0.2 * h * h / case.cfg.nu


def test_implicit_diffusion_stable_beyond_explicit_limit():
    """tests/test_incompressible.py:101: dt above the explicit bound, and
    the Ghia profiles at Re=100 (RMS < 0.03 on a 48² grid)."""
    case = lid_cavity(n=48, Re=100.0, diffusion="implicit", cfl=0.7, device="cpu")
    h = case.grid.dx
    state, metrics = make_chunk(case.cfg, case.step, 2000)(case.state, 1.0)
    assert float(metrics.dt[-1]) > 0.2 * h * h / case.cfg.nu
    assert bool(torch.isfinite(state.u).all())
    eu, ev = ghia_error(state.u.numpy(), state.v.numpy(), 100, case.grid.y_coords(),
                        case.grid.x_coords())
    assert eu < 0.03 and ev < 0.03


def test_les_and_upwind_variants_stable():
    """tests/test_incompressible.py:116."""
    case = lid_cavity(n=32, Re=1000.0, scheme="upwind", use_les=True, device="cpu")
    state, metrics = make_chunk(case.cfg, case.step, 200)(case.state, 1.0)
    assert bool(torch.isfinite(state.u).all())
    assert float(metrics.max_vel[-1]) <= 1.0 + 1e-3


@pytest.mark.parametrize("kw", [
    dict(diffusion="implicit"),
    dict(diffusion="implicit", implicit_solver="jacobi"),
    dict(diffusion="implicit", use_les=True),
    dict(use_les=True, scheme="tvd"),
], ids=["dst", "jacobi", "les-jacobi", "les-tvd"])
def test_new_steps_read_nothing_on_the_host(kw):
    """dt·ν stays a tensor expression, so a chunk of these steps would take
    the graph route on a card (and is the loop here, for the device only)."""
    case = lid_cavity(n=16, Re=100.0, device="cpu", **kw)
    assert case.step.reads_host is False
    assert chunk_route("cuda", case.step.reads_host)[0] == "graph"
    assert make_chunk(case.cfg, case.step, 2).mode == "loop"


def test_implicit_solver_choices_are_checked():
    with pytest.raises(ValueError, match="implicit_solver"):
        lid_cavity(n=16, diffusion="implicit", implicit_solver="cg", device="cpu")
    with pytest.raises(ValueError, match="scalar viscosity"):
        lid_cavity(n=16, diffusion="implicit", implicit_solver="dst", use_les=True,
                   device="cpu")
