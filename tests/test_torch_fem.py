"""The FEM steps of the port (``models/fem.py``) against the JAX package,
and the FEM pipeline: cases, chunks, the CLI's snapshots and resume,
``convert``, ``run_on_device`` and the implicit adjoint.

Step parity: both packages step five times from the same state (the port's
Stokes initial state of ``cylinder_fem`` on a 582-triangle mesh, dt = 0.02)
through the monolithic step (τ∇p·∇q, PSPG, θ = ½, Taylor-Hood at dt =
0.005) and the projection step (P1-P1, Taylor-Hood with SUPG at θ = ½, the
rotational form). The solvers must run the same iterations: the calls of
the operator each step assembles (``apply_ns``; ``apply_momentum_conv`` and
``apply_stiffness_p`` or ``apply_div_u``) are counted on both sides (to one
iteration a step: ``CALLS_APART``). Tolerances, from the measured worst
(float32 einsums and Krylov sums in another order; each GMRES stops within
its 1e-5 tolerance, where two rounding paths leave iterates some 1e-5
apart): u within 5e-5 of max|u|, p less its mean within 1e-3 of max|p|
(measured ≤ 9.6e-6 and 1.7e-4, both PSPG's), the forces within 2e-3 of the
larger of |fx|, |fy| (measured 3.5e-4), the other metrics within 1e-4
relative (measured 2.8e-6), ``poisson_res`` (a residual at the solver's
tolerance) within 2e-2 relative (measured 1.9e-3); the step count equal, t
to 1e-6 (a float64 state's t stays float32 in the port). The Taylor-Hood
monolithic step runs in float64 on both sides (``FP64_RTOL``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdsim_tpu.models.fem as JF
import cfdsim_tpu_torch.models.fem as TF
from cfdsim_tpu.fem import assembly as j_assembly
from cfdsim_tpu.fem import mesh as j_mesh
from cfdsim_tpu.fem import spaces as j_spaces
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import fem_state_from_numpy, fem_state_to_numpy
from cfdsim_tpu_torch.fem import assembly as t_assembly
from cfdsim_tpu_torch.fem import mesh as t_mesh
from cfdsim_tpu_torch.fem import spaces as t_spaces
from cfdsim_tpu_torch.io_ import restore
from cfdsim_tpu_torch.io_.native import csnap_steps
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.runner import run_on_device
from cfdsim_tpu_torch.utils.tree import leaves

U_RTOL, P_RTOL, FORCE_RTOL, METRIC_RTOL, RES_RTOL = 5e-5, 1e-3, 2e-3, 1e-4, 2e-2
GRAD_RTOL = 1e-4  # measured 8.6e-6: the adjoint GMRES converges to 1e-6
MESH = dict(h_far=0.5, h_near=0.12)
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """An FEM solve is thousands of small ops. Where the test workers share
    the cores, each op's OpenMP team waits on descheduled threads (measured
    ~8 ms an op at full load against ~10 µs alone), so this module's torch
    runs on one thread; the setting is put back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cylinders():
    """space → (the port's ``cylinder_fem``, with its perturbed Stokes initial
    state; the JAX package's mesh of it), built at first use."""
    built = {}

    def get(space):
        if space not in built:
            case = build("cylinder_fem", **MESH, dt=0.02, space=space, viz_shape=(8, 8),
                         device="cpu")
            mesh = j_mesh.cylinder_mesh(**MESH, x_span=(-1.0, 8.0), y_span=(-2.0, 2.0),
                                        center=(3.0, 0.0), radius=0.5)
            built[space] = (case, mesh)
        return built[space]

    return get


def _counting(monkeypatch, names):
    """Count, on both sides, the calls of the assembly functions ``names``
    that the FEM models make (the JAX ones at run time, through the device)."""
    calls = {"jax": 0, "port": 0}
    for name in names:
        for module, side in ((JF, "jax"), (TF, "port")):
            original = getattr(module, name)

            def wrapped(ops, *args, _f=original, _side=side, **kw):
                if _side == "jax":
                    jax.debug.callback(lambda _: calls.__setitem__("jax", calls["jax"] + 1),
                                       args[0])
                else:
                    calls["port"] += 1
                return _f(ops, *args, **kw)

            monkeypatch.setattr(module, name, wrapped)
    return calls


# name → (scheme, space, config overrides, precision)
STEP_CONFIGS = {
    "monolithic_bp": ("monolithic", "p1p1", {}, "fp32"),
    "monolithic_pspg": ("monolithic", "p1p1", dict(stab="pspg"), "fp32"),
    "monolithic_theta": ("monolithic", "p1p1", dict(theta=0.5), "fp32"),
    "monolithic_p2p1_fp64": ("monolithic", "p2p1", dict(theta=0.5, dt=0.005, gmres_maxiter=1),
                             "fp64"),
    "projection_p1p1": ("projection", "p1p1", {}, "fp32"),
    "projection_p2p1_supg": ("projection", "p2p1", dict(supg=1.0, theta=0.5), "fp32"),
    "projection_rotational": ("projection", "p1p1", dict(rotational=1.0), "fp32"),
}
# float64 on both sides (the JAX package under ``jax.enable_x64``) for the
# Taylor-Hood monolithic step: its solve on this mesh stops at gmres_maxiter
# short of 1e-5 in every step, where a float32 iterate carries amplified
# rounding (0.3 of max|u| apart after five steps at maxiter 8, the JAX
# package's own jit and eager solves 2e-4 apart on one Stokes system); in
# float64 the same algorithm gives the same iterate (measured 2.1e-8 of
# max|u| after five steps at maxiter 8)
FP64_RTOL = 1e-6
# the solver calls of five steps agree to one iteration a step: a CG exit
# test can land within rounding of its threshold, whose right-hand side
# (−div u*/dt) is a cancellation (the Taylor-Hood projection's fifth step
# stops at r·r = 0.94 of tol²·b·b in the port and one iteration later in
# JAX, in float64 as in float32); equal in the other configurations
CALLS_APART = STEPS


@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_steps_match_jax(cylinders, config, monkeypatch):
    scheme, space, overrides, precision = STEP_CONFIGS[config]
    case, mesh = cylinders(space)
    cfg = dataclasses.replace(case.cfg, **overrides)
    spaces, g = case.extras["spaces"], case.extras["g"]
    fp64 = precision == "fp64"
    ops = (t_assembly.build_element_ops(spaces, torch.float64, device="cpu") if fp64
           else case.extras["ops"])
    cyl = spaces.dirichlet_tag_nodes["cylinder"]
    counted = (["apply_ns"] if scheme == "monolithic" else
               ["apply_momentum_conv", "apply_stiffness_p" if space == "p1p1" else "apply_div_u"])
    calls = _counting(monkeypatch, counted)
    phi = None if scheme == "monolithic" else np.zeros(ops.n_p)
    dtype = np.float64 if fp64 else np.float32
    u0 = case.state.u.double().numpy().astype(dtype)
    p0 = case.state.p.double().numpy().astype(dtype)
    if scheme == "monolithic":
        step_t = TF.make_step(ops, cfg, g, force_nodes=cyl)
    else:
        step_t = TF.make_projection_step(ops, cfg, g, mesh.tags["outlet"], force_nodes=cyl)
    st = fem_state_from_numpy(u0, p0, 0.0, 0, "cpu", phi=phi, dtype=ops.dtype)
    for _ in range(STEPS):
        st, mt = step_t(st, 1.0)
    with jax.enable_x64(fp64):
        ops_j = j_assembly.build_element_ops(j_spaces.build_spaces(mesh, space),
                                             dtype=jnp.float64 if fp64 else jnp.float32)
        cfg_j = JF.FEMConfig(**dataclasses.asdict(cfg))
        step_j = jax.jit(JF.make_step(ops_j, cfg_j, g, force_nodes=cyl) if scheme == "monolithic"
                         else JF.make_projection_step(ops_j, cfg_j, g, mesh.tags["outlet"],
                                                      force_nodes=cyl))
        sj = JF.FEMState(u=jnp.asarray(u0), p=jnp.asarray(p0), t=jnp.float32(0.0),
                         step=jnp.int32(0), phi=None if phi is None else jnp.asarray(phi, dtype))
        for _ in range(STEPS):
            sj, mj = step_j(sj, 1.0)
        jax.effects_barrier()
        uj, pj = np.asarray(sj.u), np.asarray(sj.p)
        mj = {k: float(v) for k, v in mj._asdict().items()}
        t_j = float(sj.t)
    assert calls["jax"] > 0 and abs(calls["port"] - calls["jax"]) <= CALLS_APART, calls
    assert st.u.numpy().dtype == uj.dtype == dtype

    u_rtol, p_rtol = (FP64_RTOL, FP64_RTOL) if fp64 else (U_RTOL, P_RTOL)
    np.testing.assert_allclose(st.u.numpy(), uj, rtol=0, atol=u_rtol * np.abs(uj).max())
    pj = pj - pj.mean()
    pt = st.p.numpy() - st.p.numpy().mean()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=p_rtol * np.abs(pj).max())
    if phi is not None:
        assert st.phi is not None and st.phi.shape == (ops.n_p,)
    assert int(st.step) == STEPS and float(st.t) == pytest.approx(t_j, rel=1e-6)
    fmax = max(abs(mj["fx"]), abs(mj["fy"]))
    for name in ("fx", "fy"):
        assert abs(float(getattr(mt, name)) - mj[name]) <= FORCE_RTOL * fmax
    for name in ("dt", "div_pre", "div_post", "max_vel", "energy", "vort_max"):
        assert abs(float(getattr(mt, name)) - mj[name]) <= METRIC_RTOL * abs(mj[name]), name
    assert abs(float(mt.poisson_res) / mj["poisson_res"] - 1) <= RES_RTOL
    assert float(mt.fz) == 0.0 and all(x.dtype == torch.float32 for x in mt)


@pytest.mark.parametrize("scheme", ["monolithic", "projection"])
def test_failed_solve_keeps_previous(cylinders, scheme):
    """A solve that cannot reach ``accept_relres`` keeps the previous state
    (tests/test_fem.py:323), by a device ``where``: u and p bit-equal."""
    case, mesh = cylinders("p1p1")
    cfg = dataclasses.replace(case.cfg, gmres_maxiter=0, accept_relres=1e-12)
    ops, g = case.extras["ops"], case.extras["g"]
    step = (TF.make_step(ops, cfg, g) if scheme == "monolithic"
            else TF.make_projection_step(ops, cfg, g, mesh.tags["outlet"]))
    state = case.state._replace(phi=None if scheme == "monolithic" else
                                torch.zeros_like(case.state.p))
    new, m = step(state, 1.0)
    assert torch.equal(new.u, state.u) and torch.equal(new.p, state.p)
    assert float(m.poisson_res) > 1e-12 and int(new.step) == 1


def _poiseuille(mesh_mod, spaces_mod, n=6):
    mesh = mesh_mod.rectangle_mesh(2 * n, n, (0.0, 4.0), (0.0, 1.0))
    sp = spaces_mod.build_spaces(mesh, "p1p1")
    g = spaces_mod.dirichlet_values(sp, {"inlet": lambda x, y: (4.0 * y * (1.0 - y), 0 * y),
                                         "walls": lambda x, y: (0 * x, 0 * y)})
    return sp, g


def test_gradient_matches_jax_grad():
    """tests/test_fem.py:280's loss, the mean of u² after one monolithic
    step of the Poiseuille channel, differentiated with respect to the
    initial velocity: the port's implicit adjoint (an autograd.Function:
    GMRES on Aᵀ, the residual's VJP at fixed x) against ``jax.grad`` of the
    JAX ``custom_vjp``, within 1e-4 of max|grad|."""
    kw = dict(nu=0.1, dt=0.1, space="p1p1", gmres_tol=1e-6, gmres_restart=120, gmres_maxiter=10)
    sp_j, g = _poiseuille(j_mesh, j_spaces)
    ops_j = j_assembly.build_element_ops(sp_j)
    st_j = JF.solve_stokes(ops_j, JF.FEMConfig(**kw), g)
    step_j = JF.make_step(ops_j, JF.FEMConfig(**kw), g)

    def loss(u0):
        s2, _ = step_j(st_j._replace(u=u0), 1.0)
        return jnp.mean(s2.u ** 2)

    grad_j = np.asarray(jax.jit(jax.grad(loss))(st_j.u))

    sp_t, _ = _poiseuille(t_mesh, t_spaces)
    ops_t = t_assembly.build_element_ops(sp_t, device="cpu")
    step_t = TF.make_step(ops_t, TF.FEMConfig(**kw), g)
    u0 = torch.tensor(np.asarray(st_j.u)).requires_grad_()
    s2, _ = step_t(fem_state_from_numpy(np.asarray(st_j.u), np.asarray(st_j.p), 0.0, 0, "cpu")
                   ._replace(u=u0), 1.0)
    torch.mean(s2.u ** 2).backward()
    grad_t = u0.grad.numpy()
    assert np.abs(grad_j).max() > 0
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=GRAD_RTOL * np.abs(grad_j).max())


def test_stokes_with_body_force_matches_jax():
    """``solve_stokes`` with a body force and PSPG's continuity rhs, then
    one PSPG step carrying the force: the manufactured u = (y², 0) of
    tests/test_fem.py:132 on P1-P1, within the step bands above."""
    nu = 0.3
    kw = dict(nu=nu, space="p1p1", stab="pspg", gmres_tol=1e-6, gmres_restart=60,
              gmres_maxiter=4, dt=0.1)

    def force(x, y):
        return (-2.0 * nu + 0 * x, 0 * y)

    out = []
    for mesh_mod, spaces_mod, asm, F, dev in ((j_mesh, j_spaces, j_assembly, JF, {}),
                                             (t_mesh, t_spaces, t_assembly, TF,
                                              {"device": "cpu"})):
        sp = spaces_mod.build_spaces(mesh_mod.rectangle_mesh(8, 6, (0.0, 2.0), (0.0, 1.0)),
                                     "p1p1")
        g = spaces_mod.dirichlet_values(sp, {"inlet": lambda x, y: (y * y, 0 * y),
                                             "walls": lambda x, y: (y * y, 0 * y)})
        ops = asm.build_element_ops(sp, **dev)
        st = F.solve_stokes(ops, F.FEMConfig(**kw), g, body_force=force)
        st2, m = F.make_step(ops, F.FEMConfig(**kw), g, body_force=force)(st, 1.0)
        out.append([np.asarray(x) for x in (st.u, st.p, st2.u, st2.p, m.energy)])
    for got, want in zip(out[1], out[0]):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=U_RTOL * scale)


def test_fem_chunk_and_run_on_device():
    """The FEM steps read the host (the Krylov exits), so a chunk of them is
    the loop; ``run_on_device`` runs a monolithic state (φ None) to t = 0.2
    in 4 steps of 0.05 (tests/test_fem.py:262)."""
    case = build("cylinder_fem", **MESH, viz_shape=(8, 8), device="cpu")
    assert case.step.reads_host and case.state.phi is None
    chunk = make_chunk(case.cfg, case.step, 3)
    assert chunk.mode == "loop"
    state, m = chunk(case.state, 1.0)
    assert int(state.step) == 3 and m.fx.shape == (3,) and state.phi is None
    st, last = run_on_device(case.step, case.state, t_final=0.2, chunk_steps=3)
    assert float(st.t) >= 0.2 and int(st.step) == 4 and st.phi is None
    assert bool(torch.isfinite(st.u).all()) and 0.1 < 2.0 * float(last.fx) < 30.0
    assert case.step.counts["matvecs"] > 0 and case.step.counts["host_reads"] > 0


@pytest.mark.parametrize("with_phi", [False, True])
def test_convert_round_trip(with_phi):
    rng = np.random.default_rng(5)
    u, p = rng.standard_normal((40, 2)), rng.standard_normal(25)
    phi = rng.standard_normal(25) if with_phi else None
    state = fem_state_from_numpy(u, p, 1.25, 7, "cpu", phi=phi)
    assert state.u.dtype == torch.float32 and (state.phi is None) != with_phi
    back = fem_state_to_numpy(state)
    assert set(back) == {"u", "p", "t", "step"} | ({"phi"} if with_phi else set())
    np.testing.assert_array_equal(back["u"], u.astype(np.float32))
    if with_phi:
        np.testing.assert_array_equal(back["phi"], phi.astype(np.float32))
    assert back["t"] == np.float32(1.25) and back["step"] == 7
    again = fem_state_from_numpy(**{k: back[k] for k in ("u", "p", "t", "step")},
                                 phi=back.get("phi"), device="cpu", dtype=torch.float64)
    assert again.u.dtype == torch.float64 and int(again.step) == 7
    with pytest.raises(ValueError, match="not an FEM state"):
        fem_state_from_numpy(p, u, 0.0, 0, "cpu")


def test_cli_fem_snapshots_and_resume(tmp_path, capsys):
    """``run schafer_turek_fem --scheme projection`` with native snapshots:
    each holds the sampled u, v, p, vorticity (the grid the renderer reads)
    and the nodal fem_u, fem_p, fem_phi; a run of 4 steps and a ``--resume``
    to 8 equal one run of 8 bit for bit, snapshots and restored states."""
    common = ["run", "schafer_turek_fem", "--h-near", "0.02", "--h-far", "0.08",
              "--viz-shape", "(10,40)", "--scheme", "projection", "--theta", "0.5",
              "--device", "cpu", "--io", "native", "--chunk-steps", "2",
              "--snapshot-interval", "2", "--t-final", "1e9"]
    split, straight = tmp_path / "split", tmp_path / "straight"
    cli.main([*common, "--max-steps", "4", "--out", str(split)])
    report = cli.main([*common, "--max-steps", "8", "--out", str(split), "--resume"])
    cli.main([*common, "--max-steps", "8", "--out", str(straight)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_step"] == 8
    assert report["final_step"] == 8 and report["total_steps"] == 4
    assert report["chunk_route"] == "loop"
    a = csnap_steps(split / "snapshots.csnap")
    b = csnap_steps(straight / "snapshots.csnap")
    assert sorted(a) == sorted(b) == [0, 2, 4, 6, 8]
    fields, _ = b[8]
    assert set(fields) == {"u", "v", "p", "vorticity", "fem_u", "fem_p", "fem_phi"}
    assert fields["u"].shape == (10, 40) and np.isnan(fields["u"]).any()
    for step in b:
        for name in fields:
            np.testing.assert_array_equal(a[step][0][name], b[step][0][name], err_msg=name)
        assert a[step][1] == b[step][1]
    template = build("schafer_turek_fem", **cli._extra_kwargs(common[2:14]))
    sa = restore(template.state, split / "snapshots.csnap")
    sb = restore(template.state, straight / "snapshots.csnap")
    assert int(sa.step) == 8 and sa.phi is not None
    assert all(torch.equal(x, y) for x, y in zip(leaves(sa), leaves(sb)))
    np.testing.assert_array_equal(sa.u.numpy(), fields["fem_u"])
