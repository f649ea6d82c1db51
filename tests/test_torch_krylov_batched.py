"""GMRES ``solve_method="batched"`` of ``solvers/krylov.py`` against
jax.scipy's ``_gmres_batched``, and the FEM steps with
``FEMConfig(gmres_method="batched")`` against the JAX package's.

- A seeded dense nonsymmetric (u (n, 2), p (m,)) pair with a diagonal
  preconditioner, float32: the same operator calls (the same restarts, each
  ``restart`` Arnoldi steps and a residual) and x within 1e-5 of max|x|.
- The FEM tier's monolithic coupled system with its block preconditioner,
  restart 40, maxiter 3, in float64 on both sides: the same calls and the
  same iterate within 1e-9 of max|x| (the least-squares solve sums in
  another order; the algorithm is the same).
- One host read per setup and per restart.
- The monolithic and projection steps, two steps from the same Stokes
  state, at test_torch_fem.py's mesh and tolerances.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdsim_tpu.fem.assembly as JA
import cfdsim_tpu.models.fem as JF
from cfdsim_tpu.fem import spaces as j_spaces
import cfdsim_tpu_torch.fem.assembly as TA
import cfdsim_tpu_torch.models.fem as TF
from cfdsim_tpu_torch.solvers.krylov import gmres
from test_torch_fem import STEP_CONFIGS, U_RTOL, P_RTOL, _counting, cylinders  # noqa: F401
from test_torch_fem_krylov import (  # noqa: F401
    _assert_same,
    _flat,
    _jax_solve,
    _pair_ops,
    dense_pair,
    fem_mesh,
    one_torch_thread,
)

RTOL = 1e-5
FP64_RTOL = 1e-9


@pytest.mark.parametrize("restart,maxiter,tol", [(10, 20, 1e-5), (40, 8, 1e-6), (4, 3, 1e-5),
                                                 (3, 50, 3e-6)])
def test_gmres_batched_pair_matches_jax(dense_pair, restart, maxiter, tol):
    A, d, b = dense_pair
    op_j, pc_j = _pair_ops(A, d, jnp.asarray, jnp.concatenate)
    op_t, pc_t = _pair_ops(A, d, torch.from_numpy, torch.cat)
    xj, calls = _jax_solve(jax.scipy.sparse.linalg.gmres, op_j, tuple(map(jnp.asarray, b)),
                           tol=tol, atol=0.0, restart=restart, maxiter=maxiter, M=pc_j,
                           solve_method="batched")
    counts = Counter()
    xt = gmres(op_t, tuple(map(torch.from_numpy, b)), tol=tol, atol=0.0, restart=restart,
               maxiter=maxiter, M=pc_t, counts=counts, solve_method="batched")
    a, bj = _flat(tuple(v.numpy() for v in xt)), _flat(xj)
    np.testing.assert_allclose(a, bj, rtol=0, atol=RTOL * np.abs(bj).max())
    assert counts["matvecs"] == calls, (dict(counts), calls)
    assert counts["matvecs"] == 1 + counts["restarts"] * (restart + 1)
    # one host read per setup and per restart, none per Arnoldi step
    assert counts["host_reads"] == 1 + counts["restarts"]


def test_gmres_batched_on_the_monolithic_system_is_jax_algorithm(fem_mesh):
    """test_torch_fem_krylov.py's monolithic θ-step system (float64,
    restart 40, maxiter 3) through the batched method."""
    js, ts, g = fem_mesh
    kw = dict(nu=0.01, dt=0.02, space="p1p1", theta=0.5)
    inv_dt = np.float64(50.0)
    zeros = np.zeros(ts.n_p)
    with jax.enable_x64():
        jo = JA.build_element_ops(js, dtype=jnp.float64)
        cj = JF.FEMConfig(**kw)
        _, rhs_j, op_j, _ = JF._make_implicit_solver(jo, cj, jnp.asarray(g), None)
        bj, _ = rhs_j(jnp.asarray(g), jnp.asarray(zeros), inv_dt)
        xj, calls = _jax_solve(
            jax.scipy.sparse.linalg.gmres, lambda x: op_j(jnp.asarray(g), inv_dt, x), bj,
            x0=(jnp.asarray(g), jnp.asarray(zeros)), tol=1e-5, atol=0.0, restart=40, maxiter=3,
            M=JF._preconditioner(jo, cj, inv_dt, JF._tau(jo, cj), JF.build_schur_coarse(jo, cj)),
            solve_method="batched")
        xj = tuple(np.asarray(v) for v in xj)
    to = TA.build_element_ops(ts, torch.float64, device="cpu")
    solver = TF._ImplicitSolver(to, TF.FEMConfig(**kw), torch.from_numpy(g), None, None,
                                Counter())
    ug, it, zt = torch.from_numpy(g), torch.tensor(inv_dt), torch.from_numpy(zeros)
    bt, _ = solver.rhs(ug, zt, it)
    counts = Counter()
    xt = gmres(lambda x: solver.opA(ug, it, x), bt, x0=(ug, zt), tol=1e-5, atol=0.0,
               restart=40, maxiter=3, M=solver.precond(it), counts=counts,
               solve_method="batched")
    a, b = _flat(tuple(v.numpy() for v in xt)), _flat(xj)
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_allclose(a, b, rtol=0, atol=FP64_RTOL * np.abs(b).max())
    assert counts["matvecs"] == calls == 1 + 3 * 41 and counts["restarts"] == 3


@pytest.mark.parametrize("config", ["monolithic_bp", "projection_p1p1"])
def test_fem_steps_batched_match_jax(cylinders, config, monkeypatch):
    scheme, space, overrides, _ = STEP_CONFIGS[config]
    case, mesh = cylinders(space)
    cfg = dataclasses.replace(case.cfg, gmres_method="batched", **overrides)
    spaces, g, ops = case.extras["spaces"], case.extras["g"], case.extras["ops"]
    cyl = spaces.dirichlet_tag_nodes["cylinder"]
    counted = ["apply_ns"] if scheme == "monolithic" else ["apply_momentum_conv"]
    calls = _counting(monkeypatch, counted)
    phi = None if scheme == "monolithic" else np.zeros(ops.n_p, np.float32)
    u0, p0 = case.state.u.numpy(), case.state.p.numpy()
    if scheme == "monolithic":
        step_t = TF.make_step(ops, cfg, g, force_nodes=cyl)
    else:
        step_t = TF.make_projection_step(ops, cfg, g, mesh.tags["outlet"], force_nodes=cyl)
    st = TF.FEMState(u=torch.from_numpy(u0.copy()), p=torch.from_numpy(p0.copy()),
                     t=torch.zeros(()), step=torch.zeros((), dtype=torch.int32),
                     phi=None if phi is None else torch.from_numpy(phi))
    for _ in range(2):
        st, mt = step_t(st, 1.0)
    ops_j = JA.build_element_ops(j_spaces.build_spaces(mesh, space))
    cfg_j = JF.FEMConfig(**dataclasses.asdict(cfg))
    step_j = jax.jit(JF.make_step(ops_j, cfg_j, g, force_nodes=cyl) if scheme == "monolithic"
                     else JF.make_projection_step(ops_j, cfg_j, g, mesh.tags["outlet"],
                                                  force_nodes=cyl))
    sj = JF.FEMState(u=jnp.asarray(u0), p=jnp.asarray(p0), t=jnp.float32(0.0),
                     step=jnp.int32(0), phi=None if phi is None else jnp.asarray(phi))
    for _ in range(2):
        sj, mj = step_j(sj, 1.0)
    jax.effects_barrier()
    uj, pj = np.asarray(sj.u), np.asarray(sj.p)
    assert calls["jax"] > 0 and calls["port"] == calls["jax"], calls
    np.testing.assert_allclose(st.u.numpy(), uj, rtol=0, atol=U_RTOL * np.abs(uj).max())
    pj = pj - pj.mean()
    pt = st.p.numpy() - st.p.numpy().mean()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=P_RTOL * np.abs(pj).max())
    assert float(mt.energy) == pytest.approx(float(mj.energy), rel=1e-4)
