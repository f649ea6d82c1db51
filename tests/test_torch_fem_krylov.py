"""``solvers/krylov.py`` against ``jax.scipy.sparse.linalg.gmres``
(``solve_method="incremental"``; "batched" in test_torch_krylov_batched.py)
and ``cg`` on the same systems: a dense
nonsymmetric (u (n, 2), p (m,)) pair with a diagonal preconditioner, an SPD
matrix, and the FEM tier's own operators (a monolithic step's coupled
system with its block preconditioner, the projection's pressure Poisson
with the two-level preconditioner).

Each JAX operator logs its calls through ``jax.debug.callback``; the port
must apply its operator the same number of times (the same restarts, Arnoldi
steps and CG iterations) and reach the same solution within 1e-6 of
max|x| in float32 (the two sum their dot products and matvecs in other
orders), or within 1e-9 in float64 for a solve that stops at ``maxiter``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from collections import Counter

import cfdsim_tpu.fem.assembly as JA
import cfdsim_tpu.fem.multilevel as JM
import cfdsim_tpu.models.fem as JF
import cfdsim_tpu_torch.fem.assembly as TA
import cfdsim_tpu_torch.fem.multilevel as TM
import cfdsim_tpu_torch.models.fem as TF
from cfdsim_tpu.fem.mesh import cylinder_mesh as j_cylinder_mesh
from cfdsim_tpu.fem.spaces import build_spaces as j_build_spaces
from cfdsim_tpu_torch.fem.mesh import cylinder_mesh
from cfdsim_tpu_torch.fem.spaces import build_spaces, dirichlet_values
from cfdsim_tpu_torch.solvers.krylov import cg, gmres

RTOL = 1e-6
N_U, N_P = 60, 30


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


def _counted(A):
    """(A with each call logged by the device, the log)."""
    log = []

    def f(x):
        jax.debug.callback(lambda v: log.append(1), jax.tree.leaves(x)[0])
        return A(x)

    return f, log


def _jax_solve(solver, A, b, **kw):
    A, log = _counted(A)
    x, _ = solver(A, b, **kw)
    jax.block_until_ready(x)
    jax.effects_barrier()
    return x, len(log)


def _flat(x):
    return np.concatenate([np.asarray(v).ravel() for v in (x if isinstance(x, tuple) else (x,))])


def _assert_same(xt, xj, counts, calls, label):
    a, b = _flat(tuple(v.numpy() for v in xt) if isinstance(xt, tuple) else xt.numpy()), _flat(xj)
    np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * np.abs(b).max(), err_msg=label)
    assert counts["matvecs"] == calls, (label, dict(counts), calls)


@pytest.fixture(scope="module")
def dense_pair():
    rng = np.random.default_rng(0)
    n = 2 * N_U + N_P
    A = (np.eye(n) * np.linspace(1, 30, n)
         + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
    d = (1.0 / np.diag(A)).astype(np.float32)
    b = (rng.standard_normal((N_U, 2)).astype(np.float32),
         rng.standard_normal(N_P).astype(np.float32))
    return A, d, b


def _pair_ops(A, d, xp, cat):
    def split(v):
        return v[:2 * N_U].reshape(N_U, 2), v[2 * N_U:]

    def op(x):
        return split(xp(A) @ cat([x[0].reshape(-1), x[1]]))

    def pc(x):
        return split(cat([x[0].reshape(-1), x[1]]) * xp(d))

    return op, pc


@pytest.mark.parametrize("restart,maxiter,tol", [(10, 20, 1e-5), (40, 8, 1e-6), (4, 3, 1e-5),
                                                 (3, 50, 3e-6)])
def test_gmres_pair_matches_jax(dense_pair, restart, maxiter, tol):
    A, d, b = dense_pair
    op_j, pc_j = _pair_ops(A, d, jnp.asarray, jnp.concatenate)
    op_t, pc_t = _pair_ops(A, d, torch.from_numpy, torch.cat)
    xj, calls = _jax_solve(jax.scipy.sparse.linalg.gmres, op_j, tuple(map(jnp.asarray, b)),
                           tol=tol, atol=0.0, restart=restart, maxiter=maxiter, M=pc_j,
                           solve_method="incremental")
    counts = Counter()
    xt = gmres(op_t, tuple(map(torch.from_numpy, b)), tol=tol, atol=0.0, restart=restart,
               maxiter=maxiter, M=pc_t, counts=counts)
    _assert_same(xt, xj, counts, calls, (restart, maxiter, tol))
    # one host read per setup, Arnoldi step and restart
    assert counts["host_reads"] == 1 + counts["arnoldi"] + counts["restarts"]


def test_gmres_refuses_batched(dense_pair):
    """A ``solve_method`` other than jax.scipy's two is refused, as JAX
    refuses it ("batched" itself is held to JAX in
    test_torch_krylov_batched.py)."""
    A, d, b = dense_pair
    op_t, _ = _pair_ops(A, d, torch.from_numpy, torch.cat)
    with pytest.raises(ValueError, match="'incremental' or 'batched'"):
        gmres(op_t, tuple(map(torch.from_numpy, b)), solve_method="batch")


@pytest.mark.parametrize("maxiter", [400, 7])
def test_cg_matches_jax(maxiter):
    rng = np.random.default_rng(1)
    n = 150
    S = rng.standard_normal((n, n)) / np.sqrt(n)
    A = (S @ S.T + np.diag(np.linspace(0.1, 5, n))).astype(np.float32)
    d = (1.0 / np.diag(A)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x0 = rng.standard_normal(n).astype(np.float32) * 0.1
    xj, calls = _jax_solve(jax.scipy.sparse.linalg.cg, lambda x: jnp.asarray(A) @ x,
                           jnp.asarray(b), x0=jnp.asarray(x0), tol=1e-6, atol=0.0,
                           maxiter=maxiter, M=lambda r: jnp.asarray(d) * r)
    counts = Counter()
    xt = cg(lambda x: torch.from_numpy(A) @ x, torch.from_numpy(b), x0=torch.from_numpy(x0),
            tol=1e-6, maxiter=maxiter, M=lambda r: torch.from_numpy(d) * r, counts=counts)
    _assert_same(xt, xj, counts, calls, maxiter)
    assert counts["cg_iterations"] == calls - 1 and counts["host_reads"] == calls


@pytest.fixture(scope="module")
def fem_mesh():
    kw = dict(h_far=0.5, h_near=0.12)
    spaces = build_spaces(cylinder_mesh(**kw), "p1p1")
    g = dirichlet_values(spaces, {"inlet": lambda x, y: (1.0 + 0 * x, 0 * y),
                                  "walls": lambda x, y: (0 * x, 0 * y),
                                  "cylinder": lambda x, y: (0 * x, 0 * y)})
    return j_build_spaces(j_cylinder_mesh(**kw), "p1p1"), spaces, g


def test_gmres_on_the_monolithic_system_is_jax_algorithm(fem_mesh):
    """One monolithic θ-step's coupled system from the impulsive lift
    (``_make_implicit_solver``'s operator and rhs, dt = 0.02): the masked NS
    operator with linearized convection and τ, the block preconditioner with
    its two-level Schur correction, restart 40, maxiter 3, all used (it does
    not reach 1e-5 from this start). Run in float64 on both sides, where
    rounding does not hide a difference of algorithm: the same matvecs (124)
    and the same iterate within 1e-9 of max|x|. (In float32 an unconverged
    iterate carries amplified rounding: 2.9e-4 of max|x| apart after one
    restart here, and the JAX package's own jitted and eager solves of the
    steady Stokes system differ by 2e-4.)"""
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
            solve_method="incremental")
        xj = tuple(np.asarray(v) for v in xj)
    to = TA.build_element_ops(ts, torch.float64, device="cpu")
    solver = TF._ImplicitSolver(to, TF.FEMConfig(**kw), torch.from_numpy(g), None, None,
                                Counter())
    ug, it, zt = torch.from_numpy(g), torch.tensor(inv_dt), torch.from_numpy(zeros)
    bt, _ = solver.rhs(ug, zt, it)
    counts = Counter()
    xt = gmres(lambda x: solver.opA(ug, it, x), bt, x0=(ug, zt), tol=1e-5, atol=0.0,
               restart=40, maxiter=3, M=solver.precond(it), counts=counts)
    a, b = _flat(tuple(v.numpy() for v in xt)), _flat(xj)
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
    assert counts["matvecs"] == calls and counts["restarts"] == 3


def test_cg_on_the_pressure_poisson_matches_jax(fem_mesh):
    """The projection's pressure increment: K_p with the outflow rows
    replaced, the additive two-level preconditioner, tol 1e-6 (float32)."""
    js, ts, _ = fem_mesh
    jo, to = JA.build_element_ops(js), TA.build_element_ops(ts, device="cpu")
    out = ts.mesh.tags["outlet"]
    pm = np.zeros(to.n_p, bool)
    pm[out] = True
    rng = np.random.default_rng(3)
    b = np.where(pm, 0.0, rng.standard_normal(to.n_p)).astype(np.float32)

    def op(A, ops, mask, where):
        return lambda q: where(mask, q, A.apply_stiffness_p(ops, where(mask, 0.0, q)))

    inv_d = (1.0 / np.where(pm, 1.0, np.asarray(JA.stiffness_p_diag(jo)))).astype(np.float32)
    pc_j = JM.make_pressure_pc(JM.build_pressure_coarse(jo, out), jnp.asarray(inv_d))
    pc_t = TM.make_pressure_pc(TM.build_pressure_coarse(to, out), torch.from_numpy(inv_d))
    xj, calls = _jax_solve(jax.scipy.sparse.linalg.cg, op(JA, jo, jnp.asarray(pm), jnp.where),
                           jnp.asarray(b), tol=1e-6, atol=0.0, maxiter=400, M=pc_j)
    counts = Counter()
    xt = cg(op(TA, to, torch.from_numpy(pm), torch.where), torch.from_numpy(b), tol=1e-6,
            maxiter=400, M=pc_t, counts=counts)
    _assert_same(xt, xj, counts, calls, "pressure poisson")
