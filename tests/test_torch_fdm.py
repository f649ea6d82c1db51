"""The port's fast diagonalization (``solvers/fdm.py``), the twin of
tests/test_stretched.py:14-58, and against the JAX package's
``make_fdm_solver``.

Tolerances: the stretched operator's residual < 1e-4·max|rhs| and the
uniform FDM within 1e-5·max|φ| of the DCT (test_stretched.py's bands);
analytic against numeric eigenbases within 1e-5·max|φ|; the port against
JAX ``make_fdm_solver`` within 1e-5 relative (both sides four float32
matmuls from the same float64 tables; observed ≤ 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.solvers import fdm as jfdm
from cfdsim_tpu_torch.models import mac_stretched as ms
from cfdsim_tpu_torch.solvers import fdm
from cfdsim_tpu_torch.solvers.poisson import solve_poisson_neumann_dct


def _solve(solver, rhs):
    return solver(torch.from_numpy(np.asarray(rhs, np.float32))).numpy()


def test_fdm_solves_stretched_operator_exactly():
    rng = np.random.RandomState(0)
    hx = 0.5 + rng.rand(24)
    hy = 0.5 + rng.rand(16)
    solver = fdm.make_fdm_solver(hx, hy, device="cpu")
    rhs = rng.randn(16, 24).astype(np.float32)
    w = np.outer(hy, hx)
    rhs = rhs - (w * rhs).sum() / w.sum()  # remove the nullspace component
    phi = _solve(solver, rhs)
    Lx, Ly = fdm.neumann_operator_1d(hx), fdm.neumann_operator_1d(hy)
    res = Ly @ phi + phi @ Lx.T - rhs
    assert np.abs(res).max() < 1e-4 * np.abs(rhs).max()


def test_fdm_uniform_matches_dct():
    rng = np.random.RandomState(1)
    n = 32
    h = 1.0 / n
    solver = fdm.make_fdm_solver(np.full(n, h), np.full(n, h), device="cpu")
    rhs = rng.randn(n, n).astype(np.float32)
    rhs -= rhs.mean()
    a = _solve(solver, rhs)
    b = solve_poisson_neumann_dct(torch.from_numpy(rhs), h, h).numpy()
    assert np.abs(a - b).max() < 1e-5 * max(np.abs(b).max(), 1e-6)


def test_fdm_analytic_uniform_eigs_match_numeric():
    rng = np.random.RandomState(2)
    n, m, dx, dy = 48, 32, 0.013, 0.021
    rhs = rng.randn(m, n).astype(np.float32)
    rhs -= rhs.mean()
    s_num = fdm.make_fdm_solver(np.full(n, dx), np.full(m, dy), device="cpu")
    s_ana = fdm.make_fdm_solver(
        np.full(n, dx), np.full(m, dy),
        eigs=(fdm.uniform_neumann_eigs(n, dx), fdm.uniform_neumann_eigs(m, dy)), device="cpu")
    a, b = _solve(s_num, rhs), _solve(s_ana, rhs)
    assert np.abs(a - b).max() < 1e-5 * max(np.abs(a).max(), 1e-6)


@pytest.mark.parametrize("faces", ["random", "wall_clustered", "stretched"])
def test_fdm_matches_jax(faces):
    rng = np.random.RandomState(3)
    if faces == "random":
        hx, hy = 0.5 + rng.rand(40), 0.5 + rng.rand(24)
    elif faces == "wall_clustered":
        hx = np.diff(ms.wall_clustered_faces(48, 1.0, beta=1.5))
        hy = np.diff(ms.wall_clustered_faces(32, 1.0, beta=2.0))
    else:
        hx = np.diff(ms.stretched_faces(64, 24.0, refine=[(6.0, 1.5, 3.0), (9.0, 6.0, 1.5)]))
        hy = np.diff(ms.stretched_faces(32, 8.0, refine=[(4.0, 1.5, 3.0)]))
    rhs = rng.randn(len(hy), len(hx)).astype(np.float32)
    want = np.asarray(jax.jit(jfdm.make_fdm_solver(hx, hy))(jnp.asarray(rhs)))
    got = _solve(fdm.make_fdm_solver(hx, hy, device="cpu"), rhs)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_helpers_equal_jax():
    """The float64 set-up is a copy: the operator, both eigenbases and the
    face functions give the JAX package's arrays."""
    h = 0.3 + np.random.RandomState(4).rand(12)
    assert np.array_equal(fdm.neumann_operator_1d(h), jfdm.neumann_operator_1d(h))
    L = jfdm.neumann_operator_1d(h)
    for a, b in zip(fdm._eig_similar_symmetric(L, h), jfdm._eig_similar_symmetric(L, h)):
        assert np.array_equal(a, b)
    for a, b in zip(fdm.uniform_neumann_eigs(10, 0.1), jfdm.uniform_neumann_eigs(10, 0.1)):
        assert np.array_equal(a, b)


def test_full_fp32_matmul_restores_the_callers_setting():
    """The products run with the CUDA matmul precision at "ieee" (no TF32)
    whatever the caller set, and the caller's setting comes back."""
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    try:
        for setting in ("tf32", "ieee"):
            matmul.fp32_precision = setting
            with fdm.full_fp32_matmul():
                assert matmul.fp32_precision == "ieee"
            assert matmul.fp32_precision == setting
        with pytest.raises(RuntimeError):
            with fdm.full_fp32_matmul():
                raise RuntimeError("inside")
        assert matmul.fp32_precision == "ieee"
    finally:
        matmul.fp32_precision = before


def test_solver_checks_its_shape():
    solver = fdm.make_fdm_solver(np.full(8, 0.1), np.full(6, 0.1), device="cpu")
    assert tuple(solver.inv_lam.shape) == (6, 8)
    with pytest.raises(ValueError, match="built for"):
        solver(torch.zeros(8, 6))
