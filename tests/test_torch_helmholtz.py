"""``cfdsim_tpu_torch/solvers/helmholtz.py`` against the JAX package's
``solvers/helmholtz.py`` on the same seeded numpy inputs, on the CPU.

Tolerances (float32 on both sides; the two FFT libraries sum in different
orders):
- one transform (``dst1``, ``idst1``, ``dst2``, ``idst2``) against JAX:
  5e-6 of the output's max (observed ≤ 1.8e-7); a round trip: atol 1e-5, the
  band of tests/test_helmholtz.py:18.
- ``solve_helmholtz_dirichlet`` against JAX: atol 2e-6 on O(1) fields
  (observed ≤ 2.7e-7); against the manufactured solution: atol 2e-5, the band
  of tests/test_helmholtz.py:35; the frame bit for bit.
- ``make_mac_helmholtz`` against JAX: 5e-6 of the output's max (observed
  ≤ 3.1e-7), and the
  residual of the 1-D operators it diagonalizes: 2e-5 of max |b|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.solvers import helmholtz as jh
from cfdsim_tpu_torch.solvers import helmholtz as th

TRANSFORM_RTOL = 5e-6
ROUNDTRIP_ATOL = 1e-5
SOLVE_ATOL = 2e-6
MANUFACTURED_ATOL = 2e-5
MAC_RESIDUAL_RTOL = 2e-5
TRANSFORMS = ["dst1", "idst1", "dst2", "idst2"]


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m", [33, 48])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(name, axis, m):
    shape = (m, 20) if axis == 0 else (20, m)
    x = _field(shape, seed=m + axis)
    want = np.asarray(getattr(jh, name)(jnp.asarray(x), axis))
    got = getattr(th, name)(torch.from_numpy(x), axis)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.abs(got.numpy() - want).max() <= TRANSFORM_RTOL * np.abs(want).max()


@pytest.mark.parametrize("m", [33, 48])
@pytest.mark.parametrize("pair", [("dst1", "idst1"), ("dst2", "idst2")], ids=["dst1", "dst2"])
def test_transform_round_trip(pair, m):
    fwd, inv = (getattr(th, n) for n in pair)
    for axis, shape in ((0, (m, 9)), (1, (13, m))):
        x = torch.from_numpy(_field(shape, seed=m))
        assert (inv(fwd(x, axis), axis) - x).abs().max() <= ROUNDTRIP_ATOL


def test_dst1_is_the_sine_sum():
    """S[k] = Σ_j x_j sin(πjk/(m+1)), in float64 numpy."""
    m = 11
    x = _field((m, 3), seed=5)
    j = np.arange(1, m + 1)
    basis = np.sin(np.pi * np.outer(j, j) / (m + 1))
    want = basis @ x.astype(np.float64)
    got = th.dst1(torch.from_numpy(x), 0).numpy()
    assert np.abs(got - want).max() <= 1e-5


def _manufactured(shape=(24, 18), dx=0.05, dy=0.08, c=3e-3):
    u = _field(shape, seed=1).astype(np.float64)
    lap = (u[1:-1, 2:] - 2 * u[1:-1, 1:-1] + u[1:-1, :-2]) / (dx * dx) + (
        u[2:, 1:-1] - 2 * u[1:-1, 1:-1] + u[:-2, 1:-1]) / (dy * dy)
    b = u.copy()
    b[1:-1, 1:-1] = u[1:-1, 1:-1] - c * lap
    return u.astype(np.float32), b.astype(np.float32), dx, dy, c


@pytest.mark.parametrize("coeff_on_device", [False, True], ids=["float", "tensor"])
def test_helmholtz_exact_solve(coeff_on_device):
    """The twin of tests/test_helmholtz.py::test_helmholtz_exact_solve, and
    the same solve against JAX; ``coeff`` as a number and as a 0-dim tensor
    (the step's dt·ν)."""
    u, b, dx, dy, c = _manufactured()
    coeff = torch.tensor(c, dtype=torch.float32) if coeff_on_device else c
    got = th.solve_helmholtz_dirichlet(torch.from_numpy(b), coeff, dx, dy).numpy()
    assert np.abs(got - u).max() <= MANUFACTURED_ATOL
    frame = np.ones(u.shape, bool)
    frame[1:-1, 1:-1] = False
    assert np.array_equal(got[frame], b[frame])
    want = np.asarray(jh.solve_helmholtz_dirichlet(jnp.asarray(b), jnp.float32(c), dx, dy))
    assert np.abs(got - want).max() <= SOLVE_ATOL


@pytest.mark.parametrize("shape", [(33, 48), (48, 33)], ids=str)
def test_helmholtz_residual_and_module(shape):
    """The module form gives the functional form's bits, leaves its input
    alone, and its solution satisfies (I − c∇²)u = b on the interior."""
    b = _field(shape, seed=9)
    dx, dy, c = 1.0 / (shape[1] - 1), 1.0 / (shape[0] - 1), 2e-4
    solver = th.DirichletHelmholtz(shape, dx, dy, device="cpu")
    assert solver.table.dtype == torch.float32 and solver.table.shape == (shape[0] - 2,
                                                                           shape[1] - 2)
    tb = torch.from_numpy(b.copy())
    got = solver(tb, c)
    assert np.array_equal(tb.numpy(), b)
    assert torch.equal(got, th.solve_helmholtz_dirichlet(tb, c, dx, dy))
    u = got.double().numpy()
    lap = (u[1:-1, 2:] - 2 * u[1:-1, 1:-1] + u[1:-1, :-2]) / (dx * dx) + (
        u[2:, 1:-1] - 2 * u[1:-1, 1:-1] + u[:-2, 1:-1]) / (dy * dy)
    res = u[1:-1, 1:-1] - c * lap - b[1:-1, 1:-1]
    assert np.abs(res).max() <= 1e-5 * np.abs(b).max()
    with pytest.raises(ValueError, match="built for"):
        solver(torch.zeros(8, 8), c)


def _apply_1d(kind, q, axis, h):
    """The 1-D second difference whose eigenbasis ``kind`` is, in float64."""
    q = np.moveaxis(q, axis, 0)
    if kind == "dst1":  # Dirichlet zero at both integer walls
        lo, hi = np.zeros_like(q[:1]), np.zeros_like(q[:1])
    elif kind == "dst2":  # odd mirror ghost
        lo, hi = -q[:1], -q[-1:]
    else:  # dct2: even mirror ghost
        lo, hi = q[:1], q[-1:]
    e = np.concatenate([lo, q, hi], 0)
    return np.moveaxis((e[2:] - 2 * e[1:-1] + e[:-2]) / (h * h), 0, axis)


@pytest.mark.parametrize("kinds", [("dst1", "dst2"), ("dst2", "dst1"), ("dct2", "dst1"),
                                   ("dst2", "dct2")], ids=lambda k: "-".join(k))
def test_mac_helmholtz_matches_jax_and_solves(kinds):
    """All three bases, on an odd and an even length each."""
    shape, dx, dy, c = (33, 48), 0.03, 0.04, 5e-4
    b = _field(shape, seed=4)
    want = np.asarray(jh.make_mac_helmholtz(shape, kinds, dx, dy)(jnp.asarray(b),
                                                                  jnp.float32(c)))
    solver = th.make_mac_helmholtz(shape, kinds, dx, dy, device="cpu")
    got = solver(torch.from_numpy(b), torch.tensor(c, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= TRANSFORM_RTOL * np.abs(want).max()
    q = got.double().numpy()
    res = q - c * (_apply_1d(kinds[0], q, 0, dy) + _apply_1d(kinds[1], q, 1, dx)) - b
    assert np.abs(res).max() <= MAC_RESIDUAL_RTOL * np.abs(b).max()


def test_unknown_axis_kind_raises():
    with pytest.raises(ValueError, match="axis kind"):
        th.make_mac_helmholtz((8, 8), ("dst3", "dst1"), 0.1, 0.1, device="cpu")
