"""Every exact DCT variant of the port's Neumann Poisson solve against the
JAX package's variant of the same name.

Tolerance: max |Δφ| ≤ 1e-5·max|φ|, the DCT band of
tests/test_torch_poisson.py. The variants build their twiddles in float32
as the JAX package does, but pocketfft (torch) and XLA's CPU FFT sum in
other orders, so they agree to fp32 rounding (observed ≤ 1e-6 relative),
not bit for bit. ``matmul`` is four float32 matmuls on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.solvers import autotune as jtune
from cfdsim_tpu.solvers import poisson as jpois
from cfdsim_tpu_torch.solvers import poisson as tpois

RTOL = 1e-5
VARIANTS = ["rfft", "rfft2", "rfft_split", "rfft_split4", "rfft_split8", "packed", "matmul"]
_jax_solve = jax.jit(jpois.solve_poisson_neumann_dct, static_argnums=(1, 2, 3))


def _rhs(shape, seed=0):
    r = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return r - r.mean()


def _jax_variant(rhs, dx, dy, variant):
    if variant == "matmul":
        m, n = rhs.shape
        return np.asarray(jax.jit(jtune.matmul_dct_solver(m, n, dx, dy))(jnp.asarray(rhs)))
    return np.asarray(_jax_solve(jnp.asarray(rhs), dx, dy, variant))


def _check(shape, variant, seed=0):
    rhs = _rhs(shape, seed)
    dx, dy = 1.0 / shape[1], 1.0 / shape[0]
    want = _jax_variant(rhs, dx, dy, variant)
    got = tpois.solve_poisson_neumann_dct(torch.from_numpy(rhs), dx, dy, variant)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    err = np.abs(got.numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), (variant, shape, err)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(32, 48), (64, 64), (128, 128)], ids=str)
def test_variant_matches_jax(shape, variant):
    _check(shape, variant)


@pytest.mark.parametrize("variant, shape", [
    ("rfft_split", (4, 4)), ("rfft_split4", (8, 8)), ("rfft_split8", (16, 16)),
    ("rfft_split4", (8, 24)), ("rfft_split8", (48, 16)),
], ids=str)
def test_split_variants_at_their_smallest_sizes(variant, shape):
    _check(shape, variant, seed=3)


@pytest.mark.parametrize("variant", ["rfft2", "rfft_split", "rfft_split8"])
def test_odd_side_takes_the_per_axis_path(variant):
    """An odd side sends rfft2 and rfft_split* to the per-axis rfft path,
    as in the JAX package."""
    _check((33, 40), variant, seed=4)


@pytest.mark.parametrize("variant, shape, divisor", [
    ("rfft_split", (6, 8), 4), ("rfft_split4", (12, 16), 8), ("rfft_split8", (24, 48), 16),
], ids=str)
def test_size_errors_raise_as_jax(variant, shape, divisor):
    message = f"{variant} needs sizes divisible by {divisor}"
    with pytest.raises(ValueError, match=message):
        jpois.solve_poisson_neumann_dct(jnp.zeros(shape, jnp.float32), 0.1, 0.1, variant)
    with pytest.raises(ValueError, match=message):
        tpois.NeumannDCT(shape, 0.1, 0.1, variant, device="cpu")


def test_packed_needs_even_sides():
    with pytest.raises(ValueError, match="even"):
        tpois.NeumannDCT((33, 40), 0.1, 0.1, "packed", device="cpu")


def test_variants_keep_buffers_and_mean_free_convention():
    """Each variant's tables are buffers (one build, no host work per call),
    and every variant projects out the constant mode."""
    rhs = torch.from_numpy(_rhs((32, 48), seed=5))
    for variant in VARIANTS:
        solver = tpois.NeumannDCT((32, 48), 1 / 48, 1 / 32, variant, device="cpu")
        assert len(list(solver.buffers())) >= 2, variant
        phi = solver(rhs)
        assert abs(float(phi.mean())) <= 1e-5 * float(phi.abs().max()), variant
        res = float(tpois.poisson_residual(phi, rhs, 1 / 48, 1 / 32))
        assert res <= 1e-3 * float(rhs.abs().max()), variant
