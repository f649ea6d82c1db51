"""The port's exact Neumann DCT Poisson solve against the JAX package.

Tolerance: max |Δφ| ≤ 1e-5·max|φ|. Both sides run pocketfft-style FFTs on
the CPU, but the two frameworks sum in different orders, so the solutions
agree to fp32 rounding of the transform (observed ~3e-7 relative), not bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.solvers import poisson as jpois
from cfdsim_tpu_torch.solvers import poisson as tpois

RTOL = 1e-5
# one compile per shape instead of the eager path's one per primitive
_jax_solve = jax.jit(jpois.solve_poisson_neumann_dct, static_argnums=(1, 2, 3))


def _rhs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("variant", ["rfft", "rfft2"])
@pytest.mark.parametrize("shape", [(48, 48), (32, 64), (33, 40), (40, 33)])
def test_dct_solve_matches_jax(shape, variant):
    # (33, 40) and (40, 33) have an odd axis: the even-extension
    # _dct2/_idct2 transforms there, and "rfft2" takes the per-axis path
    rhs = _rhs(shape)
    dx, dy = 1.0 / (shape[1] - 1), 1.0 / (shape[0] - 1)
    want = np.asarray(_jax_solve(jnp.asarray(rhs), dx, dy, variant))
    got = tpois.solve_poisson_neumann_dct(torch.from_numpy(rhs), dx, dy, variant)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()


def test_dct_solve_is_exact():
    """The solve inverts the clamped-edge Laplacian up to the mean mode."""
    rhs = _rhs((32, 64), seed=1)
    rhs -= rhs.mean()
    dx, dy = 1.0 / 63, 1.0 / 31
    phi = tpois.solve_poisson_neumann_dct(torch.from_numpy(rhs), dx, dy, "rfft2")
    res = float(tpois.poisson_residual(phi, torch.from_numpy(rhs), dx, dy))
    assert res <= 1e-4 * np.abs(rhs).max()
    assert abs(float(phi.mean())) <= 1e-6 * float(phi.abs().max())


def test_solve_poisson_dispatches_dct():
    rhs = torch.from_numpy(_rhs((16, 16), seed=2))
    cfg = tpois.PoissonConfig(method="dct", dct_variant="rfft2")
    got = tpois.solve_poisson(torch.zeros_like(rhs), rhs, 0.1, 0.1, cfg)
    want = tpois.solve_poisson_neumann_dct(rhs, 0.1, 0.1, "rfft2")
    assert torch.equal(got, want)


@pytest.mark.parametrize("cfg", [
    dict(method="dct", dct_variant="auto"),
    dict(method="dct", dct_variant="packed"),
    dict(method="dct", dct_variant="matmul"),
    dict(method="dct", dct_variant="rfft_split4"),
    dict(method="dct", bc="dirichlet"),
], ids=str)
def test_unported_poisson_configs_raise(cfg, tmp_path, monkeypatch):
    """Of the configurations the port once refused, only the non-Neumann
    ``dct`` still raises; the DCT variants now solve, equal to ``rfft``
    (tests/test_torch_dct_variants.py holds each against the JAX package)."""
    monkeypatch.setenv("CFDSIM_AUTOTUNE_CACHE", str(tmp_path))
    rhs = torch.from_numpy(_rhs((8, 8), seed=6))
    rhs -= rhs.mean()
    cfg = tpois.PoissonConfig(**cfg)
    if cfg.bc != "neumann":
        with pytest.raises(NotImplementedError):
            tpois.solve_poisson(rhs, rhs, 0.1, 0.1, cfg)
        return
    got = tpois.solve_poisson(torch.zeros_like(rhs), rhs, 0.1, 0.1, cfg)
    want = tpois.solve_poisson_neumann_dct(rhs, 0.1, 0.1, "rfft")
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


def test_unported_dct_variant_raises_in_solver():
    """Every variant of the JAX package is ported; a name outside them raises."""
    with pytest.raises(ValueError, match="packed"):
        tpois.NeumannDCT((8, 8), 0.1, 0.1, "packed2", device="cpu")
