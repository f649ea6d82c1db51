"""The port's iterative Poisson family (Jacobi, red-black SOR, multigrid,
the DCT + SOR hybrid, the periodic FFT solve, and the early exit) against
the JAX package on the same seeded problem, plus the configuration and the
``"method[:iters[:omega]]"`` spec.

Each case's tolerance is a fraction of max|φ| (see ``CASES``):
- sweeps (jacobi, rbsor, rbsor_pallas): 2e-6. The same float32 operations;
  XLA's CPU jit contracts a·b + c into FMAs where the port rounds twice
  (observed ≤ 4.5e-7 after 20 sweeps).
- multigrid: 2e-5. The same contraction, plus the 2×2 restriction mean
  and the residual summed in another order (observed ≤ 3.2e-6).
- hybrid and fft: 2e-5, the FFT's summation order (the band of
  tests/test_torch_poisson.py is 1e-5 for one DCT solve; observed ≤ 1.1e-6).
- the early exits: the same as their sweeps, after the same chunk count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import _poisson_spec as j_spec
from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig
from cfdsim_tpu.solvers.poisson import solve_poisson as j_solve
from cfdsim_tpu_torch.cases import _poisson_spec
from cfdsim_tpu_torch.solvers import poisson as tp

SHAPE = (32, 48)
H = 1.0 / 32

CASES = {
    "jacobi-neumann": (dict(method="jacobi", iters=20), False, 2e-6),
    "jacobi-dirichlet": (dict(method="jacobi", iters=20, bc="dirichlet"), False, 2e-6),
    "rbsor-neumann": (dict(method="rbsor", iters=20), False, 2e-6),
    "rbsor-dirichlet": (dict(method="rbsor", iters=20, bc="dirichlet"), False, 2e-6),
    "rbsor-masked": (dict(method="rbsor", iters=20), True, 2e-6),
    "rbsor-masked-dirichlet": (dict(method="rbsor", iters=20, bc="dirichlet"), True, 2e-6),
    "rbsor-tol": (dict(method="rbsor", iters=400, tol=5e-2, check_every=10), False, 2e-6),
    "jacobi-tol": (dict(method="jacobi", iters=100, tol=1.0, check_every=10), False, 2e-6),
    "rbsor_pallas": (dict(method="rbsor_pallas", iters=20), False, 2e-6),
    "rbsor_pallas-masked-dirichlet": (
        dict(method="rbsor_pallas", iters=20, bc="dirichlet"), True, 2e-6),
    "mg": (dict(method="mg", iters=3, mg_pallas_smooth=False), False, 2e-5),
    "mg-kernel-smoothing": (dict(method="mg", iters=3, mg_pallas_smooth=True), False, 2e-5),
    "hybrid": (dict(method="hybrid", iters=20), False, 2e-5),
    "hybrid-masked": (dict(method="hybrid", iters=20), True, 2e-5),
    "fft": (dict(method="fft"), False, 2e-5),
}


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    rhs = rng.standard_normal(SHAPE).astype(np.float32)
    rhs -= rhs.mean()
    phi0 = (0.01 * rng.standard_normal(SHAPE)).astype(np.float32)
    solid = np.zeros(SHAPE, dtype=bool)
    solid[10:14, 20:26] = True
    return phi0, rhs, solid


@pytest.mark.parametrize("name", list(CASES))
def test_method_matches_jax(name):
    kw, masked, rtol = CASES[name]
    phi0, rhs, solid = _problem()
    mask = solid if masked else None
    want = np.asarray(j_solve(jnp.asarray(phi0), jnp.asarray(rhs), H, H, JConfig(**kw),
                              solid_mask=None if mask is None else jnp.asarray(mask)))
    got = tp.solve_poisson(torch.from_numpy(phi0), torch.from_numpy(rhs), H, H,
                           tp.PoissonConfig(**kw), solid_mask=mask)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    assert np.abs(got.numpy() - want).max() <= rtol * np.abs(want).max()
    if masked and kw["method"] != "hybrid":
        assert np.array_equal(got.numpy()[solid], phi0[solid])  # frozen


def test_early_exit_stops_where_jax_does():
    """The streaming early exit converges to its tolerance and stops before
    its budget, in the chunk the JAX while_loop stops in."""
    phi0, rhs, _ = _problem(1)
    cfg = tp.PoissonConfig(method="rbsor", iters=400, tol=5e-2, check_every=10)
    got = tp.solve_poisson(torch.from_numpy(phi0), torch.from_numpy(rhs), H, H, cfg)
    res = float(tp.poisson_residual(got, torch.from_numpy(rhs), H, H))
    assert res <= cfg.tol
    # the sweep count it ran: continue 10 sweeps at a time until φ matches
    p, ran = torch.from_numpy(phi0), 0
    while not torch.equal(p, got):
        p = tp.solve_poisson(p, torch.from_numpy(rhs), H, H, tp.PoissonConfig(method="rbsor", iters=10))
        ran += 10
        assert ran < 400
    want = np.asarray(j_solve(jnp.asarray(phi0), jnp.asarray(rhs), H, H,
                              JConfig(method="rbsor", iters=ran)))
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()


def test_periodic_fft_solve_matches_jax():
    from cfdsim_tpu.solvers.poisson import solve_poisson_periodic_fft as j_fft

    _, rhs, _ = _problem(2)
    want = np.asarray(j_fft(jnp.asarray(rhs), 0.05, 0.07))
    got = tp.solve_poisson_periodic_fft(torch.from_numpy(rhs), 0.05, 0.07)
    assert np.abs(got.numpy() - want).max() <= 2e-5 * np.abs(want).max()


def test_config_defaults_match_jax():
    assert dataclasses.asdict(tp.PoissonConfig()) == dataclasses.asdict(JConfig())


@pytest.mark.parametrize("spec", ["mg:2", "rbsor:100:1.7", "dct", "jacobi:7", "hybrid:3:1.2"])
def test_poisson_spec_matches_jax(spec):
    assert dataclasses.asdict(_poisson_spec(spec)) == dataclasses.asdict(j_spec(spec))


def test_poisson_spec_passes_configs_through():
    cfg = tp.PoissonConfig(method="mg", iters=3)
    assert _poisson_spec(cfg) is cfg and _poisson_spec(None) is None


def test_mg_level_shapes_match_jax():
    from cfdsim_tpu.solvers.poisson import _mg_level_shapes as j_levels

    for shape in [(1024, 1024), (180, 600), (32, 48), (36, 120)]:
        assert tp._mg_level_shapes(shape, 4) == j_levels(shape, 4)


@pytest.mark.parametrize("kw, masked, error", [
    (dict(method="mg"), True, ValueError),
    (dict(method="mg", bc="dirichlet"), False, ValueError),
    (dict(method="rbsor", bc="periodic"), False, ValueError),
    (dict(method="sor"), False, ValueError),
], ids=["mg-masked", "mg-dirichlet", "rbsor-periodic", "unknown"])
def test_refusals(kw, masked, error):
    """What the JAX package refuses (with a ValueError, or an assert for
    multigrid) the port refuses with a ValueError."""
    phi0, rhs, solid = _problem()
    with pytest.raises(error):
        tp.solve_poisson(torch.from_numpy(phi0), torch.from_numpy(rhs), H, H,
                         tp.PoissonConfig(**kw), solid_mask=solid if masked else None)
