"""The port's stencil operators, BCs and Poisson residual against the JAX
package on the same seeded inputs.

Tolerance: atol 1e-6, on every output, including the Laplacians whose
values reach 1e4 here. Both sides evaluate the same fp32 expressions in the
same order on the CPU, so they agree to the last bit; the band only leaves
room for a compiler that contracts a multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import boundary as jbc
from cfdsim_tpu.ops import convection as jconv
from cfdsim_tpu.ops import stencil as jst
from cfdsim_tpu.solvers import poisson as jpois
from cfdsim_tpu_torch import boundary as tbc
from cfdsim_tpu_torch.ops import convection as tconv
from cfdsim_tpu_torch.ops import stencil as tst
from cfdsim_tpu_torch.solvers import poisson as tpois

SHAPE = (32, 48)
DX, DY = 1.0 / 47, 1.0 / 31
ATOL = 1e-6


def _fields(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(n)]


# name -> call on module m (JAX or port) with three (ny, nx) arrays a, b, c
OPS = {
    "gradient": lambda m, a, b, c: m.gradient(a, DX, DY),
    "divergence": lambda m, a, b, c: m.divergence(a, b, DX, DY),
    "laplacian": lambda m, a, b, c: m.laplacian(a, DX, DY),
    "laplacian_coeff_scalar": lambda m, a, b, c: m.laplacian_coeff(a, DX, DY, 0.01),
    "laplacian_coeff_field": (
        lambda m, a, b, c: m.laplacian_coeff(a, DX, DY, 0.01 + 0.001 * c * c)),
    "curl": lambda m, a, b, c: m.curl(a, b, DX, DY),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _compare(got, want, atol=ATOL):
    got, want = _as_tuple(got), _as_tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(OPS))
def test_stencil_matches_jax(name):
    a, b, c = _fields(1)
    call = OPS[name]
    want = call(jst, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = call(tst, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c))
    _compare(got, want)


@pytest.mark.parametrize("phi_is", ["u", "v"])
def test_convection_central_matches_jax(phi_is):
    u, v, _ = _fields(2)
    phi = u if phi_is == "u" else v
    want = jconv.convection_central(jnp.asarray(u), jnp.asarray(v), jnp.asarray(phi), DX, DY)
    got = tconv.convection_central(
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(phi), DX, DY)
    _compare(got, want)


def test_lid_cavity_bcs_match_jax():
    u, v, _ = _fields(3)
    ju, jv = jbc.lid_cavity_bcs(1.5)(jnp.asarray(u), jnp.asarray(v))
    tu, tv = tbc.lid_cavity_bcs(1.5)(torch.from_numpy(u.copy()), torch.from_numpy(v.copy()))
    _compare((tu, tv), (ju, jv), atol=0)
    assert float(tu[-1, 0]) == 1.5 and float(tu[-1, -1]) == 1.5  # lid written last


@pytest.mark.parametrize("side", ["x_lo", "x_hi", "y_lo", "y_hi"])
def test_edge_writes_match_jax(side):
    a, _, _ = _fields(4)
    _compare(tbc.set_edge(torch.from_numpy(a.copy()), side, 2.0),
             jbc.set_edge(jnp.asarray(a), side, 2.0), atol=0)
    _compare(tbc.copy_edge(torch.from_numpy(a.copy()), side),
             jbc.copy_edge(jnp.asarray(a), side), atol=0)


def test_mirror_all_edges_matches_jax():
    a, _, _ = _fields(5)
    _compare(tbc.mirror_all_edges(torch.from_numpy(a.copy())),
             jbc.mirror_all_edges(jnp.asarray(a)), atol=0)


def test_interior_mask_matches_jax():
    _compare(tst.interior_mask(SHAPE, width=2, device="cpu"),
             jst.interior_mask(SHAPE, width=2), atol=0)


@pytest.mark.parametrize("fn", ["lap_neumann", "neighbor_sum_dirichlet"])
def test_poisson_operators_match_jax(fn):
    a, _, _ = _fields(6)
    if fn == "lap_neumann":
        want = jpois.lap_neumann(jnp.asarray(a), DX, DY)
        got = tpois.lap_neumann(torch.from_numpy(a), DX, DY)
    else:
        want = jpois._neighbor_sum_dirichlet(jnp.asarray(a), 3.0, 5.0)
        got = tpois._neighbor_sum_dirichlet(torch.from_numpy(a), 3.0, 5.0)
    _compare(got, want)


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
@pytest.mark.parametrize("masked", [False, True])
def test_poisson_residual_matches_jax(bc, masked):
    phi, rhs, m = _fields(7)
    mask = m > 1.0 if masked else None
    want = float(jpois.poisson_residual(
        jnp.asarray(phi), jnp.asarray(rhs), DX, DY,
        None if mask is None else jnp.asarray(mask), bc))
    got = float(tpois.poisson_residual(
        torch.from_numpy(phi), torch.from_numpy(rhs), DX, DY,
        None if mask is None else torch.from_numpy(mask), bc))
    assert abs(got - want) <= ATOL
