"""The port's 3D compressible tier (``models/compressible3d.py`` and the
case ``blast3d``) against the JAX package and its physics.

Tolerances:
- five ``blast3d`` steps at 16³ from the state after 50 jitted JAX steps,
  for each nd flux (MUSCL, and first order for HLLC) and SSP-RK2 with
  HLLC: U component by component within 1e-5 of max|component|, t within
  1e-6 relative, each metric within 1e-5 of its magnitude (the bands of
  tests/test_torch_compressible.py);
- the initial state and the reflective BC bit-equal to the JAX package's;
- the port's own physics at 32³, 40 steps (tests/test_compressible3d.py:
  125): mass and energy conserved to 1e-4, the three axis density
  profiles through the centre within 0.02 of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import (
    compressible3d_state_from_numpy,
    compressible3d_state_to_numpy,
)
from cfdsim_tpu_torch.models.incompressible import make_chunk
from test_torch_compressible import compare_compressible_steps

BLAST_CONFIGS = {
    "rusanov": dict(flux="rusanov"),
    "hllc": dict(flux="hllc"),
    "roe": dict(flux="roe"),
    "hllc_first_order": dict(flux="hllc", reconstruction="none"),
    "hllc_rk2": dict(flux="hllc", time_order=2),
}


@pytest.mark.parametrize("config", sorted(BLAST_CONFIGS))
def test_blast3d_steps_match_jax(config):
    kw = dict(n=16, **BLAST_CONFIGS[config])
    jcase, tcase = j_build("blast3d", **kw), build("blast3d", device="cpu", **kw)
    np.testing.assert_array_equal(tcase.state.U.numpy(), np.asarray(jcase.state.U))
    compare_compressible_steps(jcase, tcase)


def test_blast3d_bc_matches_jax():
    """The z, y, x reflective writes on a random state, bit for bit, and the
    input left as it was."""
    jcase, tcase = j_build("blast3d", n=8), build("blast3d", n=8, device="cpu")
    U = np.random.default_rng(0).standard_normal((5, 8, 8, 8)).astype(np.float32)
    want = _jax_bc(jcase)(jnp.asarray(U), 0, 0.0)
    T = torch.tensor(U)
    got = tcase.step.bc_fn(T, tcase.state.step, tcase.state.t)
    assert torch.equal(T, torch.tensor(U))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_bc(jcase):
    """The JAX case's BC function, from its step's closure."""
    cells = dict(zip(jcase.step.__code__.co_freevars,
                     (c.cell_contents for c in jcase.step.__closure__)))
    return cells["bc_fn"]


def test_blast3d_spherical_and_conservative():
    case = build("blast3d", n=32, device="cpu")
    s = case.state
    mass0, e0 = (float(s.U[c, 1:-1, 1:-1, 1:-1].sum()) for c in (0, 4))
    s, m = make_chunk(case.cfg, case.step, 40)(s, 1.0)
    assert torch.isfinite(s.U).all()
    assert float(s.U[0, 1:-1, 1:-1, 1:-1].sum()) == pytest.approx(mass0, rel=1e-4)
    assert float(s.U[4, 1:-1, 1:-1, 1:-1].sum()) == pytest.approx(e0, rel=1e-4)
    rho = s.U[0].numpy()
    c = 16
    px, py, pz = rho[c, c, :], rho[c, :, c], rho[:, c, c]
    assert np.abs(px - py).max() < 0.02
    assert np.abs(px - pz).max() < 0.02
    assert m.dt.shape == (40,) and float(m.min_rho.min()) > 0


def test_state_round_trips_and_step_leaves_its_input():
    case = build("blast3d", n=8, device="cpu")
    d = compressible3d_state_to_numpy(case.state)
    back = compressible3d_state_from_numpy(d["U"], d["t"], d["step"], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, case.state))
    with pytest.raises(ValueError, match="compressible"):
        compressible3d_state_from_numpy(d["U"][0], 0.0, 0, "cpu")
    before = case.state.U.clone()
    s, _ = case.step(case.state, 1.0)
    assert torch.equal(case.state.U, before) and int(s.step) == 1
