"""The port's Riemann solvers (``cfdsim_tpu_torch/solvers/riemann.py``),
MUSCL faces and acoustic dt against the JAX package on seeded inputs.

Tolerances:
- every 2D flux (rusanov, hllc, roe, roe_ref) on each axis and every nd
  flux (rusanov, hllc, roe) on each velocity axis, on random states and on
  states with a jump: within 1e-6 of max|F| (float32; XLA's jit contracts
  a·b + c into FMAs where eager torch rounds twice);
- ``cons_to_prim``/``prim_to_cons`` (2D and nd) within 1e-6 of each
  output's max; the MUSCL faces of ``models/compressible.py`` and
  ``models/compressible3d.py`` under each slope limiter within 1e-6 of
  max|U|; ``acoustic_dt`` within 1e-6 relative;
- a uniform state's flux equals the exact Euler flux (1e-5, the JAX
  package's own consistency band).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.grid import Grid as JGrid
from cfdsim_tpu.grid import Grid3D as JGrid3D
from cfdsim_tpu.models import compressible as jcomp
from cfdsim_tpu.models import compressible3d as jc3
from cfdsim_tpu.solvers import riemann as jr
from cfdsim_tpu_torch.grid import Grid, Grid3D
from cfdsim_tpu_torch.models import compressible as tcomp
from cfdsim_tpu_torch.models import compressible3d as tc3
from cfdsim_tpu_torch.solvers import riemann as tr

GAMMA = 1.4
FLUX_RTOL = 1e-6
PRIM_RTOL = 1e-6
FACE_RTOL = 1e-6
DT_RTOL = 1e-6


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _prims(shape, seed, ndim):
    rng = np.random.default_rng(seed)
    rho = (0.5 + rng.random(shape)).astype(np.float32)
    vels = [rng.standard_normal(shape).astype(np.float32) for _ in range(ndim)]
    p = (0.5 + rng.random(shape)).astype(np.float32)
    return rho, vels, p


def _cons(rho, vels, p):
    """Conserved states in float64 numpy, cast to float32."""
    rho, p = rho.astype(np.float64), p.astype(np.float64)
    vels = [v.astype(np.float64) for v in vels]
    E = p / ((GAMMA - 1.0) * rho) + 0.5 * sum(v * v for v in vels)
    return np.stack([rho, *(rho * v for v in vels), rho * E]).astype(np.float32)


def _states(kind, ndim, seed=0):
    """(UL, UR) of ``kind``: "random" (two unrelated random states) or
    "jump" (a smooth state against a shocked copy: ρ and p jump at half the
    faces, the Sod ratios, with normal velocities of both signs)."""
    shape = (6, 8, 10) if ndim == 3 else (8, 16)
    if kind == "random":
        return _cons(*_prims(shape, seed, ndim)), _cons(*_prims(shape, seed + 1, ndim))
    rho, vels, p = _prims(shape, seed, ndim)
    jump = np.zeros(shape, bool)
    jump[..., : shape[-1] // 2] = True
    rho_r = np.where(jump, 0.125 * rho, 1.1 * rho).astype(np.float32)
    p_r = np.where(jump, 0.1 * p, 1.2 * p).astype(np.float32)
    vels_r = [np.where(jump, -0.5 * v, 0.9 * v).astype(np.float32) for v in vels]
    return _cons(rho, vels, p), _cons(rho_r, vels_r, p_r)


@pytest.mark.parametrize("kind", ["random", "jump"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name", sorted(tr.FLUXES))
def test_2d_flux_matches_jax(name, axis, kind):
    UL, UR = _states(kind, 2)
    want = jax.jit(jr.FLUXES[name], static_argnums=(2, 3))(
        jnp.asarray(UL), jnp.asarray(UR), GAMMA, axis)
    got = tr.FLUXES[name](torch.tensor(UL), torch.tensor(UR), GAMMA, axis)
    assert got.dtype == torch.float32 and got.shape == UL.shape
    assert _rel(got.numpy(), want) <= FLUX_RTOL


@pytest.mark.parametrize("kind", ["random", "jump"])
@pytest.mark.parametrize("vaxis", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(tr.FLUXES_ND))
def test_nd_flux_matches_jax(name, vaxis, kind):
    UL, UR = _states(kind, 3, seed=3)
    want = jax.jit(jr.FLUXES_ND[name], static_argnums=(2, 3))(
        jnp.asarray(UL), jnp.asarray(UR), GAMMA, vaxis)
    got = tr.FLUXES_ND[name](torch.tensor(UL), torch.tensor(UR), GAMMA, vaxis)
    assert got.shape == UL.shape
    assert _rel(got.numpy(), want) <= FLUX_RTOL


@pytest.mark.parametrize("name", sorted(tr.FLUXES_ND))
def test_nd_flux_in_2d_matches_jax(name):
    """The nd family on a 2D state (two velocity components)."""
    UL, UR = _states("jump", 2, seed=5)
    for vaxis in (0, 1):
        want = jr.FLUXES_ND[name](jnp.asarray(UL), jnp.asarray(UR), GAMMA, vaxis)
        got = tr.FLUXES_ND[name](torch.tensor(UL), torch.tensor(UR), GAMMA, vaxis)
        assert _rel(got.numpy(), want) <= FLUX_RTOL


@pytest.mark.parametrize("name", sorted(tr.FLUXES))
def test_uniform_state_flux_is_euler_flux(name):
    U = _cons(np.full((4, 6), 1.3, np.float32), [np.full((4, 6), 0.7, np.float32),
                                                  np.full((4, 6), -0.2, np.float32)],
              np.full((4, 6), 2.1, np.float32))
    U = torch.tensor(U)
    for axis in (0, 1):
        np.testing.assert_allclose(tr.FLUXES[name](U, U, GAMMA, axis).numpy(),
                                   tr.euler_flux(U, GAMMA, axis).numpy(), rtol=1e-5, atol=1e-5)


def test_primitive_conversions_match_jax():
    UL, _ = _states("jump", 2)
    want = jr.cons_to_prim(jnp.asarray(UL), GAMMA)
    got = tr.cons_to_prim(torch.tensor(UL), GAMMA)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= PRIM_RTOL
    back = tr.prim_to_cons(*got, GAMMA)
    assert _rel(back.numpy(), jr.prim_to_cons(*want, GAMMA)) <= PRIM_RTOL
    assert _rel(back.numpy(), UL) <= 1e-5  # the round trip
    U3, _ = _states("random", 3, seed=7)
    (jrho, jv, jp), (trho, tv, tp) = (jr.cons_to_prim_nd(jnp.asarray(U3), GAMMA),
                                      tr.cons_to_prim_nd(torch.tensor(U3), GAMMA))
    for g, w in zip([trho, *tv, tp], [jrho, *jv, jp]):
        assert _rel(g.numpy(), w) <= PRIM_RTOL
    assert _rel(tc3.prim_to_cons_3d(trho, *tv, tp, GAMMA).numpy(),
                jc3.prim_to_cons_3d(jrho, *jv, jp, GAMMA)) <= PRIM_RTOL
    s = tr.sound_speed(trho, tp, GAMMA)
    assert _rel(s.numpy(), jr.sound_speed(jrho, jp, GAMMA)) <= PRIM_RTOL


@pytest.mark.parametrize("limiter", ["minmod", "superbee", "vanleer"])
def test_muscl_faces_match_jax(limiter):
    U, _ = _states("jump", 2, seed=9)
    kw = dict(reconstruction="muscl", limiter=limiter, flux="hllc")
    jcfg = jcomp.CompressibleConfig(grid=JGrid(nx=16, ny=8, centering="cell"), **kw)
    tcfg = tcomp.CompressibleConfig(grid=Grid(nx=16, ny=8, centering="cell"), **kw)
    for axis in (0, 1):
        want = jcomp._face_states(jcfg, jnp.asarray(U), axis)
        got = tcomp._face_states(tcfg, torch.tensor(U), axis)
        for g, w in zip(got, want):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= FACE_RTOL
    U3, _ = _states("jump", 3, seed=11)
    jcfg3 = jc3.Compressible3DConfig(grid=JGrid3D(nx=10, ny=8, nz=6), **kw)
    tcfg3 = tc3.Compressible3DConfig(grid=Grid3D(nx=10, ny=8, nz=6), **kw)
    for s in (0, 1, 2):
        want = jc3._face_states(jcfg3, jnp.asarray(U3), s)
        got = tc3._face_states(tcfg3, torch.tensor(U3), s)
        for g, w in zip(got, want):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= FACE_RTOL


def test_acoustic_dt_matches_jax():
    U, _ = _states("jump", 2, seed=13)
    jcfg = jcomp.CompressibleConfig(grid=JGrid(nx=16, ny=8, y_max=0.7, centering="cell"))
    tcfg = tcomp.CompressibleConfig(grid=Grid(nx=16, ny=8, y_max=0.7, centering="cell"))
    for scale in (1.0, 0.25):
        want = float(jcomp.acoustic_dt(jcfg, jnp.asarray(U), jnp.float32(scale)))
        got = tcomp.acoustic_dt(tcfg, torch.tensor(U), torch.tensor(scale))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= DT_RTOL * want
    U3, _ = _states("random", 3, seed=15)
    jcfg3 = jc3.Compressible3DConfig(grid=JGrid3D(nx=10, ny=8, nz=6, z_max=0.5))
    tcfg3 = tc3.Compressible3DConfig(grid=Grid3D(nx=10, ny=8, nz=6, z_max=0.5))
    want = float(jc3.acoustic_dt_3d(jcfg3, jnp.asarray(U3), jnp.float32(1.0)))
    got = float(tc3.acoustic_dt_3d(tcfg3, torch.tensor(U3), torch.tensor(1.0)))
    assert abs(got - want) <= DT_RTOL * want
