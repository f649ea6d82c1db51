"""The 3D ghost-cell IBM of the port (``ibm_ghost.py``'s 3D half) against
the JAX package's ``cfdsim_tpu.ibm_ghost``: the stencil arrays of
``sphere_ghost_ibm`` and ``sphere_ghost_cells`` on uniform and stretched
faces, ``apply_ghost_forcing`` and both moving-body variants on seeded
fields (probes on the last plane of every axis included), and the static
limit of the moving forcing.

Tolerances:
- stencil arrays: ``solid``, the ghost indices and ``pidx`` equal; ``pw``
  and ``scale`` equal in float32 (the same float64 numpy, cast once); the
  ghost faces unique (the scatter needs no accumulate);
- the forcing functions: within 1e-6 of max|field| (float32 arithmetic on
  both sides; a probe is a sum of eight products, which XLA may contract
  into FMAs and sum in another order);
- the static limit of the moving forcing against the precomputed one:
  2e-5 absolute, the band of tests/test_ibm_ghost.py:429 (the two locate
  the probe by different arithmetic: float32 floor against float64
  ``searchsorted``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import ibm_ghost as jg
from cfdsim_tpu.models.mac_stretched import stretched_faces
from cfdsim_tpu_torch import ibm_ghost as tg

FIELD_RTOL = 1e-6
STATIC_LIMIT_ATOL = 2e-5


def _np(t):
    return t.cpu().numpy()


def _faces(kind):
    if kind == "uniform":
        return (np.linspace(0.0, 8.0, 33), np.linspace(0.0, 4.0, 17),
                np.linspace(0.0, 4.0, 17))
    return (stretched_faces(32, 8.0, refine=[(2.0, 1.0, 2.0)]),
            stretched_faces(16, 4.0, refine=[(2.0, 1.0, 2.0)]),
            stretched_faces(16, 4.0, refine=[(2.0, 1.0, 2.0)]))


def _assert_sets_equal(js, ts):
    assert len(_np(ts.gx)) > 0
    for name in ("solid", "gz", "gy", "gx", "pidx"):
        assert np.array_equal(np.asarray(getattr(js, name)), _np(getattr(ts, name))), name
    for name in ("pw", "scale"):
        a, b = np.asarray(getattr(js, name)), _np(getattr(ts, name))
        assert b.dtype == np.float32 and np.array_equal(a, b), name
    nz, ny, nx = ts.solid.shape
    flat = (_np(ts.gz) * ny + _np(ts.gy)) * nx + _np(ts.gx)
    assert len(np.unique(flat)) == len(flat)
    assert ts.gz.dtype == ts.pidx.dtype == torch.int64


@pytest.mark.parametrize("kind, center, radius", [
    ("uniform", (2.0, 2.0, 2.0), 0.5),
    ("stretched", (2.0, 2.0, 2.0), 0.5),
    ("uniform", (7.8, 3.8, 3.85), 0.45),  # the probes leave the grid at every far end
], ids=["uniform", "stretched", "far-corner"])
def test_sphere_stencils_equal_jax(kind, center, radius):
    xf, yf, zf = _faces(kind)
    j = jg.sphere_ghost_ibm(xf, yf, zf, center, radius)
    t = tg.sphere_ghost_ibm(xf, yf, zf, center, radius, device="cpu")
    for js, ts in zip(j, t):
        _assert_sets_equal(js, ts)
    _assert_sets_equal(jg.sphere_ghost_cells(xf, yf, zf, center, radius),
                       tg.sphere_ghost_cells(xf, yf, zf, center, radius, device="cpu"))


def _field(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, scale):
    err = float(np.abs(got - np.asarray(want)).max()) / scale
    assert err <= FIELD_RTOL, err
    return err


@pytest.mark.parametrize("strength", [1.0, 0.4])
def test_apply_ghost_forcing_matches_jax(strength):
    xf, yf, zf = _faces("stretched")
    j = jg.sphere_ghost_ibm(xf, yf, zf, (2.0, 2.0, 2.0), 0.5)
    t = tg.sphere_ghost_ibm(xf, yf, zf, (2.0, 2.0, 2.0), 0.5, device="cpu")
    apply = jax.jit(jg.apply_ghost_forcing)
    for comp, shape in (("u", (16, 16, 33)), ("v", (16, 17, 32)), ("w", (17, 16, 32))):
        f = _field(shape, 3)
        jo, jd = apply(jnp.asarray(f), getattr(j, comp), jnp.float32(strength))
        to, td = tg.apply_ghost_forcing(torch.tensor(f), getattr(t, comp),
                                        torch.tensor(strength))
        scale = float(np.abs(f).max())
        _close(_np(to), jo, scale)
        _close(_np(td), jd, scale)
    # the module form a step holds gives the same bits
    mod = tg.GhostForcing3D(t.w, device="cpu")
    f = torch.tensor(_field((17, 16, 32), 4))
    a = mod(f, torch.tensor(strength))
    b = tg.apply_ghost_forcing(f, t.w, torch.tensor(strength))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _grids(xs, ys, zs):
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    return tuple(a.astype(np.float32) for a in (X, Y, Z))


# a sphere in the middle of the grid, and one whose probes land on the last
# plane of every axis (the clip bounds of the corner lookup)
MOVING = [((2.1, 1.9, 2.05), 0.5, 0.3), ((7.8, 3.85, 3.82), 0.45, -0.2)]


@pytest.mark.parametrize("center, radius, u_b", MOVING, ids=["middle", "last-plane"])
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "nonuniform"])
def test_moving_ghost_forcing_3d_matches_jax(center, radius, u_b, uniform):
    nx, ny, nz = 32, 16, 16
    h = 0.25
    if uniform:
        xf = np.arange(nx + 1) * h
        yf, zf = np.arange(ny + 1) * h, np.arange(nz + 1) * h
    else:
        xf, yf, zf = _faces("stretched")
    yc, zc = 0.5 * (yf[:-1] + yf[1:]), 0.5 * (zf[:-1] + zf[1:])
    X, Y, Z = _grids(xf, yc, zc)
    f = _field((nz, ny, nx + 1), 5)
    delta = 1.5 * h
    jctr = tuple(jnp.float32(c) for c in center)
    tctr = tuple(torch.tensor(c, dtype=torch.float32) for c in center)
    if uniform:
        origin, spacing = (0.0, 0.5 * h, 0.5 * h), (h, h, h)
        jo, jd = jax.jit(lambda f, X, Y, Z, c, ub, s: jg.moving_ghost_forcing_3d(
            f, X, Y, Z, origin, spacing, c, radius, delta, ub, s))(
            jnp.asarray(f), X, Y, Z, jctr, jnp.float32(u_b), jnp.float32(0.7))
        to, td = tg.moving_ghost_forcing_3d(
            torch.tensor(f), *(torch.tensor(a) for a in (X, Y, Z)), origin, spacing, tctr,
            radius, delta, torch.tensor(u_b), torch.tensor(0.7))
    else:
        jo, jd = jax.jit(lambda f, X, Y, Z, c, ub, s: jg.moving_ghost_forcing_3d_nonuniform(
            f, X, Y, Z, xf, yc, zc, c, radius, delta, ub, s))(
            jnp.asarray(f), X, Y, Z, jctr, jnp.float32(u_b), jnp.float32(0.7))
        to, td = tg.moving_ghost_forcing_3d_nonuniform(
            torch.tensor(f), *(torch.tensor(a) for a in (X, Y, Z)),
            *(torch.tensor(np.asarray(s, np.float32)) for s in (xf, yc, zc)), tctr, radius,
            delta, torch.tensor(u_b), torch.tensor(0.7))
    scale = float(np.abs(f).max())
    _close(_np(to), jo, scale)
    _close(_np(td), jd, scale)
    # the forcing touched the body
    assert float(td.abs().max()) > 0.0


def test_moving_ghost_3d_static_limit_matches_precomputed():
    """tests/test_ibm_ghost.py:429: with a fixed centre and u_b = 0 the
    moving forcing equals the host-precomputed static one."""
    nx, ny, nz = 32, 16, 16
    xf = np.linspace(0.0, 8.0, nx + 1)
    yf = np.linspace(0.0, 4.0, ny + 1)
    zf = np.linspace(0.0, 4.0, nz + 1)
    h = 0.25
    yc, zc = 0.5 * (yf[:-1] + yf[1:]), 0.5 * (zf[:-1] + zf[1:])
    X, Y, Z = (torch.tensor(a) for a in _grids(xf, yc, zc))
    f = torch.tensor(np.random.default_rng(1).normal(size=(nz, ny, nx + 1)).astype(np.float32))
    static = tg.sphere_ghost_ibm(xf, yf, zf, (2.0, 2.0, 2.0), 0.5, probe_dist=1.5 * h,
                                 device="cpu")
    one = torch.tensor(1.0)
    out_s, du_s = tg.apply_ghost_forcing(f, static.u, one)
    out_m, du_m = tg.moving_ghost_forcing_3d(f, X, Y, Z, (0.0, 0.5 * h, 0.5 * h), (h, h, h),
                                             (2.0, 2.0, 2.0), 0.5, 1.5 * h, torch.tensor(0.0),
                                             one)
    assert float((out_m - out_s).abs().max()) <= STATIC_LIMIT_ATOL
    assert float((du_m - du_s).abs().max()) <= STATIC_LIMIT_ATOL
