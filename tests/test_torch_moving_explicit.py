"""Moving bodies on gloo ranks (the ``moving_body=`` of
``cfdsim_tpu_torch/parallel/mac_explicit.py``, ``mac_stretched_explicit.py``,
``mac3d_explicit.py`` and ``mac_stretched3d_explicit.py``, penalized or with
the moving ghost of ``ibm_ghost_explicit.py``) against the JAX package's
single-device steps and the port's own, from the same inputs: the twins of
the explicit rows of tests/test_moving_ibm.py (:210, :251, :295, :385,
:431, :471 and :519) with their grids, step counts and tolerances, on a
2×2 mesh of 4 ranks where the JAX tests have 2×4 devices.

One group of ranks runs every case (``_moving_ranks``); rank 0 returns the
gathered trimmed fields and the last metrics. JAX is imported inside the
tests: the ranks import this module for their function and need torch
alone.
"""

import numpy as np
import pytest

TOPOLOGY = (2, 2)
OSC = dict(nx=64, ny=32, domain=(16.0, 8.0), center=(8.0, 4.0), KC=4.0, Re=80.0, period=4.0,
           scheme="tvd")
SPHERE_BOX = dict(nx=24, ny=16, nz=12, x_max=6.0, y_max=4.0, z_max=3.0)

# name: (the body's geometry, the moving scheme, steps)
CASES = {
    "moving_body": ("cylinder", "penalize", 8),  # tests/test_moving_ibm.py:210
    "moving_ghost": ("cylinder", "ghost", 8),  # :251
    "moving_ghost3d": ("sphere", "ghost", 6),  # :295
    "moving_body3d": ("sphere", "penalize", 6),  # :385
    "stretched_moving_body": ("cylinder_stretched", "penalize", 8),  # :431
    "stretched_moving_ghost": ("cylinder_stretched", "ghost", 8),  # :471
    "stretched3d_moving_body": ("sphere_stretched", "penalize", 6),  # :519
}


def _sphere_faces(pkg):
    """The stretched sphere box's faces (tests/test_moving_ibm.py:519)."""
    sf = pkg.stretched_faces
    return (sf(24, 6.0, refine=[(3.0, 1.0, 1.5)]), sf(16, 4.0, refine=[(2.0, 1.0, 1.5)]),
            sf(12, 3.0, refine=[(1.5, 1.0, 1.5)]))


def build(name, jax_side=False, device="cpu"):
    """(config, single-device step, initial state, body) of a case, from the
    JAX package (jitted step) or the port."""
    geometry, scheme, _ = CASES[name]
    if jax_side:
        import jax
        from cfdsim_tpu import cases, ibm
        from cfdsim_tpu.grid import Grid3D
        from cfdsim_tpu.models import mac3d, mac_stretched, mac_stretched3d

        kw, jit = {}, jax.jit
    else:
        from cfdsim_tpu_torch import cases, ibm
        from cfdsim_tpu_torch.grid import Grid3D
        from cfdsim_tpu_torch.models import mac3d, mac_stretched, mac_stretched3d

        kw, jit = {"device": device}, (lambda f: f)
    if geometry.startswith("cylinder"):
        case = cases.cylinder_oscillating(**OSC, ibm_scheme=scheme,
                                          stretched=geometry.endswith("stretched"),
                                          refine_strength=2.0, **kw)
        return case.cfg, jit(case.step), case.state, case.extras
    body = ibm.oscillating_sphere((3.0, 2.0, 1.5), 0.5, amplitude=0.6, period=3.0)
    if geometry == "sphere":
        cfg = mac3d.MAC3DConfig(grid=Grid3D(**SPHERE_BOX, centering="cell"), nu=0.01,
                                scheme="tvd", dt_max=0.02)
        step = mac3d.make_step(cfg, mac3d.free_slip_bcs3d(), moving_body=body,
                               moving_scheme=scheme, ibm_ramp_steps=2, **kw)
        return cfg, jit(step), mac3d.init_state(cfg, **kw), {"body": body}
    faces = _sphere_faces(mac_stretched)
    cfg = mac_stretched3d.StretchedMAC3DConfig(nx=24, ny=16, nz=12, nu=0.01, scheme="central",
                                               dt_max=0.02)
    step = mac_stretched3d.make_step(cfg, mac3d.free_slip_bcs3d(), *faces, moving_body=body,
                                     ibm_ramp_steps=2, **kw)
    return cfg, jit(step), mac_stretched3d.init_state(cfg, **kw), {"body": body,
                                                                    "faces": faces}


def _trim(state):
    """The trimmed faces of a 2D or 3D MAC state, as numpy."""
    u, v = np.asarray(state.u), np.asarray(state.v)
    if u.ndim == 2:
        return {"u": u[:, :-1], "v": v[:-1, :]}
    return {"u": u[:, :, :-1], "v": v[:, :-1, :], "w": np.asarray(state.w)[:-1]}


def _metrics(m):
    return {k: float(getattr(m, k)) for k in ("dt", "fx", "fy", "fz") if hasattr(m, k)}


def _moving_ranks(mesh):
    from cfdsim_tpu_torch.parallel import (
        gather_state,
        make_moving_body3d_stretched_explicit_step,
        make_moving_body_mac3d_explicit_step,
        make_moving_body_mac_explicit_step,
        make_moving_body_stretched_explicit_step,
        shard_trimmed_state,
        shard_trimmed_state3d,
        trim_state,
        trim_state3d,
    )

    out = {}
    for name, (geometry, scheme, steps) in CASES.items():
        cfg, _, state, extras = build(name)
        body = extras["body"]
        if geometry == "cylinder":
            step = make_moving_body_mac_explicit_step(cfg, mesh, body, moving_scheme=scheme)
        elif geometry == "cylinder_stretched":
            step = make_moving_body_stretched_explicit_step(cfg, mesh, extras["x_faces"],
                                                            extras["y_faces"], body,
                                                            moving_scheme=scheme)
        elif geometry == "sphere":
            step = make_moving_body_mac3d_explicit_step(cfg, mesh, body, ibm_ramp_steps=2,
                                                        moving_scheme=scheme)
        else:
            step = make_moving_body3d_stretched_explicit_step(cfg, mesh, *extras["faces"], body,
                                                              ibm_ramp_steps=2)
        if state.u.ndim == 2:
            t = shard_trimmed_state(trim_state(state), mesh)
        else:
            t = shard_trimmed_state3d(trim_state3d(state), mesh)
        for _ in range(steps):
            t, m = step(t, 1.0)
        g = gather_state(t, mesh)
        out[name] = dict({k: getattr(g, k).numpy() for k in ("u", "v", "w") if hasattr(g, k)},
                         metrics=_metrics(m))
    return out


@pytest.fixture(scope="module")
def results():
    from test_torch_mac3d_explicit import spawn_beside

    return spawn_beside(_moving_ranks,
                        local=lambda: {name: _single(name, jax_side=True) for name in CASES})


def _single(name, jax_side):
    import jax.numpy as jnp

    _, step, s, _ = build(name, jax_side)
    for _ in range(CASES[name][2]):
        s, m = step(s, jnp.float32(1.0) if jax_side else 1.0)
    return dict(_trim(s), metrics=_metrics(m))


@pytest.mark.parametrize("name", list(CASES))
def test_moving_explicit_matches_single_device(results, name):
    """The moving body's masks (or ghost faces) rebuilt on each rank from the
    device-side t, the body force summed over the mesh: u, v (w) 2e-5, the
    forces (2e-4, 1e-6), dt 1e-5 of the JAX package's and the port's
    single-device steps."""
    got = results["ranks"][name]
    for ref in (results["jax"][name], _single(name, jax_side=False)):
        for k in ("u", "v", "w"):
            if k in got:
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5, err_msg=k)
        m, mr = got["metrics"], ref["metrics"]
        np.testing.assert_allclose(m["dt"], mr["dt"], rtol=1e-5)
        for k in ("fx", "fy", "fz"):
            if k in mr:
                np.testing.assert_allclose(m[k], mr[k], rtol=2e-4, atol=1e-6, err_msg=k)
    if CASES[name][1] == "ghost":
        assert abs(got["metrics"]["fx"]) > 1e-5  # a real force signal


@pytest.mark.parametrize("delta,dx,dy", [(0.375, 0.25, 0.25), (0.1, 0.05, 0.08),
                                         (0.3, 0.3, 0.2)])
def test_moving_ghost_width_matches_jax(delta, dx, dy):
    from cfdsim_tpu.parallel.ibm_ghost_explicit import moving_ghost_width_2d as jax_width

    from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import moving_ghost_width_2d

    assert moving_ghost_width_2d(delta, dx, dy) == jax_width(delta, dx, dy)


def test_moving_ghost_refuses_blocks_narrower_than_its_window():
    """The moving ghost's window must fit in a neighbour's block."""
    from test_torch_mac3d_explicit import _fake_mesh

    cfg, _, _, extras = build("moving_ghost")
    from cfdsim_tpu_torch.parallel.mac_explicit import make_moving_body_mac_explicit_step

    with pytest.raises(ValueError, match="moving-ghost halo width"):
        make_moving_body_mac_explicit_step(cfg, _fake_mesh(8, 1), extras["body"],
                                           moving_scheme="ghost")
