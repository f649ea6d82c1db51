"""The stretched MAC step on gloo ranks (``cfdsim_tpu_torch/parallel/mac_stretched_explicit.py``:
metric coefficients by global index, the distributed FDM projection)
against the JAX package's single-device step and the port's own, from the
same seeded numpy inputs: the twins of tests/test_mac_stretched_explicit.py
with their tolerances, its topology test over (1, 4), (4, 1) and (2, 2) on
4 ranks, where the JAX test has 8 devices.

One group of ranks runs every case (``_stretched_ranks``); rank 0 returns
the gathered trimmed states and the last metrics. JAX is imported inside
the tests: the ranks import this module for their function and need torch
alone.
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)
TOPOLOGIES = [(1, 4), (4, 1), (2, 2)]
CYLINDER = dict(nx=64, ny=32, Re=100.0, scheme="tvd", domain=(24.0, 8.0), center=(8.0, 4.0),
                radius=0.75, ibm_ramp_steps=10, perturb_ramp_steps=10, warmup_steps=2,
                warmup_dt=1e-4)

# name: (case builder, its keywords, seed of the initial fields, steps)
CASES = {
    "central": ("cavity_stretched", dict(n=32, Re=100.0, beta=1.5, scheme="central"), 0, 5),
    "tvd": ("cavity_stretched", dict(n=32, Re=400.0, beta=1.8, scheme="tvd"), 1, 5),
    "upwind": ("cavity_stretched", dict(n=32, Re=400.0, beta=1.3, scheme="upwind"), 2, 5),
    "topology": ("cavity_stretched", dict(n=32, Re=100.0, beta=1.5, scheme="central"), 4, 3),
    "cylinder": ("cylinder_stretched", CYLINDER, None, 5),
}


def initial_fields(name, state):
    """The case's state, or the JAX test's seeded random faces (float32)."""
    seed = CASES[name][2]
    u, v = np.asarray(state.u, np.float32), np.asarray(state.v, np.float32)
    if seed is None:
        return {"u": u, "v": v}
    rng = np.random.default_rng(seed)
    return {"u": (0.1 * rng.standard_normal(u.shape)).astype(np.float32),
            "v": (0.1 * rng.standard_normal(v.shape)).astype(np.float32)}


def _metrics(m):
    return {k: float(getattr(m, k)) for k in ("dt", "energy", "max_vel", "vort_max", "div_post",
                                              "fx", "fy")}


def _run(mesh, name):
    from cfdsim_tpu_torch import cases
    from cfdsim_tpu_torch.parallel.mac_explicit import trim_face_masks
    from cfdsim_tpu_torch.parallel.mac_sharded import shard_trimmed_state, trim_state
    from cfdsim_tpu_torch.parallel.mac_stretched_explicit import (
        make_cavity_stretched_explicit_step,
        make_cylinder_stretched_explicit_step,
    )
    from cfdsim_tpu_torch.parallel.mesh import gather_state, local_block

    builder, kw, _, steps = CASES[name]
    case = getattr(cases, builder)(device="cpu", **kw)
    ex = case.extras
    state = case.state._replace(**{k: torch.as_tensor(v) for k, v in
                                   initial_fields(name, case.state).items()})
    extras = ()
    if name == "cylinder":
        step = make_cylinder_stretched_explicit_step(case.cfg, mesh, ex["x_faces"],
                                                     ex["y_faces"], v_inf=1.0,
                                                     perturb_ramp_steps=10, ibm_ramp_steps=10)
        extras = tuple(local_block(m, mesh) for m in trim_face_masks(ex["ibm_mask_u"],
                                                                      ex["ibm_mask_v"]))
    else:
        step = make_cavity_stretched_explicit_step(case.cfg, mesh, ex["x_faces"], ex["y_faces"])
    t = shard_trimmed_state(trim_state(state), mesh)
    for _ in range(steps):
        t, m = step(t, 1.0, *extras)
    g = gather_state(t, mesh)
    return {"u": g.u.numpy(), "v": g.v.numpy(), "p": g.p.numpy(), "metrics": _metrics(m)}


def _stretched_ranks(mesh):
    from cfdsim_tpu_torch.parallel.mesh import make_grid_mesh

    out = {name: _run(mesh, name) for name in ("central", "tvd", "upwind", "cylinder")}
    for topo in TOPOLOGIES:
        out[("topology", topo)] = _run(make_grid_mesh(topo), "topology")
    return out


@pytest.fixture(scope="module")
def results():
    from test_torch_mac3d_explicit import spawn_beside

    return spawn_beside(_stretched_ranks,
                        local=lambda: {name: _single(name, jax_side=True) for name in CASES})


def _single(name, jax_side):
    """The single-device run of a case: the JAX package's (jitted) or the
    port's, from the same initial fields."""
    from cfdsim_tpu_torch import cases as port_cases

    builder, kw, _, steps = CASES[name]
    port = getattr(port_cases, builder)(device="cpu", **kw)
    fields = initial_fields(name, port.state)
    if jax_side:
        import jax
        import jax.numpy as jnp
        from cfdsim_tpu import cases as jcases

        case = getattr(jcases, builder)(**kw)
        s = case.state._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
        step, cfl = jax.jit(case.step), jnp.float32(1.0)
    else:
        s = port.state._replace(**{k: torch.as_tensor(v) for k, v in fields.items()})
        step, cfl = port.step, 1.0
    for _ in range(steps):
        s, m = step(s, cfl)
    return {"u": np.asarray(s.u)[:, :-1], "v": np.asarray(s.v)[:-1, :], "p": np.asarray(s.p),
            "metrics": _metrics(m)}


def _assert_equal(got, ref, atol=2e-5):
    """tests/test_mac_stretched_explicit.py::_assert_equal."""
    np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["v"], ref["v"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["p"], ref["p"], rtol=0, atol=10 * atol)
    m, mr = got["metrics"], ref["metrics"]
    np.testing.assert_allclose(m["dt"], mr["dt"], rtol=1e-6)
    np.testing.assert_allclose(m["energy"], mr["energy"], rtol=1e-5)
    np.testing.assert_allclose(m["max_vel"], mr["max_vel"], rtol=1e-5)
    np.testing.assert_allclose(m["vort_max"], mr["vort_max"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["central", "tvd", "upwind"])
def test_stretched_explicit_cavity_matches(results, name):
    got = results["ranks"][name]
    for ref in (results["jax"][name], _single(name, jax_side=False)):
        _assert_equal(got, ref)
    if name == "central":
        assert got["metrics"]["div_post"] < 1e-3  # the exact distributed FDM projection


def test_stretched_explicit_cylinder_matches(results):
    """The external flow on the stretched grid, with the face-sampled IBM
    and its volume-weighted force."""
    got = results["ranks"]["cylinder"]
    for ref in (results["jax"]["cylinder"], _single("cylinder", jax_side=False)):
        _assert_equal(got, ref)
        for k in ("fx", "fy"):
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-4,
                                       atol=1e-6)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_stretched_explicit_other_topologies(results, topo):
    got = results["ranks"][("topology", topo)]
    for ref in (results["jax"]["topology"], _single("topology", jax_side=False)):
        np.testing.assert_allclose(got["u"], ref["u"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["v"], ref["v"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["metrics"]["energy"], ref["metrics"]["energy"], rtol=1e-5)
