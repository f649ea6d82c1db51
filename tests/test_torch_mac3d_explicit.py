"""The 3D steps on gloo ranks (``cfdsim_tpu_torch/parallel/mac3d_explicit.py``,
``mac_stretched3d_explicit.py``, ``transport3d_explicit.py``,
``boussinesq3d_explicit.py``) against the JAX package's single-device steps
and the port's own, from the same seeded numpy inputs: the twins of
tests/test_mac3d_explicit.py with their grids, step counts and tolerances
(on a 2×2 mesh of 4 ranks, where the JAX tests have 2×4 devices), of the
explicit rows of tests/test_boussinesq.py (:159, the heated cube),
tests/test_transport3d.py (:118 and :178, the heated spheres) and
tests/test_les_dynamic.py (:209), and one test of each refusal of
``make_mac3d_explicit_step``. The 3D cavity is also held against the JAX
package's own explicit step on a 2×2 mesh of 4 of its virtual CPU devices.

One group of ranks runs every case (``_ranks``); rank 0 returns the
gathered trimmed states and the last metrics. The case table and the
runners here also serve tests/test_torch_ghost_explicit.py. JAX is
imported inside the tests: the ranks import this module for their function
and need torch alone.
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)


def _sphere(**kw):
    return dict(nx=32, ny=16, nz=16, domain=(8.0, 4.0, 4.0), center=(2.0, 2.0, 2.0),
                ibm_ramp_steps=4, **kw)


STRETCH = dict(refine_strength=1.5, refine_width=1.0, wake_length=2.0)

# name: (case builder, its keywords, initial fields, steps, distributed step)
CASES = {
    # tests/test_mac3d_explicit.py
    "cavity": ("cavity3d_mac", dict(n=16, Re=100.0), ("noise", 0), 4, "cavity"),
    "upwind": ("cavity3d_mac", dict(n=16, Re=500.0, scheme="upwind"), ("noise", 1), 4, "cavity"),
    "tvd": ("cavity3d_mac", dict(n=16, Re=500.0, scheme="tvd"), ("noise", 1), 4, "cavity"),
    "central_les": ("cavity3d_mac", dict(n=16, Re=500.0, scheme="central", use_les=True),
                    ("noise", 1), 4, "cavity"),
    "tvd_les": ("cavity3d_mac", dict(n=16, Re=500.0, scheme="tvd", use_les=True), ("noise", 1),
                4, "cavity"),
    "stretched": ("cavity3d_stretched", dict(n=16, Re=100.0, beta=1.5), ("noise", 1), 4,
                  "cavity_stretched"),
    "sphere_central": ("sphere_mac3d", _sphere(Re=100.0, scheme="central"), None, 6, "sphere"),
    "sphere_tvd": ("sphere_mac3d", _sphere(Re=100.0, scheme="tvd"), None, 6, "sphere"),
    "sphere_stretched": ("sphere_stretched", _sphere(Re=100.0, scheme="central", **STRETCH),
                         None, 6, "sphere_stretched"),
    "dynamic": ("cavity3d_mac", dict(n=16, Re=2000.0, scheme="central", use_les=True,
                                     les_model="dynamic"), ("multimode", 7), 4, "cavity"),
    "sphere_dynamic": ("sphere_mac3d", _sphere(Re=500.0, scheme="tvd", use_les=True,
                                               les_model="dynamic"),
                       ("modes", 33, (51, 52, 53)), 4, "sphere"),
    "stretched_les_smagorinsky": ("cavity3d_stretched", dict(n=16, Re=2000.0, beta=1.5,
                                                             use_les=True,
                                                             les_model="smagorinsky"),
                                  ("multimode", 3), 4, "cavity_stretched"),
    "stretched_les_dynamic": ("cavity3d_stretched", dict(n=16, Re=2000.0, beta=1.5, use_les=True,
                                                         les_model="dynamic"),
                              ("multimode", 3), 4, "cavity_stretched"),
    # tests/test_boussinesq.py:159, tests/test_transport3d.py:118, :178
    "heated_cube": ("heated_cube", dict(n=16, Ra=1e4), None, 30, "heated_cube"),
    "heated_sphere": ("heated_sphere", _sphere(Re=100.0, scheme="tvd"), None, 6,
                      "heated_sphere"),
    "heated_sphere_stretched": ("heated_sphere_stretched",
                                _sphere(Re=100.0, scheme="central", **STRETCH), None, 6,
                                "heated_sphere_stretched"),
    # tests/test_ghost_explicit.py
    "ghost_sphere": ("sphere_mac3d", _sphere(Re=100.0, scheme="tvd", ibm_scheme="ghost"), None,
                     6, "sphere_ghost"),
    "ghost_sphere_stretched": ("sphere_stretched", _sphere(Re=100.0, scheme="central",
                                                           ibm_scheme="ghost", **STRETCH),
                               None, 6, "sphere_ghost_stretched"),
    "ghost_heated_sphere": ("heated_sphere", _sphere(Re=100.0, scheme="tvd", ibm_scheme="ghost"),
                            None, 6, "heated_sphere"),
    "ghost_heated_sphere_stretched": ("heated_sphere_stretched",
                                      _sphere(Re=100.0, scheme="central", ibm_scheme="ghost",
                                              **STRETCH), None, 6, "heated_sphere_stretched"),
    "ghost_dynamic": ("sphere_mac3d", _sphere(Re=500.0, scheme="tvd", ibm_scheme="ghost",
                                              use_les=True, les_model="dynamic"),
                      ("modes", 11, (21, 22, 23)), 4, "sphere_ghost"),
    "ghost_stretched_les_smagorinsky": ("sphere_stretched", _sphere(
        Re=2000.0, scheme="central", ibm_scheme="ghost", use_les=True,
        les_model="smagorinsky", **STRETCH), ("modes", 29, (61, 62, 63)), 4,
        "sphere_ghost_stretched"),
    "ghost_stretched_les_dynamic": ("sphere_stretched", _sphere(
        Re=2000.0, scheme="central", ibm_scheme="ghost", use_les=True, les_model="dynamic",
        **STRETCH), ("modes", 29, (61, 62, 63)), 4, "sphere_ghost_stretched"),
}
MAC3D_CASES = [k for k in CASES if not k.startswith("ghost_")]


def _modes(shape, sd, rng, amp=0.3):
    """The JAX tests' low-k multi-mode field plus noise from ``rng``."""
    r = np.random.default_rng(sd)
    z = (np.arange(shape[0]) + 0.5) / shape[0]
    y = (np.arange(shape[1]) + 0.5) / shape[1]
    x = (np.arange(shape[2]) + 0.5) / shape[2]
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    out = np.zeros(shape)
    for k in range(1, 6):
        out += (amp / k) * (np.sin(2 * np.pi * k * X + r.uniform(0, 6))
                            * np.cos(2 * np.pi * k * Y + r.uniform(0, 6))
                            * np.cos(2 * np.pi * k * Z + r.uniform(0, 6)))
    return out + 0.03 * rng.standard_normal(shape)


def _multimode_faces(n, seed, amp=0.5, noise=0.05):
    """tests/test_mac3d_explicit.py::_multimode_faces (numpy float32)."""
    rng = np.random.default_rng(seed)

    def f(shape, sd):
        r = np.random.default_rng(sd)
        zc = (np.arange(shape[0]) + 0.5) / n
        yc = (np.arange(shape[1]) + 0.5) / n
        xc = (np.arange(shape[2]) + 0.5) / n
        z, y, x = np.meshgrid(zc, yc, xc, indexing="ij")
        out = np.zeros(shape)
        for k in range(1, 6):
            out += (amp / k) * (np.sin(2 * np.pi * k * x + r.uniform(0, 6))
                                * np.cos(2 * np.pi * k * y + r.uniform(0, 6))
                                * np.cos(2 * np.pi * k * z + r.uniform(0, 6)))
        return (out + noise * rng.standard_normal(shape)).astype(np.float32)

    return (f((n, n, n + 1), seed + 10), f((n, n + 1, n), seed + 20),
            f((n + 1, n, n), seed + 30))


def _fields(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in ("u", "v", "w", "theta")
            if hasattr(state, k)}


def initial_fields(name, state) -> dict:
    """The numpy float32 initial fields of a case: its own state, or the JAX
    test's seeded fields (computed in float32 as there)."""
    init = CASES[name][2]
    out = {k: np.asarray(v, np.float32) for k, v in _fields(state).items()}
    if init is None:
        return out
    u, v, w = out["u"], out["v"], out["w"]
    if init[0] == "noise":
        rng = np.random.default_rng(init[1])
        u, v, w = ((0.1 * rng.standard_normal(a.shape)).astype(np.float32) for a in (u, v, w))
    elif init[0] == "multimode":
        u, v, w = _multimode_faces(u.shape[0], init[1])
    else:
        rng = np.random.default_rng(init[1])
        u, v, w = (a + _modes(a.shape, sd, rng).astype(np.float32)
                   for a, sd in zip((u, v, w), init[2]))
    return dict(out, u=u, v=v, w=w)


def port_case(name, device="cpu"):
    """The port's case and its initial state (torch, on ``device``)."""
    from cfdsim_tpu_torch import cases

    builder, kw, _, _, _ = CASES[name]
    case = getattr(cases, builder)(device=device, **kw)
    fields = initial_fields(name, case.state)
    state = case.state._replace(**{k: torch.as_tensor(v, device=device)
                                   for k, v in fields.items()})
    return case, state


def distributed_step(name, case, mesh):
    """(the distributed step of a case, its call-time extras as global numpy
    fields)."""
    from cfdsim_tpu_torch.parallel import mac3d_explicit as m3e
    from cfdsim_tpu_torch.parallel import mac_stretched3d_explicit as s3e
    from cfdsim_tpu_torch.parallel.boussinesq3d_explicit import make_heated_cube_explicit_step
    from cfdsim_tpu_torch.parallel.transport3d_explicit import (
        make_heated_sphere_explicit_step,
        make_heated_sphere_stretched_explicit_step,
    )

    kind = CASES[name][4]
    ex = case.extras
    faces = tuple(ex.get(k) for k in ("x_faces", "y_faces", "z_faces"))
    ramp = CASES[name][1].get("ibm_ramp_steps", 0)
    ghost = {"ghost": ex["ibm_ghost"], "ghost_c": ex["ibm_ghost_c"]} if "ibm_ghost_c" in ex else {}
    if kind == "cavity":
        return m3e.make_cavity3d_mac_explicit_step(case.cfg, mesh), ()
    if kind == "cavity_stretched":
        return s3e.make_cavity3d_stretched_explicit_step(case.cfg, mesh, *faces), ()
    if kind == "sphere":
        return (m3e.make_sphere_mac3d_explicit_step(case.cfg, mesh, v_inf=1.0,
                                                    ibm_ramp_steps=ramp),
                m3e.trim_face_masks3d(*ex["ibm_masks"]))
    if kind == "sphere_stretched":
        return (s3e.make_sphere3d_stretched_explicit_step(case.cfg, mesh, *faces, v_inf=1.0,
                                                          ibm_ramp_steps=ramp),
                m3e.trim_face_masks3d(*ex["ibm_masks"]))
    if kind == "sphere_ghost":
        return m3e.make_sphere_ghost_mac3d_explicit_step(case.cfg, mesh, ex["ibm_ghost"],
                                                         v_inf=1.0, ibm_ramp_steps=ramp), ()
    if kind == "sphere_ghost_stretched":
        return s3e.make_sphere_ghost3d_stretched_explicit_step(
            case.cfg, mesh, *faces, ex["ibm_ghost"], v_inf=1.0, ibm_ramp_steps=ramp), ()
    if kind == "heated_cube":
        return make_heated_cube_explicit_step(case.cfg, mesh), ()
    if kind == "heated_sphere":
        step = make_heated_sphere_explicit_step(case.cfg, mesh, v_inf=1.0, ibm_ramp_steps=ramp,
                                                **ghost)
    else:
        step = make_heated_sphere_stretched_explicit_step(case.cfg, mesh, *faces, v_inf=1.0,
                                                          ibm_ramp_steps=ramp, **ghost)
    if ghost:
        return step, ()
    mu, mv, mw, mc = ex["ibm_masks"]
    return step, (*m3e.trim_face_masks3d(mu, mv, mw), np.asarray(mc, np.float32))


def metrics_dict(m):
    return {k: float(getattr(m, k)) for k in m._fields}


def trimmed(fields: dict) -> dict:
    out = dict(fields)
    out["u"], out["v"], out["w"] = fields["u"][:, :, :-1], fields["v"][:, :-1, :], fields["w"][:-1]
    return out


def run_distributed(name, mesh):
    """A case's steps on the mesh: the gathered trimmed fields and p, and the
    last metrics."""
    from cfdsim_tpu_torch.parallel.mac3d_explicit import shard_trimmed_state3d, trim_state3d
    from cfdsim_tpu_torch.parallel.mesh import gather_state, local_block

    case, state = port_case(name)
    step, extras = distributed_step(name, case, mesh)
    extras = tuple(local_block(x, mesh) for x in extras)
    t = shard_trimmed_state3d(trim_state3d(state), mesh)
    for _ in range(CASES[name][3]):
        t, m = step(t, 1.0, *extras)
    g = gather_state(t, mesh)
    return dict(_fields(g), p=g.p.numpy(), metrics=metrics_dict(m))


def run_port_single(name):
    """The port's single-device step: the trimmed fields, p and metrics."""
    case, s = port_case(name)
    for _ in range(CASES[name][3]):
        s, m = case.step(s, 1.0)
    return dict(trimmed(_fields(s)), p=s.p.numpy(), metrics=metrics_dict(m))


def run_jax_single(name):
    """The JAX package's single-device step (jitted) from the same numpy
    initial fields: the trimmed fields, p and metrics."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu import cases as jcases

    builder, kw, _, steps, _ = CASES[name]
    case = getattr(jcases, builder)(**kw)
    port, _ = port_case(name)
    fields = initial_fields(name, port.state)
    s = case.state._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    step = jax.jit(case.step)
    for _ in range(steps):
        s, m = step(s, jnp.float32(1.0))
    return dict(trimmed(_fields(s)), p=np.asarray(s.p), metrics=metrics_dict(m))


def _ranks(mesh, names, develops=False):
    from cfdsim_tpu_torch.cases import cavity3d_mac
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.parallel.mac3d_explicit import (
        make_cavity3d_mac_explicit_step,
        shard_trimmed_state3d,
        trim_state3d,
    )
    from cfdsim_tpu_torch.parallel.mesh import gather_state

    out = {name: run_distributed(name, mesh) for name in names}
    if develops:
        # 30 steps from rest in one chunk (the loop route): the lid-driven
        # flow develops, divergence-free, bounded
        case = cavity3d_mac(n=16, Re=400.0, device="cpu")
        chunk = make_chunk(case.cfg, make_cavity3d_mac_explicit_step(case.cfg, mesh), 30)
        t, m = chunk(shard_trimmed_state3d(trim_state3d(case.state), mesh), 1.0)
        out["develops"] = {"finite": bool(torch.isfinite(gather_state(t, mesh).u).all()),
                           "route": chunk.mode, "div_post": m.div_post.numpy(),
                           "energy": m.energy.numpy(), "max_vel": m.max_vel.numpy()}
    return out


def spawn_beside(fn, *args, local=dict):
    """Run ``fn`` on a group of 4 gloo ranks (2×2) while this process runs
    ``local()`` (the JAX package's references, whose compiles would
    otherwise follow the group's run): {"ranks": rank 0's result, "jax":
    what ``local`` returned}."""
    from concurrent.futures import ThreadPoolExecutor

    from cfdsim_tpu_torch.parallel.launch import spawn

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, fn, 4, TOPOLOGY, *args, device="cpu")
        here = local()
        return {"ranks": ranks.result(), "jax": here}


@pytest.fixture(scope="module")
def results():
    return spawn_beside(_ranks, MAC3D_CASES, True,
                        local=lambda: {name: run_jax_single(name) for name in MAC3D_CASES})


def assert_close(got, ref, atol, p_atol=None, rtol_dt=1e-6, **metric_tols):
    """The fields within ``atol`` (p within ``p_atol``), dt within
    ``rtol_dt``, and each named metric within its (rtol, atol)."""
    for k in ("u", "v", "w", "theta"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
    if p_atol is not None:
        np.testing.assert_allclose(got["p"], ref["p"], rtol=0, atol=p_atol, err_msg="p")
    m, mr = got["metrics"], ref["metrics"]
    np.testing.assert_allclose(m["dt"], mr["dt"], rtol=rtol_dt, err_msg="dt")
    for k, (rtol, atol_m) in metric_tols.items():
        np.testing.assert_allclose(m[k], mr[k], rtol=rtol, atol=atol_m, err_msg=k)


def check_twins(results, name, *args, **kwargs):
    """The distributed run against the JAX package's and the port's
    single-device runs, at the same tolerances."""
    got = results["ranks"][name]
    assert_close(got, results["jax"][name], *args, **kwargs)
    assert_close(got, run_port_single(name), *args, **kwargs)
    return got


def test_mac3d_explicit_matches_single_device(results):
    got = check_twins(results, "cavity", 2e-5, 2e-4, energy=(1e-5, 0.0), max_vel=(1e-5, 0.0),
                      vort_max=(1e-4, 1e-4))
    assert got["metrics"]["div_post"] < 1e-3  # the exact distributed 3D projection


def test_mac3d_explicit_matches_jax_explicit_on_a_2x2_mesh(results):
    """The JAX package's own explicit 3D step on 4 of its virtual devices."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.cases import cavity3d_mac
    from cfdsim_tpu.parallel.mac3d_explicit import (
        make_cavity3d_mac_explicit_step,
        shard_trimmed_state3d,
        trim_state3d,
    )
    from cfdsim_tpu.parallel.mesh import make_grid_mesh

    case = cavity3d_mac(n=16, Re=100.0)
    port, _ = port_case("cavity")
    s = case.state._replace(**{k: jnp.asarray(v)
                               for k, v in initial_fields("cavity", port.state).items()})
    mesh = make_grid_mesh(4, topology=TOPOLOGY)
    step = make_cavity3d_mac_explicit_step(case.cfg, mesh)
    t = shard_trimmed_state3d(trim_state3d(s), mesh)
    for _ in range(CASES["cavity"][3]):
        t, m = step(t, jnp.float32(1.0))
    got = results["ranks"]["cavity"]
    for k in ("u", "v", "w"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(t, k)), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["p"], np.asarray(t.p), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["metrics"]["energy"], float(m.energy), rtol=1e-5)


@pytest.mark.parametrize("name", ["upwind", "tvd", "central_les", "tvd_les"])
def test_mac3d_explicit_schemes_les_match_single_device(results, name):
    """The width-2 window path: upwind and MUSCL advection and the
    Smagorinsky LES (its ν_t mean a sum over the mesh: equal to rounding)."""
    check_twins(results, name, 3e-5, 3e-4, rtol_dt=1e-5, energy=(1e-5, 0.0))


def test_mac3d_explicit_cavity_develops(results):
    dev = results["ranks"]["develops"]
    assert dev["finite"] and dev["route"] == "loop"
    assert float(dev["div_post"][-1]) < 1e-3
    assert 0.0 < float(dev["energy"][-1]) < 0.5
    assert float(dev["max_vel"][-1]) <= 1.0 + 1e-3


def test_mac3d_stretched_explicit_matches_single_device(results):
    got = check_twins(results, "stretched", 3e-5, energy=(1e-5, 0.0), vort_max=(1e-4, 1e-4))
    assert got["metrics"]["div_post"] < 5e-3  # the exact distributed FDM projection


@pytest.mark.parametrize("scheme", ["central", "tvd"])
def test_sphere_explicit_matches_single_device(results, scheme):
    """External-flow BCs (the mass-consistent outflow's shift summed over
    the mesh) and the 3D penalization, forces included."""
    got = check_twins(results, f"sphere_{scheme}", 2e-5, 2e-4, fx=(1e-4, 1e-6), fy=(1e-4, 1e-6),
                      fz=(1e-4, 1e-6), max_vel=(1e-5, 0.0))
    assert got["metrics"]["fx"] > 0.0


def test_sphere_stretched_explicit_matches_single_device(results):
    got = check_twins(results, "sphere_stretched", 3e-5, 3e-4, fx=(2e-4, 1e-6), fy=(2e-4, 1e-6),
                      fz=(2e-4, 1e-6))
    assert got["metrics"]["fx"] > 0.0


def _cs2_engaged(name):
    """The dynamic coefficient the single-device step computes from the
    case's initial fields (the guard that the contraction engages)."""
    from cfdsim_tpu_torch.models.mac3d import center_velocities_3d
    from cfdsim_tpu_torch.models.mac_stretched import _metrics
    from cfdsim_tpu_torch.ops.les_dynamic import dynamic_cs2_3d, ibm_fluid_mask_centers

    case, s = port_case(name)
    uc, vc, wc = center_velocities_3d(s.u, s.v, s.w)
    if "z_faces" in case.extras:
        mx, my, mz = (_metrics(case.extras[k]) for k in ("x_faces", "y_faces", "z_faces"))

        def g2(m, shape):
            xg = np.concatenate([[m.xc[0]], m.xc, [m.xc[-1]]])
            return torch.tensor((1.0 / (xg[2:] - xg[:-2])).reshape(shape), dtype=torch.float32)

        d2 = torch.tensor((mz.h[:, None, None] * my.h[None, :, None] * mx.h[None, None, :])
                          ** (2.0 / 3.0), dtype=torch.float32)
        return float(dynamic_cs2_3d(uc, vc, wc, g2(mx, (1, 1, -1)), g2(my, (1, -1, 1)),
                                    g2(mz, (-1, 1, 1)), d2))
    dx = case.cfg.grid.dx
    masks = case.extras.get("ibm_masks")
    fluid = ibm_fluid_mask_centers(*masks) if masks is not None else None
    if "ibm_ghost" in case.extras:
        fluid = ibm_fluid_mask_centers(ibm_ghost=case.extras["ibm_ghost"])
    return float(dynamic_cs2_3d(uc, vc, wc, 0.5 / dx, 0.5 / dx, 0.5 / dx, dx * dx, mask=fluid))


def test_mac3d_explicit_dynamic_les_matches_single_device(results):
    """Dynamic Germano–Lilly LES: width-3 face halos, the volume-averaged
    C_s² one sum over the mesh (equal to float32 partial-sum rounding)."""
    assert _cs2_engaged("dynamic") > 1e-5
    check_twins(results, "dynamic", 5e-5, 5e-4, rtol_dt=1e-5, energy=(1e-5, 0.0))


def test_sphere_explicit_dynamic_les_matches_single_device(results):
    """The penalized sphere with dynamic LES: the body's cells leave the
    contraction through halo-exchanged blocks of the trimmed masks."""
    assert _cs2_engaged("sphere_dynamic") > 1e-5
    check_twins(results, "sphere_dynamic", 5e-5, 5e-4, rtol_dt=1e-5)


@pytest.mark.parametrize("les_model", ["smagorinsky", "dynamic"])
def test_mac3d_stretched_explicit_les_matches_single_device(results, les_model):
    name = f"stretched_les_{les_model}"
    if les_model == "dynamic":
        assert _cs2_engaged(name) > 1e-5
    check_twins(results, name, 5e-5, rtol_dt=1e-5, energy=(1e-5, 0.0))


def test_heated_cube_explicit_sharded_matches(results):
    """tests/test_boussinesq.py:159: trimmed faces, θ halos, the 3D DCT."""
    check_twins(results, "heated_cube", 5e-5, energy=(1e-5, 0.0), nu_hot_wall=(1e-4, 0.0),
                nu_mid=(1e-3, 1e-4))


@pytest.mark.parametrize("name", ["heated_sphere", "heated_sphere_stretched"])
def test_heated_sphere_explicit_matches_single_device(results, name):
    """tests/test_transport3d.py:118 and :178: the momentum step composed
    with θ's fluxes, the heat flux summed over the mesh."""
    got = check_twins(results, name, 2e-5, rtol_dt=1e-5, nusselt=(2e-4, 0.0), fx=(2e-4, 1e-6),
                      theta_max=(1e-4, 0.0))
    assert got["metrics"]["nusselt"] != 0.0


def _fake_mesh(py, px):
    """A (py, px) mesh seen from rank 0 with no process group: enough to
    build a step, which calls no collective until it runs."""
    from cfdsim_tpu_torch.parallel.mesh import GridMesh

    return GridMesh(py, px, 0, "gloo", "cpu", None, None)


def test_dynamic_les_model_builds_on_sharded_step():
    """tests/test_les_dynamic.py:209: the distributed step takes
    les_model="dynamic"."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.parallel.mac3d_explicit import make_cavity3d_mac_explicit_step

    cfg = mac3d.MAC3DConfig(grid=Grid3D(nx=16, ny=16, nz=16, centering="cell"), nu=1e-3,
                            use_les=True, les_model="dynamic")
    assert make_cavity3d_mac_explicit_step(cfg, _fake_mesh(2, 2)).dynamic


GUARDS = {
    "ghost_and_masks": (dict(), dict(use_ibm=True, ibm_ghost="ghost"), (2, 2),
                        "mutually exclusive"),
    "moving_scheme": (dict(), dict(moving_body="body", moving_scheme="sweep"), (2, 2),
                      "unknown moving_scheme"),
    "not_divisible": (dict(), dict(), (3, 1), "not divisible"),
    "small_blocks": (dict(n=(8, 4, 8)), dict(), (4, 1), "at least 2x2"),
    "poisson": (dict(poisson="sor"), dict(), (2, 2), "unknown 3D poisson method"),
    "scheme": (dict(scheme="quick"), dict(), (2, 2), "unknown MAC3D scheme"),
    "time_scheme": (dict(time_scheme="rk3"), dict(), (2, 2), "unknown MAC3D time scheme"),
    "projection": (dict(projection="pressure"), dict(), (2, 2), "unknown MAC3D projection"),
    "les_model": (dict(use_les=True, les_model="wale"), dict(), (2, 2), "unknown les_model"),
    "dynamic_moving_body": (dict(use_les=True, les_model="dynamic"), dict(moving_body="body"),
                            (2, 2), "does not support moving_body"),
    "dynamic_too_small": (dict(n=(16, 16, 6), use_les=True, les_model="dynamic"), dict(),
                          (2, 2), "too small"),
    "dynamic_narrow_blocks": (dict(n=(8, 8, 8), use_les=True, les_model="dynamic"), dict(),
                              (1, 4), "width-3"),
    "moving_ghost_width": (dict(), dict(moving_body="body", moving_scheme="ghost"), (4, 4),
                           "moving-ghost halo width"),
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_mac3d_explicit_step_refusals(guard):
    """Each refusal of the JAX package's ``make_mac3d_explicit_step``
    (mac3d_explicit.py:510-582) raises in the port (its dynamic-LES guards
    are tests/test_mac3d_explicit.py:328), but three: the port's step takes
    every 3D pressure method, rk2 and the incremental projection
    (tests/test_torch_sharded_options.py), so those cases hold an unknown
    method, time scheme and projection to a refusal."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import oscillating_sphere
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.parallel.mac3d_explicit import (
        cavity3d_local_bcs,
        make_mac3d_explicit_step,
    )
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    cfg_kw, step_kw, topo, match = GUARDS[guard]
    cfg_kw = dict(cfg_kw)
    nx, ny, nz = cfg_kw.pop("n", (16, 16, 16))
    if "poisson" in cfg_kw:
        cfg_kw["poisson"] = Poisson3DConfig(method=cfg_kw["poisson"])
    cfg = mac3d.MAC3DConfig(grid=Grid3D(nx=nx, ny=ny, nz=nz, centering="cell"), nu=1e-3,
                            **cfg_kw)
    if step_kw.get("moving_body") == "body":
        step_kw["moving_body"] = oscillating_sphere((0.5, 0.5, 0.5), 0.2, 0.1, 1.0)
    if step_kw.get("ibm_ghost") == "ghost":
        step_kw["ibm_ghost"] = object()
    with pytest.raises(ValueError, match=match):
        make_mac3d_explicit_step(cfg, _fake_mesh(*topo), cavity3d_local_bcs(nx, ny), **step_kw)


def test_stretched3d_explicit_offers_no_moving_ghost():
    """The JAX package's ``make_stretched3d_explicit_step`` has no moving
    ghost (``moving_scheme``): neither has the port's."""
    from cfdsim_tpu_torch.parallel.mac_stretched3d_explicit import make_stretched3d_explicit_step

    with pytest.raises(TypeError, match="moving_scheme"):
        make_stretched3d_explicit_step(None, None, None, None, None, None,
                                       moving_scheme="ghost")
