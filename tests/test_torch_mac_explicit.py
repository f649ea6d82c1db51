"""The staggered step on gloo ranks (``cfdsim_tpu_torch/parallel/mac_explicit.py``
on the trimmed state of ``mac_sharded.py``) against the JAX package's
single-device MAC step: the twins of tests/test_mac_explicit.py with their
tolerances (its topology test over (1, 4), (4, 1) and (2, 2) on 4 ranks,
where the JAX test has 8 devices), and of the explicit Boussinesq rows of
tests/test_boussinesq.py (:61, the heated cavity; :198, Rayleigh–Bénard).
The TVD cavity is also held against the JAX package's own explicit step on
a 2×2 mesh of 4 of its virtual CPU devices.

One group of ranks runs every case (``_mac_ranks``); rank 0 returns the
gathered trimmed states and the metrics. JAX is imported inside the tests:
the ranks import this module for their function and need torch alone.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)
TOPOLOGIES = [(1, 4), (4, 1), (2, 2)]


def _cavity_kw(name):
    """(lid_cavity_mac keywords, seed, steps) of each cavity case."""
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    dct = PoissonConfig(method="dct")
    return {
        "rbsor": (dict(Re=100.0, scheme="central",
                       poisson=PoissonConfig(method="rbsor", iters=30, omega=1.7)), 0, 5),
        "tvd_dct": (dict(Re=400.0, scheme="tvd", poisson=dct), 1, 5),
        "upwind": (dict(Re=400.0, scheme="upwind", poisson=dct), 2, 5),
        "topology": (dict(Re=100.0, scheme="tvd", poisson=dct), 3, 3),
        "les": (dict(Re=2000.0, scheme="tvd", use_les=True, poisson=dct), 5, 5),
    }[name]


CYLINDER = dict(nx=64, ny=32, Re=100.0, scheme="tvd", domain=(24.0, 8.0), center=(8.0, 4.0),
                radius=0.75, ibm_ramp_steps=10, perturb_ramp_steps=10, warmup_steps=2,
                warmup_dt=1e-4)


def _box_grid():
    from cfdsim_tpu_torch.grid import Grid

    return Grid(nx=32, ny=32, x_max=np.pi, y_max=np.pi, centering="cell")


def _seeded(state, seed, ny, nx):
    if seed is None:
        return state
    rng = np.random.default_rng(seed)
    return state._replace(u=0.1 * rng.standard_normal((ny, nx + 1)),
                          v=0.1 * rng.standard_normal((ny + 1, nx)))


def _metrics(m):
    return {k: float(getattr(m, k)) for k in m._fields}


def _run_trimmed(mesh, step, state, steps, extras=()):
    from cfdsim_tpu_torch.parallel.mac_sharded import shard_trimmed_state, trim_state
    from cfdsim_tpu_torch.parallel.mesh import gather_state

    t = shard_trimmed_state(trim_state(state), mesh)
    for _ in range(steps):
        t, m = step(t, 1.0, *extras)
    g = gather_state(t, mesh)
    return {"u": g.u.numpy(), "v": g.v.numpy(), "p": g.p.numpy(), "metrics": _metrics(m)}


def _port_state(case, seed):
    ny, nx = case.grid.ny, case.grid.nx
    s = _seeded(case.state, seed, ny, nx)
    return s._replace(u=torch.as_tensor(np.asarray(s.u), dtype=torch.float32),
                      v=torch.as_tensor(np.asarray(s.v), dtype=torch.float32))


def _mac_ranks(mesh, snapshot_path):
    from cfdsim_tpu_torch.cases import cylinder_mac, heated_cavity, lid_cavity_mac, rayleigh_benard
    from cfdsim_tpu_torch.models import mac
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.parallel.boussinesq_explicit import (
        make_heated_cavity_explicit_step,
        shard_boussinesq_state,
        trim_boussinesq_state,
    )
    from cfdsim_tpu_torch.parallel.mac_explicit import (
        free_slip_mac_local_bcs,
        make_cavity_mac_explicit_step,
        make_cylinder_mac_explicit_step,
        make_mac_explicit_step,
        trim_face_masks,
    )
    from cfdsim_tpu_torch.parallel.mac_sharded import shard_trimmed_state, trim_state
    from cfdsim_tpu_torch.parallel.mesh import gather_state, local_block, make_grid_mesh
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    out = {}
    for name in ("rbsor", "tvd_dct", "upwind", "les"):
        kw, seed, steps = _cavity_kw(name)
        case = lid_cavity_mac(n=32, device="cpu", **kw)
        out[name] = _run_trimmed(mesh, make_cavity_mac_explicit_step(case.cfg, mesh),
                                 _port_state(case, seed), steps)

    kw, seed, steps = _cavity_kw("topology")
    for topo in TOPOLOGIES:
        m = make_grid_mesh(topo)
        case = lid_cavity_mac(n=32, device="cpu", **kw)
        out[("topology", topo)] = _run_trimmed(m, make_cavity_mac_explicit_step(case.cfg, m),
                                               _port_state(case, seed), steps)

    # the free-slip box (the adjoint example's, unforced), from a seeded state
    cfg = mac.MACConfig(grid=_box_grid(), nu=0.02, poisson=PoissonConfig(method="dct"))
    state = _port_state(SimpleNamespace(grid=cfg.grid, state=mac.init_state(cfg, device="cpu")),
                        4)
    out["free_slip"] = _run_trimmed(
        mesh, make_mac_explicit_step(cfg, mesh, free_slip_mac_local_bcs(32, 32)), state, 5)

    case = cylinder_mac(poisson=PoissonConfig(method="dct"), device="cpu", **CYLINDER)
    masks = tuple(local_block(mk, mesh) for mk in trim_face_masks(
        case.extras["ibm_mask_u"], case.extras["ibm_mask_v"]))
    step = make_cylinder_mac_explicit_step(case.cfg, mesh, v_inf=1.0, perturb_ramp_steps=10,
                                           ibm_ramp_steps=10)
    out["cylinder"] = _run_trimmed(mesh, step, case.state, 5, masks)

    # 200 steps in one chunk (the loop route)
    case = lid_cavity_mac(n=32, Re=100.0, scheme="central", poisson=PoissonConfig(method="dct"),
                          device="cpu")
    chunk = make_chunk(case.cfg, make_cavity_mac_explicit_step(case.cfg, mesh), 200)
    t, m = chunk(shard_trimmed_state(trim_state(case.state), mesh), 1.0)
    out["soak"] = {"finite": bool(torch.isfinite(gather_state(t, mesh).u).all()),
                   "div_post": m.div_post.numpy(), "max_vel": m.max_vel.numpy()}
    out["runner_soak"] = _runner_soak(mesh, snapshot_path)

    for name, case, steps in (("heated_cavity", heated_cavity(n=32, Ra=1e4, device="cpu"), 40),
                              ("rayleigh_benard", rayleigh_benard(ny=16, aspect=2.0, Ra=3000.0,
                                                                  device="cpu"), 40)):
        step = make_heated_cavity_explicit_step(case.cfg, mesh)
        t = shard_boussinesq_state(trim_boussinesq_state(case.state), mesh)
        for _ in range(steps):
            t, m = step(t, 1.0)
        g = gather_state(t, mesh)
        out[name] = {"u": g.u.numpy(), "v": g.v.numpy(), "theta": g.theta.numpy(),
                     "metrics": _metrics(m)}
    return out


def _runner_soak(mesh, snapshot_path):
    """runner.Simulation over the distributed MAC step: 600 steps in chunks
    of 100, snapshots of the trimmed state every 200 steps written on rank 0."""
    from cfdsim_tpu_torch.cases import lid_cavity_mac
    from cfdsim_tpu_torch.parallel.mac_explicit import make_cavity_mac_explicit_step
    from cfdsim_tpu_torch.parallel.mac_sharded import shard_trimmed_state, trim_state
    from cfdsim_tpu_torch.parallel.mesh import gather_state
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    case = lid_cavity_mac(n=32, Re=100.0, scheme="central", poisson=PoissonConfig(method="dct"),
                          device="cpu")
    writer = None
    if mesh.rank == 0:
        from cfdsim_tpu_torch.io_ import SnapshotWriter

        writer = SnapshotWriter(snapshot_path)

    def snapshot(state, step_, t):
        full = gather_state(state, mesh)
        if writer is not None:
            writer.save(step_, t, u=full.u, v=full.v, p=full.p)

    cfg = RunnerConfig(t_final=1e9, max_steps=600, chunk_steps=100, snapshot_interval=200,
                       div_threshold=1e-2, log_every_chunks=0)  # the projection is exact
    sim = Simulation(make_cavity_mac_explicit_step(case.cfg, mesh),
                     shard_trimmed_state(trim_state(case.state), mesh), cfg, 32 * 32, snapshot)
    state, report = sim.run()
    return {"step": int(state.step), "stopped_reason": report["stopped_reason"]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from cfdsim_tpu_torch.parallel.launch import spawn

    path = tmp_path_factory.mktemp("mac_soak") / "mac_soak.h5"
    return spawn(_mac_ranks, 4, TOPOLOGY, str(path), device="cpu"), path


def _jax_pair(name, steps=None):
    """The JAX single-device run of a cavity case: (state, metrics)."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.cases import lid_cavity_mac
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    kw, seed, n_steps = _cavity_kw(name)
    kw = dict(kw, poisson=PoissonConfig(**vars(kw["poisson"])))
    case = lid_cavity_mac(n=32, **kw)
    s = _seeded(case.state, seed, 32, 32)
    s = s._replace(u=jnp.asarray(s.u, jnp.float32), v=jnp.asarray(s.v, jnp.float32))
    step = jax.jit(case.step)
    for _ in range(n_steps if steps is None else steps):
        s, m = step(s, jnp.float32(1.0))
    return s, m


def _assert_equal(got, r, m_ref, atol=1e-5):
    """tests/test_mac_explicit.py::_assert_equal on the trimmed fields."""
    np.testing.assert_allclose(got["u"], np.asarray(r.u)[:, :-1], rtol=0, atol=atol)
    np.testing.assert_allclose(got["v"], np.asarray(r.v)[:-1, :], rtol=0, atol=atol)
    np.testing.assert_allclose(got["p"], np.asarray(r.p), rtol=0, atol=10 * atol)
    m = got["metrics"]
    np.testing.assert_allclose(m["dt"], float(m_ref.dt), rtol=1e-6)
    np.testing.assert_allclose(m["energy"], float(m_ref.energy), rtol=1e-5)
    np.testing.assert_allclose(m["max_vel"], float(m_ref.max_vel), rtol=1e-5)
    np.testing.assert_allclose(m["div_pre"], float(m_ref.div_pre), rtol=1e-3, atol=10 * atol)
    np.testing.assert_allclose(m["vort_max"], float(m_ref.vort_max), rtol=1e-4, atol=1e-4)


def test_mac_explicit_cavity_rbsor_matches(results):
    got = results[0]["rbsor"]
    r, m_ref = _jax_pair("rbsor")
    _assert_equal(got, r, m_ref, atol=1e-6)
    np.testing.assert_allclose(got["metrics"]["poisson_res"], float(m_ref.poisson_res),
                               rtol=1e-3, atol=1e-5)


def test_mac_explicit_cavity_tvd_dct_matches(results):
    got = results[0]["tvd_dct"]
    r, m_ref = _jax_pair("tvd_dct")
    _assert_equal(got, r, m_ref, atol=2e-5)
    assert got["metrics"]["div_post"] < 1e-3  # exact projection across the mesh


def test_mac_explicit_cavity_tvd_dct_matches_jax_explicit_on_a_2x2_mesh(results):
    """The JAX package's own explicit MAC step on 4 of its virtual devices."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.cases import lid_cavity_mac
    from cfdsim_tpu.parallel.mac_explicit import make_cavity_mac_explicit_step
    from cfdsim_tpu.parallel.mac_sharded import shard_trimmed_state, trim_state
    from cfdsim_tpu.parallel.mesh import make_grid_mesh
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    kw, seed, steps = _cavity_kw("tvd_dct")
    kw = dict(kw, poisson=PoissonConfig(method="dct"))
    case = lid_cavity_mac(n=32, **kw)
    s = _seeded(case.state, seed, 32, 32)
    s = s._replace(u=jnp.asarray(s.u, jnp.float32), v=jnp.asarray(s.v, jnp.float32))
    mesh = make_grid_mesh(4, topology=TOPOLOGY)
    step = make_cavity_mac_explicit_step(case.cfg, mesh)
    t = shard_trimmed_state(trim_state(s), mesh)
    for _ in range(steps):
        t, m = step(t, jnp.float32(1.0))
    got = results[0]["tvd_dct"]
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(t, k)), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["p"], np.asarray(t.p), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got["metrics"]["energy"], float(m.energy), rtol=1e-5)


def test_mac_explicit_cavity_upwind_matches(results):
    r, m_ref = _jax_pair("upwind")
    _assert_equal(results[0]["upwind"], r, m_ref, atol=2e-5)


def test_mac_explicit_cylinder_matches(results):
    """The external flow: perturbed inflow, mass-consistent outflow, free
    slip walls, face-sampled IBM and its body-force metrics."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.cases import cylinder_mac
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    case = cylinder_mac(poisson=PoissonConfig(method="dct"), **CYLINDER)
    step = jax.jit(case.step)
    r = case.state
    for _ in range(5):
        r, m_ref = step(r, jnp.float32(1.0))
    got = results[0]["cylinder"]
    _assert_equal(got, r, m_ref, atol=2e-5)
    np.testing.assert_allclose(got["metrics"]["fx"], float(m_ref.fx), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["metrics"]["fy"], float(m_ref.fy), rtol=1e-4, atol=1e-6)


def test_mac_explicit_free_slip_box_matches(results):
    """``free_slip_mac_local_bcs`` against the JAX package's ``free_slip_bcs``
    on the single-device step (the adjoint example's box, unforced)."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.grid import Grid as JGrid
    from cfdsim_tpu.models import mac as jmac
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    cfg = jmac.MACConfig(grid=JGrid(nx=32, ny=32, x_max=np.pi, y_max=np.pi, centering="cell"),
                         nu=0.02, poisson=PoissonConfig(method="dct"))
    s = _seeded(jmac.init_state(cfg), 4, 32, 32)
    s = s._replace(u=jnp.asarray(s.u, jnp.float32), v=jnp.asarray(s.v, jnp.float32))
    step = jax.jit(jmac.make_step(cfg, jmac.free_slip_bcs()))
    for _ in range(5):
        s, m = step(s, jnp.float32(1.0))
    _assert_equal(results[0]["free_slip"], s, m, atol=2e-5)


def test_mac_explicit_soak_healthy(results):
    soak = results[0]["soak"]
    assert soak["finite"]
    assert float(soak["div_post"][-1]) < 1e-3
    assert float(soak["max_vel"][-1]) <= 1.0 + 1e-3


def test_mac_explicit_runner_soak_with_snapshots(results):
    from cfdsim_tpu_torch.io_ import list_steps

    out, path = results
    assert out["runner_soak"]["step"] == 600
    assert out["runner_soak"]["stopped_reason"] == ""
    assert len(list_steps(path)) >= 3


def test_trim_face_masks_rejects_boundary_body():
    from cfdsim_tpu_torch.grid import Grid
    from cfdsim_tpu_torch.ibm import cylinder_masks_mac
    from cfdsim_tpu_torch.parallel.mac_explicit import trim_face_masks

    g = Grid(nx=32, ny=32, x_max=8.0, y_max=8.0, centering="cell")
    mu, mv = cylinder_masks_mac(g, center=(0.5, 4.0), radius=0.5)
    with pytest.raises(ValueError, match="boundary"):
        trim_face_masks(mu, mv)


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_mac_explicit_other_topologies(results, topo):
    got = results[0][("topology", topo)]
    r, m_ref = _jax_pair("topology")
    np.testing.assert_allclose(got["u"], np.asarray(r.u)[:, :-1], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["v"], np.asarray(r.v)[:-1, :], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["metrics"]["energy"], float(m_ref.energy), rtol=1e-5)


def test_mac_explicit_cavity_les_matches(results):
    got = results[0]["les"]
    r, m_ref = _jax_pair("les")
    np.testing.assert_allclose(got["u"], np.asarray(r.u)[:, :-1], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["v"], np.asarray(r.v)[:-1, :], rtol=0, atol=2e-5)
    # dt follows the mean ν_t: a sum over the mesh in another order
    np.testing.assert_allclose(got["metrics"]["dt"], float(m_ref.dt), rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["energy"], float(m_ref.energy), rtol=1e-5)


def test_mac_explicit_moving_body_is_not_ported_yet():
    from cfdsim_tpu_torch.parallel.mac_explicit import make_mac_explicit_step

    with pytest.raises(NotImplementedError, match="22b"):
        make_mac_explicit_step(None, None, None, moving_body=object())


def _jax_boussinesq(case, steps):
    import jax
    import jax.numpy as jnp

    step = jax.jit(case.step)
    r = case.state
    for _ in range(steps):
        r, m = step(r, jnp.float32(1.0))
    return r, m


def test_heated_cavity_explicit_sharded_matches(results):
    """tests/test_boussinesq.py:61."""
    from cfdsim_tpu.cases import heated_cavity

    r, m_ref = _jax_boussinesq(heated_cavity(n=32, Ra=1e4), 40)
    got = results[0]["heated_cavity"]
    np.testing.assert_allclose(got["u"], np.asarray(r.u)[:, :-1], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["v"], np.asarray(r.v)[:-1, :], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["theta"], np.asarray(r.theta), rtol=0, atol=3e-5)
    m = got["metrics"]
    np.testing.assert_allclose(m["dt"], float(m_ref.dt), rtol=1e-6)
    np.testing.assert_allclose(m["nu_hot_wall"], float(m_ref.nu_hot_wall), rtol=1e-4)
    np.testing.assert_allclose(m["nu_mid"], float(m_ref.nu_mid), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(m["energy"], float(m_ref.energy), rtol=1e-5)


def test_rayleigh_benard_explicit_sharded_matches(results):
    """tests/test_boussinesq.py:198."""
    from cfdsim_tpu.cases import rayleigh_benard

    r, m_ref = _jax_boussinesq(rayleigh_benard(ny=16, aspect=2.0, Ra=3000.0), 40)
    got = results[0]["rayleigh_benard"]
    np.testing.assert_allclose(got["u"], np.asarray(r.u)[:, :-1], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["v"], np.asarray(r.v)[:-1, :], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["theta"], np.asarray(r.theta), rtol=0, atol=3e-5)
    m = got["metrics"]
    np.testing.assert_allclose(m["nu_hot_wall"], float(m_ref.nu_hot_wall), rtol=1e-4)
    np.testing.assert_allclose(m["nu_mid"], float(m_ref.nu_mid), rtol=1e-3, atol=1e-4)
