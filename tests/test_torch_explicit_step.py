"""The collocated step on a 2×2 mesh of gloo ranks
(``cfdsim_tpu_torch/parallel/explicit.py``) against the JAX package's
single-device step: the twins of tests/test_explicit_step.py, with its
tolerances, its 1000-step runner soak included. The first case is also held
against the JAX package's own explicit step on a 2×2 mesh of 4 of its
virtual CPU devices.

One group of ranks runs every case (``_explicit_ranks``); rank 0 returns
the gathered states and the metrics (reduced over all ranks, so every rank
holds the same numbers and stops at the same step). The soak's snapshots
are gathered to rank 0 and written there. JAX is imported inside the
tests: the ranks import this module for their function and need torch
alone.

The implicit "auto" fallback: the JAX test's 36² cavity has blocks of
18×9 on its 2×4 mesh, not pencil-splittable; on a 2×2 mesh its 18×18
blocks are, so "auto" takes the DST there (held against the single-device
step), and a 34² cavity (17×17 blocks) exercises the fallback (held
against the single-device Jacobi step).
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)
SOAK_STEPS, SOAK_CHUNK, SOAK_SNAPSHOTS = 1000, 100, 300


def _cavity(n=32, Re=100.0, scheme="central", iters=30, **kw):
    from cfdsim_tpu_torch.cases import lid_cavity
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    return lid_cavity(n=n, Re=Re, scheme=scheme,
                      poisson=PoissonConfig(method="rbsor", iters=iters, omega=1.7),
                      device="cpu", **kw)


def _cylinder(**kw):
    from cfdsim_tpu_torch.cases import cylinder
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    return cylinder(nx=64, ny=32, Re=100.0,
                    poisson=PoissonConfig(method="rbsor", iters=20, omega=1.7),
                    warmup_steps=2, warmup_dt=1e-4, ibm_ramp_steps=10, device="cpu", **kw)


# (case builder, its keywords, steps, cylinder extras with the solid mask)
CASES = {
    "cavity": (_cavity, {}, 3, None),
    "cylinder": (_cylinder, dict(cleanup_iters=0), 4, False),
    "tvd": (_cavity, dict(Re=400.0, scheme="tvd", iters=25), 3, None),
    "implicit_jacobi": (_cavity, dict(diffusion="implicit", implicit_solver="jacobi",
                                      implicit_iters=8, iters=25), 3, None),
    "supg_les": (_cylinder, dict(scheme="supg", use_les=True, cleanup_iters=0), 4, False),
    "cleanup_masked": (_cylinder, dict(scheme="upwind", ref_parity=False, masked_poisson=True,
                                       cleanup_iters=2), 4, True),
    "implicit_dst": (_cavity, dict(diffusion="implicit", implicit_solver="dst", iters=25), 3,
                     None),
    "auto_36": (_cavity, dict(n=36, diffusion="implicit", implicit_solver="auto",
                              implicit_iters=8, iters=20), 1, None),
    "auto_34": (_cavity, dict(n=34, diffusion="implicit", implicit_solver="auto",
                              implicit_iters=8, iters=20), 1, None),
}


def _extras(case, mesh, with_solid):
    from cfdsim_tpu_torch.parallel.mesh import local_block, local_rows

    if with_solid is None:
        return ()
    out = [local_block(np.asarray(case.extras["ibm_mask"], np.float32), mesh),
           local_rows(np.asarray(case.grid.y_coords(), np.float32), mesh)]
    if with_solid:
        out.append(local_block(np.asarray(case.extras["solid_mask"]), mesh))
    return tuple(out)


def _metrics(m):
    return {k: float(getattr(m, k)) for k in m._fields}


def _explicit_ranks(mesh, snapshot_path):
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.parallel.explicit import (
        make_cavity_explicit_step,
        make_cylinder_explicit_step,
    )
    from cfdsim_tpu_torch.parallel.mesh import block_state, gather_state

    out = {}
    for name, (build, kw, steps, solid) in CASES.items():
        case = build(**kw)
        if solid is None:
            step = make_cavity_explicit_step(case.cfg, mesh)
        else:
            step = make_cylinder_explicit_step(case.cfg, mesh, v_inf=1.0)
        extras = _extras(case, mesh, solid)
        s = block_state(case.state, mesh)
        for _ in range(steps):
            s, m = step(s, 1.0, *extras)
        g = gather_state(s, mesh)
        out[name] = {"u": g.u.numpy(), "v": g.v.numpy(), "p": g.p.numpy(),
                     "metrics": _metrics(m), "use_dst": step.use_dst}

    # 100 steps through make_chunk (the loop route: the step calls collectives)
    case = _cavity(iters=30)
    step = make_cavity_explicit_step(case.cfg, mesh)
    chunk = make_chunk(case.cfg, step, 100)
    s, m = chunk(block_state(case.state, mesh), 1.0)
    out["many"] = {"finite": bool(torch.isfinite(gather_state(s, mesh).u).all()),
                   "max_vel": m.max_vel.numpy(), "route": (chunk.mode, chunk.reason)}

    out["soak"] = _soak(mesh, snapshot_path)
    return out


def _soak(mesh, snapshot_path):
    """runner.Simulation over the distributed step: ~1k steps in chunks of
    100, snapshots every 300 steps gathered to rank 0 and written there."""
    from cfdsim_tpu_torch.parallel.explicit import make_cavity_explicit_step
    from cfdsim_tpu_torch.parallel.mesh import block_state, gather_state
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation

    case = _cavity(iters=20)
    step = make_cavity_explicit_step(case.cfg, mesh)
    writer = None
    if mesh.rank == 0:
        from cfdsim_tpu_torch.io_ import SnapshotWriter

        writer = SnapshotWriter(snapshot_path)

    def snapshot(state, step_, t):
        full = gather_state(state, mesh)  # a collective: every rank calls it
        if writer is not None:
            writer.save(step_, t, u=full.u, v=full.v, p=full.p)

    cfg = RunnerConfig(t_final=1e9, max_steps=SOAK_STEPS, chunk_steps=SOAK_CHUNK,
                       snapshot_interval=SOAK_SNAPSHOTS, div_threshold=50.0,
                       log_every_chunks=0)
    sim = Simulation(step, block_state(case.state, mesh), cfg, case.grid.n_cells, snapshot)
    state, report = sim.run()
    full = gather_state(state, mesh)
    return {"stopped_reason": report["stopped_reason"], "step": int(state.step),
            "finite": bool(torch.isfinite(full.u).all()), "route": report["chunk_route"]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from cfdsim_tpu_torch.parallel.launch import spawn

    path = tmp_path_factory.mktemp("soak") / "soak.h5"
    return spawn(_explicit_ranks, 4, TOPOLOGY, str(path), device="cpu"), path


def _jax_case(name):
    """The JAX twin of ``CASES[name]`` and its extras."""
    import jax.numpy as jnp
    from cfdsim_tpu.cases import cylinder, lid_cavity
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    build, kw, steps, solid = CASES[name]
    kw = dict(kw)
    if build is _cavity:
        n = kw.pop("n", 32)
        Re = kw.pop("Re", 100.0)
        scheme = kw.pop("scheme", "central")
        iters = kw.pop("iters", 30)
        case = lid_cavity(n=n, Re=Re, scheme=scheme,
                          poisson=PoissonConfig(method="rbsor", iters=iters, omega=1.7), **kw)
    else:
        case = cylinder(nx=64, ny=32, Re=100.0,
                        poisson=PoissonConfig(method="rbsor", iters=20, omega=1.7),
                        warmup_steps=2, warmup_dt=1e-4, ibm_ramp_steps=10, **kw)
    return case, steps


def _jax_reference(name):
    import jax
    import jax.numpy as jnp

    case, steps = _jax_case(name)
    step = jax.jit(case.step)
    s = case.state
    for _ in range(steps):
        s, m = step(s, jnp.float32(1.0))
    return s, m


def _check(got, s_ref, m_ref, rtol=1e-4, atol=1e-5, p=False, full_metrics=True):
    np.testing.assert_allclose(got["u"], np.asarray(s_ref.u), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["v"], np.asarray(s_ref.v), rtol=rtol, atol=atol)
    if p:
        np.testing.assert_allclose(got["p"], np.asarray(s_ref.p), rtol=1e-4, atol=1e-5)
    m = got["metrics"]
    np.testing.assert_allclose(m["energy"], float(m_ref.energy), rtol=1e-5)
    if full_metrics:
        # tests/test_explicit_step.py:_equality_check
        np.testing.assert_allclose(m["dt"], float(m_ref.dt), rtol=1e-6)
        np.testing.assert_allclose(m["vort_max"], float(m_ref.vort_max), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(m["poisson_res"], float(m_ref.poisson_res), rtol=1e-3,
                                   atol=1e-4)


def test_explicit_step_matches_single_device(results):
    got = results[0]["cavity"]
    s_ref, m_ref = _jax_reference("cavity")
    _check(got, s_ref, m_ref, rtol=1e-5, atol=1e-6, p=True, full_metrics=False)
    np.testing.assert_allclose(got["metrics"]["dt"], float(m_ref.dt), rtol=1e-6)
    np.testing.assert_allclose(got["metrics"]["div_pre"], float(m_ref.div_pre), rtol=1e-4)


def test_explicit_step_matches_jax_explicit_step_on_a_2x2_mesh(results):
    """The JAX package's own explicit step on 4 of its virtual devices."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.parallel.explicit import make_cavity_explicit_step
    from cfdsim_tpu.parallel.mesh import make_grid_mesh
    from cfdsim_tpu.parallel.sharded import shard_state

    got = results[0]["cavity"]
    case, steps = _jax_case("cavity")
    mesh = make_grid_mesh(4, topology=TOPOLOGY)
    step = jax.jit(make_cavity_explicit_step(case.cfg, mesh))
    s = shard_state(case.state, mesh)
    for _ in range(steps):
        s, m = step(s, jnp.float32(1.0))
    _check(got, s, m, rtol=1e-5, atol=1e-6, p=True)
    for k in ("div_pre", "div_post", "max_vel"):
        np.testing.assert_allclose(got["metrics"][k], float(getattr(m, k)), rtol=1e-4)


def test_cylinder_explicit_step_matches_single_device(results):
    got = results[0]["cylinder"]
    s_ref, m_ref = _jax_reference("cylinder")
    _check(got, s_ref, m_ref, full_metrics=False)
    # the IBM body force, which the JAX package's explicit step leaves at 0
    np.testing.assert_allclose(got["metrics"]["fx"], float(m_ref.fx), rtol=1e-4, atol=1e-6)


def test_explicit_step_runs_many_steps_healthy(results):
    many = results[0]["many"]
    assert many["finite"]
    assert float(many["max_vel"][-1]) <= 1.0 + 1e-3
    assert many["route"][0] == "loop"


@pytest.mark.parametrize("name", ["tvd", "implicit_jacobi", "supg_les", "cleanup_masked",
                                  "implicit_dst"])
def test_explicit_options_match(results, name):
    got = results[0][name]
    s_ref, m_ref = _jax_reference(name)
    _check(got, s_ref, m_ref)
    assert got["use_dst"] == (name == "implicit_dst")


def test_explicit_runner_soak_with_snapshots(results):
    from cfdsim_tpu_torch.io_ import list_steps

    out, path = results
    soak = out["soak"]
    assert soak["stopped_reason"] == ""
    assert soak["step"] >= SOAK_STEPS
    assert soak["finite"]
    assert soak["route"] == "loop"
    assert len(list_steps(path)) >= 3


def test_explicit_implicit_auto_falls_back_when_not_pencil_splittable(results):
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.cases import lid_cavity
    from cfdsim_tpu.solvers.poisson import PoissonConfig

    out = results[0]
    # 36²: 18×18 blocks split into pencils, so "auto" takes the DST, as the
    # single-device step does
    assert out["auto_36"]["use_dst"]
    s_ref, m_ref = _jax_reference("auto_36")
    _check(out["auto_36"], s_ref, m_ref)
    # 34²: 17×17 blocks do not; "auto" falls back to Jacobi (the JAX
    # single-device step with implicit_solver="jacobi")
    got = out["auto_34"]
    assert not got["use_dst"] and np.all(np.isfinite(got["u"]))
    case = lid_cavity(n=34, Re=100.0, scheme="central", diffusion="implicit",
                      implicit_solver="jacobi", implicit_iters=8,
                      poisson=PoissonConfig(method="rbsor", iters=20, omega=1.7))
    s_ref, m_ref = jax.jit(case.step)(case.state, jnp.float32(1.0))
    _check(got, s_ref, m_ref)
