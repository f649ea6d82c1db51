"""The element-sharded FEM steps on gloo ranks
(``cfdsim_tpu_torch/parallel/fem_explicit.py``) against the JAX package's
single-device operators and steps, from the same inputs: the twins of
tests/test_fem_explicit.py on its ``tiny_case`` mesh (``cylinder_fem``,
re 80, h_far 0.5, h_near 0.12: 582 triangles), on 1×4 ranks where the JAX
tests have 1×8 devices.

Inputs: the JAX package's steady Stokes solution on that mesh (restart 200,
20 restarts, tol 1e-6: the Stokes test's own reference) is the initial
state of the apply, monolithic, θ, PSPG and P1-P1 projection checks; the
Taylor–Hood projection starts from the Dirichlet lift with a seeded
velocity on the free nodes (the JAX tests build each case's Stokes state,
whose P2 solve costs ~15 s of compile and solve and nothing the parity
needs). Each side builds its mesh, spaces and element tables (the same
numpy code in both packages).

Tolerances (the JAX tests'): the apply within atol 2e-4, rtol 1e-4; the
monolithic, θ, PSPG and projection steps' u within 5e-4 of max|u|, p within
5e-3, fx within 5e-3, the monolithic energy within 1e-4 relative; Stokes
within 1e-3 of max|u|. Every Krylov solve ends at the same iteration on
every rank: the counts of each step's solves are equal across the ranks.

One group of 4 gloo ranks runs every distributed check (``_ranks``) while
this process runs the JAX references; torch runs on one thread here (an
FEM solve is thousands of small ops, see tests/test_torch_fem.py). JAX is
imported inside the tests: the ranks import this module for their function
and need torch alone.
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (1, 4)
MESH = dict(h_far=0.5, h_near=0.12, x_span=(-1.0, 8.0), y_span=(-2.0, 2.0), center=(3.0, 0.0),
            radius=0.5)
# cylinder_fem's configuration at re 80 (tests/test_fem_explicit.py:29-35),
# and its projection variants (:123-127)
BASE = dict(nu=1.0 / 80.0, dt=0.05)
MONO = dict(BASE, gmres_tol=1e-5)
STOKES = dict(MONO, gmres_restart=200, gmres_maxiter=20, gmres_tol=1e-6)
STEP_CASES = {  # name: (space, config, steps, start)
    "monolithic": ("p1p1", MONO, 3, "stokes"),
    "theta": ("p1p1", dict(MONO, theta=0.5), 1, "stokes"),
    "pspg": ("p1p1", dict(MONO, theta=0.5, stab="pspg"), 2, "stokes"),
    "projection_p1p1": ("p1p1", dict(BASE, gmres_tol=1e-6, theta=0.5), 3, "stokes"),
    "projection_p2p1": ("p2p1", dict(BASE, gmres_tol=1e-6, theta=0.5, supg=1.0), 3, "lift"),
}
U_RTOL, P_ATOL, FX_ATOL, ENERGY_RTOL, STOKES_RTOL = 5e-4, 5e-3, 5e-3, 1e-4, 1e-3
APPLY_ATOL, APPLY_RTOL = 2e-4, 1e-4


def problem(package: str, space: str):
    """The tiny cylinder's mesh, spaces, element tables, Dirichlet lift and
    node sets, built by ``package`` ("jax" or "torch")."""
    if package == "jax":
        from cfdsim_tpu.fem import assembly, mesh, spaces

        def tables(sp):
            return assembly.build_element_ops(sp)
    else:
        from cfdsim_tpu_torch.fem import assembly, mesh, spaces

        def tables(sp):
            return assembly.build_element_ops(sp, device="cpu")
    m = mesh.cylinder_mesh(**MESH)
    sp = spaces.build_spaces(m, space)
    g = spaces.dirichlet_values(sp, {"inlet": lambda x, y: (1.0 + 0 * x, 0 * y),
                                     "walls": lambda x, y: (0 * x, 0 * y),
                                     "cylinder": lambda x, y: (0 * x, 0 * y)})
    return {"ops": tables(sp), "g": np.asarray(g), "force": sp.dirichlet_tag_nodes["cylinder"],
            "outlet": m.tags["outlet"], "free": ~np.asarray(sp.dirichlet_mask)}


def lift_start(prob) -> dict:
    """The Dirichlet lift with a seeded velocity on the free nodes."""
    rng = np.random.default_rng(0)
    u = prob["g"].astype(np.float32).copy()
    n = int(prob["free"].sum())
    u[prob["free"]] = np.stack([0.5 + 0.05 * rng.standard_normal(n),
                                0.05 * rng.standard_normal(n)], 1)
    return {"u": u, "p": np.zeros(prob["ops"].n_p, np.float32)}


def _ranks(mesh, stokes):
    """Every distributed check on the ranks; rank 0 returns the results, the
    Krylov counts of every rank beside them."""
    import torch.distributed as dist

    from cfdsim_tpu_torch.convert import fem_state_from_numpy
    from cfdsim_tpu_torch.models.fem import FEMConfig
    from cfdsim_tpu_torch.parallel import (
        make_fem_explicit_step,
        make_fem_projection_explicit_step,
        make_sharded_ns_apply,
        solve_stokes_sharded,
    )

    probs = {space: problem("torch", space) for space in ("p1p1", "p2p1")}
    out = {}

    def counts_everywhere(counter):
        every = [None] * mesh.size
        dist.all_gather_object(every, dict(counter))
        return every

    # the coupled operator, transient and steady
    p1 = probs["p1p1"]
    apply = make_sharded_ns_apply(p1["ops"], mesh, FEMConfig(**MONO))
    u, p = torch.from_numpy(stokes["u"]), torch.from_numpy(stokes["p"])
    out["apply_transient"] = [y.numpy() for y in apply(u, p, 20.0, u)]
    out["apply_steady"] = [y.numpy() for y in apply(u, p)]

    for name, (space, kw, steps, start) in STEP_CASES.items():
        prob, cfg = probs[space], FEMConfig(space=space, **kw)
        init = stokes if start == "stokes" else lift_start(prob)
        projection = name.startswith("projection")
        phi = np.zeros_like(init["p"]) if projection else None
        state = fem_state_from_numpy(init["u"], init["p"], 0.0, 0, "cpu", phi=phi)
        if projection:
            step = make_fem_projection_explicit_step(prob["ops"], cfg, prob["g"],
                                                     prob["outlet"], mesh,
                                                     force_nodes=prob["force"])
        else:
            step = make_fem_explicit_step(prob["ops"], cfg, prob["g"], mesh,
                                          force_nodes=prob["force"])
        for _ in range(steps):
            state, m = step(state, 1.0)
        out[name] = {"u": state.u.numpy(), "p": state.p.numpy(), "step": int(state.step),
                     "metrics": {k: float(v) for k, v in m._asdict().items()},
                     "counts": counts_everywhere(step.counts)}

    st = solve_stokes_sharded(p1["ops"], FEMConfig(**STOKES), p1["g"], mesh)
    out["stokes"] = {"u": st.u.numpy(), "p": st.p.numpy()}
    return out


def _jax_references(stokes):
    """The JAX package's apply, steps and (the input) Stokes state."""
    import jax
    import jax.numpy as jnp

    from cfdsim_tpu.fem.assembly import apply_ns
    from cfdsim_tpu.models.fem import (
        FEMConfig,
        FEMState,
        _tau,
        make_projection_step,
        make_step,
    )

    probs = {space: problem("jax", space) for space in ("p1p1", "p2p1")}
    p1 = probs["p1p1"]
    ops, cfg = p1["ops"], FEMConfig(**MONO)
    u, p = jnp.asarray(stokes["u"]), jnp.asarray(stokes["p"])
    tau = _tau(ops, cfg)
    out = {"apply_transient": [np.asarray(y) for y in apply_ns(ops, u, p, cfg.nu, 20.0, u, tau)],
           "apply_steady": [np.asarray(y) for y in apply_ns(ops, u, p, cfg.nu, None, None, tau)]}
    for name, (space, kw, steps, start) in STEP_CASES.items():
        prob, cfg = probs[space], FEMConfig(space=space, **kw)
        init = stokes if start == "stokes" else lift_start(prob)
        projection = name.startswith("projection")
        state = FEMState(u=jnp.asarray(init["u"]), p=jnp.asarray(init["p"]),
                         t=jnp.float32(0.0), step=jnp.int32(0),
                         phi=jnp.zeros_like(jnp.asarray(init["p"])) if projection else None)
        if projection:
            step = make_projection_step(prob["ops"], cfg, prob["g"], prob["outlet"],
                                        force_nodes=prob["force"])
        else:
            step = make_step(prob["ops"], cfg, prob["g"], force_nodes=prob["force"])
        step = jax.jit(step)
        for _ in range(steps):
            state, m = step(state, 1.0)
        out[name] = {"u": np.asarray(state.u), "p": np.asarray(state.p),
                     "metrics": {k: float(v) for k, v in m._asdict().items()}}
    return out


def _jax_stokes():
    """The JAX package's steady Stokes solution of the tiny cylinder."""
    from cfdsim_tpu.models.fem import FEMConfig, solve_stokes

    prob = problem("jax", "p1p1")
    st = solve_stokes(prob["ops"], FEMConfig(**STOKES), prob["g"])
    return {"u": np.asarray(st.u, np.float32), "p": np.asarray(st.p, np.float32)}


@pytest.fixture(scope="module")
def results():
    """The ranks' results and the JAX references, computed side by side
    (the JAX Stokes state first: it is both sides' input)."""
    from concurrent.futures import ThreadPoolExecutor

    from cfdsim_tpu_torch.parallel.launch import spawn

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stokes = _jax_stokes()
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn, _ranks, 4, TOPOLOGY, stokes, device="cpu")
            jax_out = _jax_references(stokes)
            return {"ranks": ranks.result(), "jax": jax_out, "stokes": stokes}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("form", ["apply_transient", "apply_steady"])
def test_sharded_apply_matches_jax(results, form):
    for got, want in zip(results["ranks"][form], results["jax"][form]):
        np.testing.assert_allclose(got, want, atol=APPLY_ATOL, rtol=APPLY_RTOL)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_step_matches_jax(results, name):
    got, want = results["ranks"][name], results["jax"][name]
    assert got["step"] == STEP_CASES[name][2]
    scale = float(np.abs(want["u"]).max())
    np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=U_RTOL * scale)
    assert np.isfinite(got["u"]).all()
    if name in ("pspg",) or name.startswith("projection"):
        np.testing.assert_allclose(got["p"], want["p"], rtol=0, atol=P_ATOL)
    if name in ("monolithic",) or name.startswith("projection"):
        np.testing.assert_allclose(got["metrics"]["fx"], want["metrics"]["fx"], atol=FX_ATOL)
    if name == "monolithic":
        np.testing.assert_allclose(got["metrics"]["energy"], want["metrics"]["energy"],
                                   rtol=ENERGY_RTOL)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_krylov_exits_agree_across_ranks(results, name):
    counts = results["ranks"][name]["counts"]
    assert len(counts) == 4 and counts[0]["matvecs"] > 0
    assert all(c == counts[0] for c in counts[1:]), counts


def test_sharded_stokes_matches_jax(results):
    got, want = results["ranks"]["stokes"], results["stokes"]
    scale = float(np.abs(want["u"]).max())
    np.testing.assert_allclose(got["u"], want["u"], rtol=0, atol=STOKES_RTOL * scale)


def test_element_slices_partition_the_mesh():
    """The ranks' slices cover every element once, and the local assemblies
    sum to the full one."""
    from cfdsim_tpu_torch.fem.assembly import apply_mass_u
    from cfdsim_tpu_torch.parallel.fem_explicit import element_slice, local_element_ops
    from cfdsim_tpu_torch.parallel.mesh import GridMesh

    ops = problem("torch", "p1p1")["ops"]
    nt = ops.elem_u.shape[0]
    meshes = [GridMesh(1, 3, r, "gloo", "cpu", None, None) for r in range(3)]
    slices = [element_slice(nt, m) for m in meshes]
    assert slices[0].start == 0 and slices[-1].stop == nt
    assert all(a.stop == b.start for a, b in zip(slices, slices[1:]))
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((ops.n_u, 2)).astype(
        np.float32))
    parts = sum(apply_mass_u(local_element_ops(ops, m), u) for m in meshes)
    torch.testing.assert_close(parts, apply_mass_u(ops, u), rtol=1e-5, atol=1e-6)


def test_sharded_steps_refuse_grad():
    from cfdsim_tpu_torch.models.fem import FEMConfig, FEMState
    from cfdsim_tpu_torch.parallel import make_fem_explicit_step
    from cfdsim_tpu_torch.parallel.mesh import GridMesh

    prob = problem("torch", "p1p1")
    ops = prob["ops"]
    step = make_fem_explicit_step(ops, FEMConfig(**MONO), prob["g"],
                                  GridMesh(1, 1, 0, "gloo", "cpu", None, None))
    u = torch.from_numpy(prob["g"].astype(np.float32)).requires_grad_()
    state = FEMState(u=u, p=torch.zeros(ops.n_p), t=torch.zeros(()),
                     step=torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="no gradient path"):
        step(state, 1.0)
