"""The port's multi-device entry point (``parallel/sharded.py``:
``shard_state``, ``make_sharded_step``) and the trimmed MAC lift
(``parallel/mac_sharded.py::make_sharded_mac_step``) against the JAX
package, the twins of tests/test_parallel.py:60-99,121-130,175-198.

- The dispatcher on ``lid_cavity(n=32)``: 3 steps on one gloo group of 2×2
  ranks against the JAX single-device jitted step, u and v within rtol
  1e-4, atol 1e-5 (the JAX GSPMD test's); the metrics of one step: energy
  within 1e-5 relative, ``div_pre`` within 1e-4.
- The other tiers the dispatcher maps (the MAC, 3D MAC, pseudo-spectral and
  FEM steps) against the port's own single-device step, one or two steps,
  within 1e-5 of the largest value.
- ``make_sharded_mac_step`` on one device: 5 steps bit-equal to the plain
  MAC step (the JAX test's ``assert_array_equal``).
- A ``ValueError`` for a step type with no counterpart and for an option
  the explicit step does not implement (MAC ``time_scheme="rk2"``).

The rank side (``run_sharded``) and the JAX side (``jax_run``) take a list
of (case name, builder arguments, steps) and are shared with the tests of
the four explicit modules the dispatcher reaches through GSPMD tiers
(``test_torch_{compressible,spectral,incompressible3d,compressible3d}_explicit.py``).
One group of 4 gloo ranks per file, in a module fixture, while this
process runs the JAX references; JAX is imported inside the functions (a
rank imports this module and needs torch alone).
"""

import numpy as np
import pytest
import torch

STATE_RTOL, STATE_ATOL = 1e-4, 1e-5  # tests/test_parallel.py:78-83
PORT_RTOL = 1e-5


def _poisson3d(cls, kw):
    return cls(**kw["poisson3d"]) if "poisson3d" in kw else None


def _builder_kwargs(kw, cls3d):
    """The builder arguments of one side: ``random_uv`` and ``poisson3d``
    are this helper's, the rest go to ``cases.build``."""
    out = {k: v for k, v in kw.items() if k not in ("random_uv", "poisson3d")}
    if "poisson3d" in kw:
        out["poisson"] = _poisson3d(cls3d, kw)
    return out


def _random_uv(kw, shape):
    """The seeded (u, v) of the Kolmogorov tests (tests/test_parallel.py:109-113)."""
    rng = np.random.default_rng(kw["random_uv"])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _fields(state):
    return {k: v for k, v in state._asdict().items() if k not in ("t", "step")}


def run_sharded(mesh, cases):
    """Rank side: each case built by the port, its state sharded
    (``shard_state``), stepped ``steps`` times by ``make_sharded_step`` and
    gathered; rank 0 returns, per case, the global fields (numpy; a MAC
    state's trimmed ones, a pseudo-spectral state's half spectrum, the FEM
    state's nodal vectors), t, step and every step's metrics."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mesh import gather_state
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step, shard_state
    from cfdsim_tpu_torch.parallel.spectral_ps_explicit import half_spectrum_state
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    out = []
    for name, kw, steps in cases:
        case = build(name, device="cpu", **_builder_kwargs(kw, Poisson3DConfig))
        state = case.state
        if "random_uv" in kw:
            u, v = _random_uv(kw, tuple(state.u.shape))
            state = state._replace(u=torch.from_numpy(u), v=torch.from_numpy(v))
        step = make_sharded_step(case.step, mesh)
        s = shard_state(state, mesh)
        metrics = []
        for _ in range(steps):
            s, m = step(s, 1.0)
            metrics.append({k: float(x) for k, x in m._asdict().items()})
        if name.endswith("_fem"):
            g = s
        elif name == "kolmogorov_ps":
            g = half_spectrum_state(case.cfg, gather_state(s, mesh))
        else:
            g = gather_state(s, mesh)
        out.append({"fields": {k: None if v is None else v.numpy()
                               for k, v in _fields(g).items()},
                    "t": float(g.t), "step": int(g.step), "metrics": metrics})
    return out


def port_run(cases):
    """The port's single-device steps on the same cases (fields as
    ``run_sharded`` returns them), on one torch thread as each rank runs:
    an FEM step's GMRES iterate carries its sums' rounding amplified, and
    the summation order of a multi-threaded einsum differs."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _port_run(cases)
    finally:
        torch.set_num_threads(n_threads)


def _port_run(cases):
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mac_sharded import trim_state
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    out = []
    for name, kw, steps in cases:
        case = build(name, device="cpu", **_builder_kwargs(kw, Poisson3DConfig))
        s = case.state
        for _ in range(steps):
            s, m = case.step(s, 1.0)
        if name == "cavity_mac":
            s = trim_state(s)
        if name == "cavity3d_mac":
            s = s._replace(u=s.u[:, :, :-1], v=s.v[:, :-1, :], w=s.w[:-1])
        out.append({"fields": {k: None if v is None else v.numpy()
                               for k, v in _fields(s).items()},
                    "t": float(s.t), "metrics": {k: float(x) for k, x in m._asdict().items()}})
    return out


def jax_run(cases):
    """The JAX package's single-device jitted steps on the same cases."""
    import jax
    import jax.numpy as jnp

    from cfdsim_tpu.cases import build
    from cfdsim_tpu.solvers.poisson3d import Poisson3DConfig

    out = []
    for name, kw, steps in cases:
        case = build(name, **_builder_kwargs(kw, Poisson3DConfig))
        s = case.state
        if "random_uv" in kw:
            u, v = _random_uv(kw, tuple(s.u.shape))
            s = s._replace(u=jnp.asarray(u), v=jnp.asarray(v))
        step = jax.jit(case.step)
        for _ in range(steps):
            s, m = step(s, jnp.float32(1.0))
        out.append({"fields": {k: np.asarray(v) for k, v in _fields(s).items()},
                    "t": float(s.t), "metrics": {k: float(x) for k, x in m._asdict().items()}})
    return out


def run_beside(cases, local):
    """``run_sharded`` on one group of 4 gloo ranks (2×2) while this process
    runs ``local(cases)`` (``test_torch_mac3d_explicit.spawn_beside``):
    {"ranks": rank 0's result, "ref": what ``local`` returned}."""
    from test_torch_mac3d_explicit import spawn_beside

    out = spawn_beside(run_sharded, cases, local=lambda: local(cases))
    return {"ranks": out["ranks"], "ref": out["jax"]}


def assert_fields(got, ref, rtol, atol, names=None):
    for k in names or ref["fields"]:
        np.testing.assert_allclose(got["fields"][k], ref["fields"][k], rtol=rtol, atol=atol,
                                   err_msg=k)


JAX_CASES = [("cavity", dict(n=32, Re=100.0), 3), ("cavity", dict(n=32, Re=100.0), 1)]
PORT_CASES = [("cavity_mac", dict(n=32, Re=100.0), 2),
              ("cavity3d_mac", dict(n=16, Re=100.0), 2),
              ("kolmogorov_ps", dict(ny=32, noise=0.1), 2),
              ("cylinder_fem", dict(h_far=0.5, h_near=0.12, dt=0.02, viz_shape=(8, 8)), 1)]


@pytest.fixture(scope="module")
def results():
    return run_beside(JAX_CASES + PORT_CASES,
                      lambda cases: {"jax": jax_run(cases[:len(JAX_CASES)]),
                                     "port": port_run(cases[len(JAX_CASES):])})


def test_sharded_cavity_matches_jax_single_device(results):
    got, ref = results["ranks"][0], results["ref"]["jax"][0]
    assert_fields(got, ref, STATE_RTOL, STATE_ATOL, ("u", "v"))
    assert got["step"] == 3


def test_sharded_step_metrics_match_jax(results):
    got, ref = results["ranks"][1]["metrics"][0], results["ref"]["jax"][1]["metrics"]
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(got["div_pre"], ref["div_pre"], rtol=1e-4)


@pytest.mark.parametrize("k", range(len(PORT_CASES)), ids=[c[0] for c in PORT_CASES])
def test_sharded_tiers_match_port_single_device(results, k):
    got, ref = results["ranks"][len(JAX_CASES) + k], results["ref"]["port"][k]
    for name, a in ref["fields"].items():
        if a is None:
            continue
        np.testing.assert_allclose(got["fields"][name], a, rtol=0,
                                   atol=PORT_RTOL * max(np.abs(a).max(), 1.0), err_msg=name)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)


def test_mac_trimmed_lift_bitwise_exact():
    from cfdsim_tpu_torch.cases import lid_cavity_mac
    from cfdsim_tpu_torch.parallel.mac_sharded import (
        make_sharded_mac_step,
        trim_state,
        untrim_state,
    )

    case = lid_cavity_mac(n=32, Re=100.0, device="cpu")
    bcs = case.extras["bcs"]
    tstep = make_sharded_mac_step(case.step, bcs, None)
    t, ref = trim_state(case.state), case.state
    for _ in range(5):
        t, m = tstep(t, 1.0)
        ref, mr = case.step(ref, 1.0)
    full = untrim_state(t, bcs)
    assert torch.equal(full.u, ref.u) and torch.equal(full.v, ref.v)
    assert torch.equal(m.energy, mr.energy)


def test_make_sharded_step_refuses_what_it_cannot_map():
    from cfdsim_tpu_torch.parallel.mesh import GridMesh
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step
    from test_torch_sharded_cases import _hand_built_mac

    mesh = GridMesh(1, 1, 0, "gloo", torch.device("cpu"), None, None)
    with pytest.raises(ValueError, match="explicit_spec"):
        make_sharded_step(_hand_built_mac(), mesh)
    with pytest.raises(ValueError, match="no sharded counterpart for a Identity step"):
        make_sharded_step(torch.nn.Identity(), mesh)
