"""The five options the multi-device entry point refused before the
explicit steps took them (``parallel/sharded.py::make_sharded_step``): MAC
``diffusion="implicit"`` (the lid cavity, ``transforms.MacHelmholtzLocal``),
the static 2D ghost-cell ``cylinder_mac`` (``ibm_ghost_explicit.
partition_ghost_ibm2d``), the spheres' 3D inlet modulation, the heated
cube's upwind and TVD flow, and the heated spheres' TVD θ.

- Every case: 2 steps through ``make_sharded_step`` on ``shard_state``
  blocks of one group of 4 gloo ranks (2×2), gathered, against the JAX
  package's single-device jitted step and against the port's single-device
  step, from the same seeded start (the port's state carried into the JAX
  one by ``cfdsim_tpu_torch.convert.state_to_numpy``): u, v, w and θ within
  rtol 1e-4, atol 1e-5 (tests/test_parallel.py:78-83); p within 2e-4 of
  max|p| and t within 1e-6, the rules of tests/test_torch_sharded_cases.py.
  The cavity and the cube start from a seeded velocity (2 steps from rest
  would move only the lid's or the walls' neighbours), the heated spheres
  from a seeded θ (from θ_in = 0 the limiter would see a flat field but
  for the body).
- The ghost cylinder's body forces fx, fy (one sum over the mesh) against
  the port's single-device step's.
- The distributed MAC Helmholtz solve on the 2×2 blocks against the JAX
  package's ``make_mac_helmholtz``, for the cavity's u and v kinds, within
  1e-6 of max|q|.
- ``partition_ghost_ibm2d``'s four rank tables, stitched on the host, are
  the whole-grid ``cylinder_ghost_ibm`` tables.

Grids: 2D 32² and 48×32, 3D 16³ and 32×16×16 in the (8, 4, 4) box of
tests/test_torch_mac3d_explicit.py with an IBM ramp of 4 steps. The ranks
run while this process runs the references
(``test_torch_mac3d_explicit.spawn_beside``); JAX is imported inside the
functions (a rank imports this module and needs torch alone).
"""

import numpy as np
import pytest
import torch

from test_torch_sharded_cases import _assert_case, _fields, _t

STEPS = 2
HELMHOLTZ_RTOL_OF_MAX = 1e-6

_BOX = dict(nx=32, ny=16, nz=16, domain=(8.0, 4.0, 4.0), center=(2.0, 2.0, 2.0),
            ibm_ramp_steps=4)
_STRETCH = dict(refine_strength=1.5, refine_width=1.0, wake_length=2.0)
# 8 cells across the cylinder, its centre on the mesh's x cut and off its y
# cut and the grid's symmetry line (fy ≠ 0): ghost faces and probe corners
# on all four ranks
_CYLINDER = dict(nx=48, ny=32, domain=(6.0, 4.0), center=(3.0, 2.1), ibm_scheme="ghost",
                 ibm_ramp_steps=4)

# (id, case name, builder keywords, the seeded fields: (names, amplitude))
CASES = [
    ("cavity_mac_implicit", "cavity_mac", dict(n=32, diffusion="implicit"), ("uv", 0.1)),
    ("cylinder_mac_ghost", "cylinder_mac", _CYLINDER, None),
    ("sphere_inlet", "sphere", dict(_BOX, perturb=0.05), None),
    ("sphere_stretched_inlet_les", "sphere_stretched",
     dict(_BOX, **_STRETCH, perturb=0.02, use_les=True), None),
    ("heated_cube_upwind", "heated_cube", dict(n=16, flow_scheme="upwind"), ("uvw", 0.1)),
    ("heated_cube_tvd", "heated_cube", dict(n=16, flow_scheme="tvd"), ("uvw", 0.1)),
    ("heated_sphere_tvd", "heated_sphere", dict(_BOX, theta_scheme="tvd"), (("theta",), 0.3)),
    ("heated_sphere_ghost_tvd", "heated_sphere",
     dict(_BOX, theta_scheme="tvd", ibm_scheme="ghost"), (("theta",), 0.3)),
    ("heated_sphere_stretched_ghost_tvd", "heated_sphere_stretched",
     dict(_BOX, **_STRETCH, theta_scheme="tvd", ibm_scheme="ghost"), (("theta",), 0.3)),
]
KEYS = [c[0] for c in CASES]
# the cavity's implicit solves: (kinds, the trimmed normal axis)
HELMHOLTZ = [(("dst2", "dst1"), 1), (("dst1", "dst2"), 0)]
HELMHOLTZ_N = 32


def _start(case, seeded):
    """The case's initial state with the seeded fields added (the same
    numpy draws on every rank and in the reference)."""
    state = case.state
    if seeded is None:
        return state
    names, amp = seeded
    rng = np.random.default_rng(7)
    rep = {}
    for k in names:
        a = getattr(state, k)
        rep[k] = a + torch.from_numpy(amp * rng.standard_normal(tuple(a.shape))
                                      .astype(np.float32))
    return state._replace(**rep)


def _forces(m) -> dict:
    """The body forces of a step's metrics (none for the heated cube)."""
    return {k: float(getattr(m, k)) for k in ("fx", "fy") if hasattr(m, k)}


def _helmholtz_inputs():
    rng = np.random.default_rng(11)
    n = HELMHOLTZ_N
    return rng.standard_normal((n, n)).astype(np.float32), np.float32(0.5 * 0.01 / n)


def _ranks(mesh):
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mesh import gather_blocks, gather_state, local_block
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step, shard_state
    from cfdsim_tpu_torch.parallel.transforms import MacHelmholtzLocal

    out = {}
    for key, name, kw, seeded in CASES:
        case = build(name, device="cpu", **kw)
        step = make_sharded_step(case.step, mesh)
        s = shard_state(_start(case, seeded), mesh)
        for _ in range(STEPS):
            s, m = step(s, 1.0)
        g = gather_state(s, mesh)
        out[key] = {"fields": _fields(g), "t": _t(g), **_forces(m)}
    b, c = _helmholtz_inputs()
    h = 1.0 / HELMHOLTZ_N
    helm = {}
    for kinds, _ in HELMHOLTZ:
        solve = MacHelmholtzLocal(b.shape, kinds, h, h, mesh)
        q = solve(local_block(b, mesh), torch.tensor(c))
        helm[kinds] = gather_blocks(q, mesh).numpy()
    return {"cases": out, "helmholtz": helm}


def _port_single():
    """The port's single-device steps, their states trimmed as
    ``shard_state`` trims them, on one torch thread as each rank runs."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.convert import state_to_numpy
    from cfdsim_tpu_torch.parallel.mesh import GridMesh
    from cfdsim_tpu_torch.parallel.sharded import shard_state

    whole = GridMesh(1, 1, 0, "gloo", torch.device("cpu"), None, None)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, starts = {}, {}
        for key, name, kw, seeded in CASES:
            case = build(name, device="cpu", **kw)
            s = _start(case, seeded)
            starts[key] = state_to_numpy(s)
            for _ in range(STEPS):
                s, m = case.step(s, 1.0)
            out[key] = {"fields": _fields(shard_state(s, whole)), "t": _t(s), **_forces(m)}
        return out, starts
    finally:
        torch.set_num_threads(n_threads)


def _jax_single(starts):
    """The JAX package's single-device jitted steps from the port's starts,
    trimmed alike; and its MAC Helmholtz solves."""
    import jax
    import jax.numpy as jnp

    from cfdsim_tpu.cases import build
    from cfdsim_tpu.solvers.helmholtz import make_mac_helmholtz

    out = {}
    for key, name, kw, _ in CASES:
        case = build(name, **kw)
        s = case.state._replace(**{k: jnp.asarray(v) for k, v in starts[key].items()
                                   if k not in ("t", "step")})
        step = jax.jit(case.step)
        for _ in range(STEPS):
            s, _ = step(s, jnp.float32(1.0))
        fields = {k: np.asarray(v, np.float32) for k, v in s._asdict().items()
                  if k not in ("t", "step")}
        if "w" in fields:
            fields["u"], fields["v"], fields["w"] = (fields["u"][:, :, :-1],
                                                     fields["v"][:, :-1, :], fields["w"][:-1])
        else:
            fields["u"], fields["v"] = fields["u"][:, :-1], fields["v"][:-1, :]
        out[key] = {"fields": fields, "t": float(s.t)}
    b, c = _helmholtz_inputs()
    h = 1.0 / HELMHOLTZ_N
    helm = {}
    for kinds, normal in HELMHOLTZ:
        interior = b[:, 1:] if normal == 1 else b[1:]
        solve = make_mac_helmholtz(interior.shape, kinds, h, h)
        helm[kinds] = np.asarray(jax.jit(solve)(jnp.asarray(interior), jnp.float32(c)))
    return out, helm


def _references():
    port, starts = _port_single()
    jax_out, helm = _jax_single(starts)
    return {"port": port, "jax": jax_out, "helmholtz": helm}


@pytest.fixture(scope="module")
def results():
    from test_torch_mac3d_explicit import spawn_beside

    out = spawn_beside(_ranks, local=_references)
    return {"ranks": out["ranks"]["cases"], "helmholtz_ranks": out["ranks"]["helmholtz"],
            **out["jax"]}


@pytest.mark.parametrize("key", KEYS)
def test_sharded_scheme_matches_port_single_device(results, key):
    _assert_case(results["ranks"][key], results["port"][key])


@pytest.mark.parametrize("key", KEYS)
def test_sharded_scheme_matches_jax_single_device(results, key):
    _assert_case(results["ranks"][key], results["jax"][key])


def test_ghost_cylinder_forces_sum_over_the_mesh(results):
    got, ref = results["ranks"]["cylinder_mac_ghost"], results["port"]["cylinder_mac_ghost"]
    assert abs(ref["fx"]) > 0.0 and abs(ref["fy"]) > 0.0
    np.testing.assert_allclose([got["fx"], got["fy"]], [ref["fx"], ref["fy"]], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kinds,normal", HELMHOLTZ, ids=["u", "v"])
def test_distributed_mac_helmholtz_matches_jax(results, kinds, normal):
    got = results["helmholtz_ranks"][kinds]
    ref = results["helmholtz"][kinds]
    interior = got[:, 1:] if normal == 1 else got[1:]
    boundary = got[:, 0] if normal == 1 else got[0]
    np.testing.assert_allclose(interior, ref, rtol=0,
                               atol=HELMHOLTZ_RTOL_OF_MAX * float(np.abs(ref).max()))
    assert np.all(boundary == 0.0)


def test_partition_ghost_ibm2d_stitches_to_the_whole_grid():
    """The 2×2 meshes' tables, mapped back to global indices and stitched in
    rank order then sorted row-major, are the whole-grid tables; every rank
    gets the same halo width and the solid blocks tile the trimmed mask."""
    from cfdsim_tpu_torch.grid import Grid
    from cfdsim_tpu_torch.ibm_ghost import cylinder_ghost_ibm
    from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import partition_ghost_ibm2d
    from cfdsim_tpu_torch.parallel.mesh import GridMesh

    nx, ny = _CYLINDER["nx"], _CYLINDER["ny"]
    g = Grid(nx=nx, ny=ny, x_max=_CYLINDER["domain"][0], y_max=_CYLINDER["domain"][1],
             centering="cell")
    xf = np.arange(nx + 1) * g.dx
    yf = np.arange(ny + 1) * g.dy
    whole = cylinder_ghost_ibm(xf, yf, _CYLINDER["center"], 0.5, device="cpu")
    py, px = 2, 2
    ny_l, nx_l = ny // py, nx // px
    parts = []
    for rank in range(py * px):
        mesh = GridMesh(py, px, rank, "gloo", torch.device("cpu"), None, None)
        parts.append((mesh, *partition_ghost_ibm2d(whole, nx, ny, mesh, device="cpu")))
    widths = {w for _, _, w in parts}
    assert len(widths) == 1
    width = widths.pop()
    for comp, nxf in (("u", nx + 1), ("v", nx)):
        ref = getattr(whole, comp)
        gy, gx, pidx, pw, scale = [], [], [], [], []
        solid = np.zeros((ny, nx), bool)
        NYW, NXW = ny_l + 2 * width, nx_l + 2 * width
        owners = set()
        for mesh, tables, _ in parts:
            t = getattr(tables, comp)
            if t.gy.numel():
                owners.add(mesh.rank)
            gy0, gx0 = mesh.iy * ny_l, mesh.ix * nx_l
            assert np.all(t.gz.numpy() == 0)
            solid[gy0:gy0 + ny_l, gx0:gx0 + nx_l] = t.solid.numpy()[0]
            gy.append(t.gy.numpy() + gy0)
            gx.append(t.gx.numpy() + gx0)
            p = t.pidx.numpy()
            j = p // NXW % NYW + gy0 - width
            i = p % NXW + gx0 - width
            pidx.append(j * nxf + i)
            pw.append(t.pw.numpy())
            scale.append(t.scale.numpy())
        assert owners == {0, 1, 2, 3}
        gy, gx, pidx, pw, scale = (np.concatenate(a) for a in (gy, gx, pidx, pw, scale))
        order = np.lexsort((gx, gy))
        gy, gx, pidx, pw, scale = (a[order] for a in (gy, gx, pidx, pw, scale))
        np.testing.assert_array_equal(gy, ref.gy.numpy())
        np.testing.assert_array_equal(gx, ref.gx.numpy())
        np.testing.assert_array_equal(pw, ref.pw.numpy())
        np.testing.assert_array_equal(scale, ref.scale.numpy())
        live = pw != 0.0
        np.testing.assert_array_equal(pidx[live], ref.pidx.numpy()[live])
        trimmed = ref.solid.numpy()[:, :-1] if comp == "u" else ref.solid.numpy()[:-1]
        np.testing.assert_array_equal(solid, trimmed)
