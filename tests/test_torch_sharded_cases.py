"""The multi-device entry point on the fifteen cases it maps since the
explicit steps of the 2D staggered, Boussinesq, stretched, transport and
3D-body tiers joined it (``parallel/sharded.py``: ``shard_state``,
``make_sharded_step``), at each case's default options, and bf16 storage
on the explicit collocated and MAC steps.

- Every case: 2 steps through ``make_sharded_step`` on ``shard_state``
  blocks of one group of 4 gloo ranks (2×2), gathered, against the port's
  single-device step on the same state (a staggered state trimmed as
  ``shard_state`` trims it): u, v, w and θ within rtol 1e-4, atol 1e-5
  (tests/test_parallel.py:78-83, the JAX GSPMD test's band); p, the
  pressure solve's φ, whose lowest modes carry the rounding of the
  right-hand side amplified by 1/λ_min, within 2e-4 of max|p|; t within
  1e-6.
- The cases whose explicit path is new (``transport``, ``channel``, the
  ``cylinder`` with its default DCT projection, ``sphere_stretched`` and
  ``heated_sphere_stretched`` with their default TVD scheme) also against
  the JAX package's single-device jitted step, on the same seeded inputs,
  in the same band.
- ``cavity_fem`` and ``schafer_turek_fem`` on coarse meshes (the other
  ten cases of the entry point run in tests/test_torch_sharded_step.py and
  the four GSPMD-tier files): the nodal vectors within 1e-5 of their
  largest value.
- bf16 storage (``lid_cavity``, ``lid_cavity_mac`` at 32²): the stored u
  and v within one bfloat16 ulp of |u| of the port's single-device bf16
  step, elementwise, after one step from a seeded field (both sides
  compute in float32, whose last-bit differences can flip one rounding;
  a second step would start from states that differ by such flips).

Grids: 2D 48×32 (32² for the cavities), 3D 32×16×16 in the (8, 4, 4) box
of tests/test_torch_mac3d_explicit.py with an IBM ramp of 4 steps. The
ranks run while this process runs the references
(``test_torch_mac3d_explicit.spawn_beside``); JAX is imported inside the
functions (a rank imports this module and needs torch alone).
"""

import numpy as np
import pytest
import torch

FIELD_RTOL, FIELD_ATOL = 1e-4, 1e-5  # tests/test_parallel.py:78-83
P_RTOL_OF_MAX = 2e-4
STEPS = 2

_BOX = dict(nx=32, ny=16, nz=16, domain=(8.0, 4.0, 4.0), center=(2.0, 2.0, 2.0),
            ibm_ramp_steps=4)
_STRETCH = dict(refine_strength=1.5, refine_width=1.0, wake_length=2.0)

# (id, case name, builder keywords)
CASES = [
    ("channel", "channel", dict(nx=48, ny=32)),
    ("cylinder", "cylinder", dict(nx=48, ny=32)),
    ("cylinder_mac", "cylinder_mac", dict(nx=48, ny=32, ibm_ramp_steps=4)),
    ("cylinder_oscillating", "cylinder_oscillating", dict(nx=48, ny=32)),
    ("cylinder_stretched", "cylinder_stretched", dict(nx=48, ny=32, ibm_ramp_steps=4)),
    ("cavity_stretched", "cavity_stretched", dict(n=32)),
    ("cavity3d_stretched", "cavity3d_stretched", dict(n=16)),
    ("heated_cavity", "heated_cavity", dict(n=32)),
    ("rayleigh_benard", "rayleigh_benard", dict(ny=16)),
    ("heated_cube", "heated_cube", dict(n=16)),
    ("sphere", "sphere", dict(_BOX)),
    ("sphere_stretched", "sphere_stretched", dict(_BOX, **_STRETCH)),
    ("heated_sphere", "heated_sphere", dict(_BOX)),
    ("heated_sphere_stretched", "heated_sphere_stretched", dict(_BOX, **_STRETCH)),
    ("transport", "transport", dict(n=32)),
]
JAX_IDS = ("transport", "channel", "cylinder", "sphere_stretched", "heated_sphere_stretched")
BF16 = [("bf16_cavity", "cavity", dict(n=32, storage="bf16")),
        ("bf16_cavity_mac", "cavity_mac", dict(n=32, storage="bf16"))]
# the two FEM cases no other file runs through the entry point, on coarse
# meshes; their nodal vectors within FEM_RTOL of their largest value
# (tests/test_torch_sharded_step.py's band for cylinder_fem)
FEM = [("cavity_fem", "cavity_fem", dict(n=8, viz_shape=(8, 8))),
       ("schafer_turek_fem", "schafer_turek_fem", dict(h_near=0.05, h_far=0.2,
                                                        viz_shape=(8, 16)))]
FEM_RTOL = 1e-5


def _bf16_start(state):
    """The bf16 cavities start from a seeded field (from rest, 2 steps move
    only the lid's neighbours), rounded to bfloat16."""
    rng = np.random.default_rng(5)
    u = 0.1 * rng.standard_normal(tuple(state.u.shape)).astype(np.float32)
    v = 0.1 * rng.standard_normal(tuple(state.v.shape)).astype(np.float32)
    return u, v


def _with_start(state, key):
    if not key.startswith("bf16"):
        return state
    u, v = _bf16_start(state)
    return state._replace(u=torch.from_numpy(u).to(state.u.dtype),
                          v=torch.from_numpy(v).to(state.v.dtype))


def _steps(key) -> int:
    """A bf16 case takes one step: the second would start from states that
    differ by the one-ulp flips of the first rounding."""
    return 1 if key.startswith("bf16") else STEPS


def _fields(state) -> dict:
    """Every field of a state as float32 numpy (a CoupledState's flow
    fields and θ side by side)."""
    if hasattr(state, "flow"):
        return {**_fields(state.flow), "theta": np.asarray(state.theta, np.float32)}
    out = {}
    for k, v in state._asdict().items():
        if k in ("t", "step") or v is None:
            continue
        out[k] = (v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
    return out


def _t(state):
    return float(state.flow.t if hasattr(state, "flow") else state.t)


def _ranks(mesh):
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mesh import gather_state
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step, shard_state

    out = {}
    for key, name, kw in CASES + BF16 + FEM:
        case = build(name, device="cpu", **kw)
        state = _with_start(case.state, key)
        step = make_sharded_step(case.step, mesh)
        s = shard_state(state, mesh)
        for _ in range(_steps(key)):
            s, _ = step(s, 1.0)
        g = s if key.endswith("_fem") else gather_state(s, mesh)  # FEM: whole on every rank
        out[key] = {"fields": _fields(g), "t": _t(g), "dtype": str(g.u.dtype)
                    if hasattr(g, "u") else str(g.flow.u.dtype)}
    return out


def _port_single():
    """The port's single-device steps, their states trimmed as
    ``shard_state`` trims them, on one torch thread as each rank runs."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mesh import GridMesh
    from cfdsim_tpu_torch.parallel.sharded import shard_state

    whole = GridMesh(1, 1, 0, "gloo", torch.device("cpu"), None, None)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for key, name, kw in CASES + BF16 + FEM:
            case = build(name, device="cpu", **kw)
            s = _with_start(case.state, key)
            for _ in range(_steps(key)):
                s, _ = case.step(s, 1.0)
            out[key] = {"fields": _fields(shard_state(s, whole)), "t": _t(s)}
        return out
    finally:
        torch.set_num_threads(n_threads)


def _jax_single():
    """The JAX package's single-device jitted steps, trimmed alike."""
    import jax
    import jax.numpy as jnp

    from cfdsim_tpu.cases import build

    out = {}
    for key, name, kw in CASES:
        if key not in JAX_IDS:
            continue
        case = build(name, **kw)
        step = jax.jit(case.step)
        s = case.state
        for _ in range(STEPS):
            s, _ = step(s, jnp.float32(1.0))
        flow = s.flow if hasattr(s, "flow") else s
        fields = {k: np.asarray(v, np.float32) for k, v in flow._asdict().items()
                  if k not in ("t", "step")}
        if hasattr(s, "flow"):
            fields["theta"] = np.asarray(s.theta, np.float32)
        if "w" in fields:
            fields["u"], fields["v"], fields["w"] = (fields["u"][:, :, :-1],
                                                     fields["v"][:, :-1, :], fields["w"][:-1])
        elif fields["u"].shape[-1] == fields["p"].shape[-1] + 1:
            fields["u"], fields["v"] = fields["u"][:, :-1], fields["v"][:-1, :]
        out[key] = {"fields": fields, "t": float(flow.t)}
    return out


@pytest.fixture(scope="module")
def results():
    from test_torch_mac3d_explicit import spawn_beside

    out = spawn_beside(_ranks, local=lambda: {"port": _port_single(), "jax": _jax_single()})
    return {"ranks": out["ranks"], **out["jax"]}


def _assert_case(got, ref):
    for k, a in ref["fields"].items():
        if k == "p":
            np.testing.assert_allclose(got["fields"][k], a, rtol=0,
                                       atol=P_RTOL_OF_MAX * float(np.abs(a).max()), err_msg=k)
        else:
            np.testing.assert_allclose(got["fields"][k], a, rtol=FIELD_RTOL, atol=FIELD_ATOL,
                                       err_msg=k)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)


@pytest.mark.parametrize("key", [c[0] for c in CASES])
def test_sharded_case_matches_port_single_device(results, key):
    _assert_case(results["ranks"][key], results["port"][key])


@pytest.mark.parametrize("key", JAX_IDS)
def test_sharded_case_matches_jax_single_device(results, key):
    _assert_case(results["ranks"][key], results["jax"][key])


@pytest.mark.parametrize("key", [c[0] for c in FEM])
def test_sharded_fem_case_matches_port_single_device(results, key):
    got, ref = results["ranks"][key], results["port"][key]
    for k, a in ref["fields"].items():
        np.testing.assert_allclose(got["fields"][k], a, rtol=0,
                                   atol=FEM_RTOL * max(float(np.abs(a).max()), 1.0), err_msg=k)


@pytest.mark.parametrize("key", [c[0] for c in BF16])
def test_sharded_bf16_within_one_ulp(results, key):
    got, ref = results["ranks"][key], results["port"][key]
    assert got["dtype"] == "torch.bfloat16"
    for k in ("u", "v"):
        a, b = got["fields"][k], ref["fields"][k]
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
        assert np.all(np.abs(a - b) <= ulp), (k, float(np.max(np.abs(a - b) - ulp)))


# what the entry point still does not map: a step built by hand, which no
# case builder left an explicit_spec on, and the stretched 3D tier's moving
# ghost, which no case builds (ROADMAP "Deliberate differences");
# make_sharded_step raises a ValueError that names each. The five options
# it refused before (MAC implicit diffusion, the 2D static ghost cylinder,
# the 3D inlet modulation, the heated cube's upwind/TVD flow, the heated
# spheres' TVD θ) pass through: tests/test_torch_sharded_schemes.py


def _hand_built_mac():
    from cfdsim_tpu_torch.grid import Grid
    from cfdsim_tpu_torch.models import mac

    cfg = mac.MACConfig(grid=Grid(nx=16, ny=16, centering="cell"), nu=0.01)
    return mac.make_step(cfg, mac.cavity_bcs(1.0), device="cpu")


def _stretched3d_moving_ghost():
    from cfdsim_tpu_torch.ibm import oscillating_sphere
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.models import mac_stretched3d as ms3

    n = 16
    faces = [np.linspace(0.0, 4.0, n + 1) ** 1.1 for _ in range(3)]
    cfg = ms3.StretchedMAC3DConfig(nx=n, ny=n, nz=n, nu=0.01)
    body = oscillating_sphere((2.0, 2.0, 2.0), 0.5, 0.2, 5.0)
    return ms3.make_step(cfg, mac3d.free_slip_bcs3d(), *faces, moving_body=body,
                         moving_scheme="ghost", device="cpu")


REFUSED = [
    ("hand_built_mac", _hand_built_mac, "explicit_spec"),
    ("stretched3d_moving_ghost", _stretched3d_moving_ghost, "moving_scheme='ghost'"),
]


@pytest.mark.parametrize("make,match", [r[1:] for r in REFUSED], ids=[r[0] for r in REFUSED])
def test_make_sharded_step_refuses_unported_option(make, match):
    from cfdsim_tpu_torch.parallel.mesh import GridMesh
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step

    mesh = GridMesh(1, 1, 0, "gloo", torch.device("cpu"), None, None)
    with pytest.raises(ValueError, match=match):
        make_sharded_step(make(), mesh)
