"""The options the multi-device entry point refused before it took every
pressure solve and MAC time scheme (``parallel/sharded.py::
make_sharded_step``; ``parallel/poisson2d_explicit.py``; rk2 and the
incremental projection on the four MAC tiers; the fused predictor and
kernel B on rank windows).

- Every case: 2 steps through ``make_sharded_step`` on ``shard_state``
  blocks of one group of 4 gloo ranks (2×2), gathered, against the JAX
  package's single-device jitted step (its Pallas kernels in interpret
  mode on the CPU, as tests/test_pallas.py runs them) and against the
  port's single-device step, on the same state: u, v, w and θ within rtol
  1e-4, atol 1e-5 (tests/test_parallel.py:78-83, the JAX GSPMD test's
  band); p within 2e-4 of max|p| and t within 1e-6, the rules of
  tests/test_torch_sharded_cases.py. One exception, for p against JAX
  alone: the reference-parity cylinder's 2 × 1500 unconverged masked SOR
  sweeps leave the port's own single-device p 3.1e-4 of max|p| from the
  JAX package's (XLA contracts a·b + c into one FMA on the CPU, the port
  rounds each operation; tests/test_torch_rbsor.py), so the sharded p is
  held there to 5e-4 of max|p| (to the port's single-device p at 2e-4);
  its u and v keep the band.
- The 42² grids cut into 21×21 blocks, whose windows start at odd global
  origins (``parity0`` = 1 on two ranks); the 48×12 channel's 6-row blocks
  clip kernel B's K from 8 to 3.
- The early exit (``tol > 0``: the windowed and the gathered
  ``rbsor_pallas``, the distributed ``rbsor`` sweeps) runs the chunks the
  port's single-device solve runs.

Grids 32²-48² in 2D, 16³ in 3D. The ranks run while this process runs
the references (``test_torch_mac3d_explicit.spawn_beside``); JAX is
imported inside the functions (a rank imports this module and needs torch
alone).
"""

import numpy as np
import pytest
import torch

from test_torch_sharded_cases import _assert_case, _fields, _t

STEPS = 2
P_RTOL_OF_MAX_JAX = {"cylinder_ref_parity": 5e-4}
_TOL = dict(method="rbsor_pallas", iters=400, tol=1e-3, check_every=8)
# the masked cylinder's residual starts near 9e4 (rhs = div/dt at its
# warm-up dt); 2e4 stops the two solves after 12 and 4 chunks, each check
# more than 1% from the threshold
TOL_MASKED = 2e4

# (id, case name, builder keywords, pressure config: None or (dim, fields)
# built with each package's PoissonConfig / Poisson3DConfig)
CASES = [
    # the collocated step: every pressure solve, the early exit, the fused
    # predictor
    ("cavity_mg", "cavity", dict(n=42), (2, dict(method="mg", iters=2))),
    ("cavity_jacobi", "cavity", dict(n=32), (2, dict(method="jacobi", iters=60))),
    ("cavity_fft", "cavity", dict(n=32), (2, dict(method="fft"))),
    ("cavity_hybrid", "cavity", dict(n=32), (2, dict(method="hybrid", iters=20))),
    ("cavity_rbsor_pallas", "cavity", dict(n=42), (2, dict(method="rbsor_pallas"))),
    ("channel_rbsor_pallas", "channel", dict(nx=48, ny=12), (2, dict(method="rbsor_pallas"))),
    ("cavity_rbsor_pallas_tol", "cavity", dict(n=32), (2, _TOL)),
    ("cavity_rbsor_tol", "cavity", dict(n=32), (2, dict(_TOL, method="rbsor"))),
    ("cylinder_ref_parity", "cylinder", dict(nx=48, ny=32, ref_parity=True), None),
    ("cylinder_hybrid_masked", "cylinder", dict(nx=48, ny=32, masked_poisson=True),
     (2, dict(method="hybrid", iters=20))),
    ("cylinder_rbsor_pallas_masked", "cylinder", dict(nx=48, ny=32, masked_poisson=True),
     (2, dict(method="rbsor_pallas", iters=60))),
    ("cylinder_rbsor_pallas_masked_tol", "cylinder", dict(nx=48, ny=32, masked_poisson=True),
     (2, dict(_TOL, tol=TOL_MASKED))),
    ("cavity_fused", "cavity", dict(n=32, fused_predictor=True), None),
    ("cavity_fused_mg", "cavity", dict(n=42, fused_predictor=True),
     (2, dict(method="mg", iters=2))),
    # the heated cavity and cube: their non-DCT solves
    ("heated_cavity_mg", "heated_cavity", dict(n=32), (2, dict(method="mg", iters=2))),
    ("heated_cavity_rbsor_pallas", "heated_cavity", dict(n=32),
     (2, dict(method="rbsor_pallas", iters=60))),
    ("heated_cube_mg", "heated_cube", dict(n=16), (3, dict(method="mg", iters=2))),
    ("heated_cube_rbsor", "heated_cube", dict(n=16), (3, dict(method="rbsor", iters=40))),
    # the 2D and 3D MAC steps: their non-DCT solves
    ("mac_mg", "cavity_mac", dict(n=42), (2, dict(method="mg", iters=2))),
    ("mac_rbsor_pallas", "cavity_mac", dict(n=32), (2, dict(method="rbsor_pallas"))),
    ("mac_jacobi", "cavity_mac", dict(n=32), (2, dict(method="jacobi", iters=60))),
    ("mac_rbsor_tol", "cavity_mac", dict(n=32), (2, dict(_TOL, method="rbsor", tol=0.3))),
    ("mac3d_mg", "cavity3d_mac", dict(n=16), (3, dict(method="mg", iters=2))),
    ("mac3d_rbsor", "cavity3d_mac", dict(n=16), (3, dict(method="rbsor", iters=40))),
    # rk2 and the incremental projection on the four MAC tiers
    ("mac_rk2", "cavity_mac", dict(n=32, time_scheme="rk2"), None),
    ("mac_incremental", "cavity_mac", dict(n=32, projection="incremental"), None),
    ("mac_rk2_incremental_mg", "cavity_mac", dict(n=32, time_scheme="rk2",
                                                  projection="incremental"),
     (2, dict(method="mg", iters=2))),
    ("cylinder_mac_rk2", "cylinder_mac", dict(nx=48, ny=32, ibm_ramp_steps=4,
                                              time_scheme="rk2"), None),
    ("oscillating_rk2", "cylinder_oscillating", dict(nx=48, ny=32, time_scheme="rk2"), None),
    ("oscillating_ghost_rk2", "cylinder_oscillating",
     dict(nx=48, ny=32, time_scheme="rk2", ibm_scheme="ghost"), None),
    ("stretched_rk2", "cavity_stretched", dict(n=32, time_scheme="rk2"), None),
    ("stretched_incremental", "cavity_stretched", dict(n=32, projection="incremental"), None),
    ("mac3d_rk2", "cavity3d_mac", dict(n=16, time_scheme="rk2"), None),
    ("mac3d_incremental", "cavity3d_mac", dict(n=16, projection="incremental"), None),
    ("stretched3d_rk2", "cavity3d_stretched", dict(n=16, time_scheme="rk2"), None),
    ("stretched3d_incremental", "cavity3d_stretched", dict(n=16, projection="incremental"),
     None),
]
KEYS = [c[0] for c in CASES]


def _kw(kw, poisson, package: str):
    """The builder keywords with the pressure config built by ``package``
    ("cfdsim_tpu_torch" or "cfdsim_tpu")."""
    if poisson is None:
        return dict(kw)
    import importlib

    dim, fields = poisson
    if dim == 2:
        cls = importlib.import_module(f"{package}.solvers.poisson").PoissonConfig
    else:
        cls = importlib.import_module(f"{package}.solvers.poisson3d").Poisson3DConfig
    return dict(kw, poisson=cls(**fields))


def _ranks(mesh):
    import torch.distributed as dist

    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mesh import gather_state
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step, shard_state

    out, facts = {}, {}
    for key, name, kw, poisson in CASES:
        case = build(name, device="cpu", **_kw(kw, poisson, "cfdsim_tpu_torch"))
        step = make_sharded_step(case.step, mesh)
        s = shard_state(case.state, mesh)
        for _ in range(STEPS):
            s, _ = step(s, 1.0)
        g = gather_state(s, mesh)
        out[key] = {"fields": _fields(g), "t": _t(g)}
        solver = getattr(getattr(step, "inner", step), "poisson", None)
        if key in ("cavity_mg", "cavity_rbsor_pallas", "channel_rbsor_pallas"):
            k = solver.level_k[0] if key == "cavity_mg" else solver.k
            parity = solver._window(torch.zeros(solver.local_shape), k)[2]
            every = [None] * mesh.size
            dist.all_gather_object(every, parity)
            facts[key] = {"k": k, "parity0": every}
        if key.endswith("_tol"):
            facts[key] = {"chunks": int(solver.chunks_run)}
    return {"cases": out, "facts": facts}


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
        for key, name, kw, poisson in CASES:
            case = build(name, device="cpu", **_kw(kw, poisson, "cfdsim_tpu_torch"))
            s = case.state
            for _ in range(STEPS):
                s, _ = case.step(s, 1.0)
            out[key] = {"fields": _fields(shard_state(s, whole)), "t": _t(s),
                        "chunks": int(case.step.poisson.chunks_run)
                        if key.endswith("_tol") else None}
        return out
    finally:
        torch.set_num_threads(n_threads)


def _jax_single():
    """The JAX package's single-device jitted steps, trimmed alike."""
    import jax
    import jax.numpy as jnp

    from cfdsim_tpu.cases import build

    out = {}
    for key, name, kw, poisson in CASES:
        case = build(name, **_kw(kw, poisson, "cfdsim_tpu"))
        step = jax.jit(case.step)
        s = case.state
        for _ in range(STEPS):
            s, _ = step(s, jnp.float32(1.0))
        fields = {k: np.asarray(v, np.float32) for k, v in s._asdict().items()
                  if k not in ("t", "step")}
        if "w" in fields:
            fields["u"], fields["v"], fields["w"] = (fields["u"][:, :, :-1],
                                                     fields["v"][:, :-1, :], fields["w"][:-1])
        elif fields["u"].shape[-1] == fields["p"].shape[-1] + 1:
            fields["u"], fields["v"] = fields["u"][:, :-1], fields["v"][:-1, :]
        out[key] = {"fields": fields, "t": float(s.t)}
    return out


@pytest.fixture(scope="module")
def results():
    from test_torch_mac3d_explicit import spawn_beside

    out = spawn_beside(_ranks, local=lambda: {"port": _port_single(), "jax": _jax_single()})
    return {"ranks": out["ranks"]["cases"], "facts": out["ranks"]["facts"], **out["jax"]}


@pytest.mark.parametrize("key", KEYS)
def test_sharded_option_matches_port_single_device(results, key):
    _assert_case(results["ranks"][key], results["port"][key])


@pytest.mark.parametrize("key", KEYS)
def test_sharded_option_matches_jax_single_device(results, key):
    got, ref = results["ranks"][key], results["jax"][key]
    if key in P_RTOL_OF_MAX_JAX:
        np.testing.assert_allclose(got["fields"]["p"], ref["fields"]["p"], rtol=0,
                                   atol=P_RTOL_OF_MAX_JAX[key] * np.abs(ref["fields"]["p"]).max())
        got, ref = ({**x, "fields": {k: v for k, v in x["fields"].items() if k != "p"}}
                    for x in (got, ref))
    _assert_case(got, ref)


def test_windows_start_at_odd_origins_and_clip_k(results):
    """21×21 blocks put the windows of ranks (0, 1) and (1, 0) at odd
    global origins (parity0 = 1); the channel's 6-row blocks clip K to 3;
    42² blocks keep K = 8 for rbsor_pallas and K = 2 (mg_pre, mg_post) for
    the multigrid smoother."""
    facts = results["facts"]
    assert facts["cavity_rbsor_pallas"] == {"k": 8, "parity0": [0, 1, 1, 0]}
    assert facts["cavity_mg"] == {"k": 2, "parity0": [0, 1, 1, 0]}
    assert facts["channel_rbsor_pallas"]["k"] == 3


@pytest.mark.parametrize("key", [k for k in KEYS if k.endswith("_tol")])
def test_early_exit_runs_the_single_device_chunks(results, key):
    """The residual decided over the mesh (or on the gathered grid, for the
    masked rbsor_pallas) stops the sweeps after as many chunks as the
    single-device solve."""
    got = results["facts"][key]["chunks"]
    want = results["port"][key]["chunks"]
    assert 0 < got < STEPS * (_TOL["iters"] // _TOL["check_every"])  # an early exit
    assert got == want
