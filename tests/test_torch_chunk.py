"""A chunk of steps (``make_chunk``): n steps of the chunk against n calls of
the step, against the JAX package's jitted ``lax.scan`` chunk, the route
decision (captured CUDA graph or Python loop), the runner through it, and
the launch count that shows a captured program's replays.

Tolerances:
- chunk vs step calls, and graph vs loop on a card: bit-equal (the same
  operations in the same order).
- chunk vs the JAX chunk: the bands of
  tests/test_torch_cavity.py::test_five_steps_match_jax: atol 1e-5 on every
  state field and stacked metric, ``poisson_res`` 1e-2 relative (the FFT
  solve's rounding noise amplified by ∇², whose size depends on the
  framework's summation order).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import lid_cavity as j_lid_cavity
from cfdsim_tpu.models.incompressible import IncompressibleState as JState
from cfdsim_tpu.models.incompressible import make_chunk as j_make_chunk
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build, lid_cavity
from cfdsim_tpu_torch.convert import state_from_numpy, state_to_numpy
from cfdsim_tpu_torch.models.incompressible import (
    Chunk,
    StepMetrics,
    chunk_route,
    make_chunk,
)
from cfdsim_tpu_torch.ops.kernels import cuda_build
from cfdsim_tpu_torch.ops.kernels import predictor as pred
from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, PoissonSolver

STEP_ATOL = 1e-5
POISSON_RES_RTOL = 1e-2

SMALL_CASES = {
    "cavity_dct": lambda device: lid_cavity(n=16, Re=100.0, device=device),
    "cavity_fused": lambda device: lid_cavity(n=16, Re=100.0, fused_predictor=True,
                                              device=device),
    "cavity_mg": lambda device: lid_cavity(n=16, Re=100.0, poisson="mg:2", device=device),
    "cylinder_kernel_a": lambda device: build(
        "cylinder", nx=48, ny=24, ref_parity=True, scheme="supg", device=device,
        poisson=PoissonConfig(method="rbsor_pallas", iters=40, tol=1e-8, check_every=10,
                              omega=1.7)),
}


def _assert_same(state_a, m_a, state_b, m_b):
    for name in state_a._fields:
        assert torch.equal(getattr(state_a, name), getattr(state_b, name)), name
    for name in m_a._fields:
        assert torch.equal(getattr(m_a, name), getattr(m_b, name)), name


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_chunk_equals_step_calls_bit_for_bit(name):
    case = SMALL_CASES[name]("cpu")
    n = 4
    chunk = make_chunk(case.cfg, case.step, n)
    state, stacked = chunk(case.state, 1.0)
    s = case.state
    rows = []
    for _ in range(n):
        s, m = case.step(s, torch.tensor(1.0))
        rows.append(m)
    want = StepMetrics(*(torch.stack(col) for col in zip(*rows)))
    _assert_same(state, stacked, s, want)
    assert isinstance(stacked, StepMetrics) and stacked.dt.shape == (n,)
    assert int(state.step) == n


@pytest.mark.parametrize("fused", [False, True])
def test_chunk_matches_jax_chunk(fused):
    # a developed state, carried over as numpy
    j_case = j_lid_cavity(n=32, Re=100.0, fused_predictor=fused)
    j_step = jax.jit(j_case.step)
    s0 = j_case.state
    for _ in range(20):
        s0, _ = j_step(s0, jnp.float32(1.0))
    fields = [np.asarray(getattr(s0, k)) for k in JState._fields]
    t_case = lid_cavity(n=32, Re=100.0, fused_predictor=fused, device="cpu")

    js, jm = j_make_chunk(j_case.cfg, j_case.step, 5)(
        JState(*(jnp.asarray(f) for f in fields)), jnp.float32(1.0))  # donated: a copy
    ts, tm = make_chunk(t_case.cfg, t_case.step, 5)(state_from_numpy(*fields, "cpu"), 1.0)

    assert tm._fields == jm._fields
    for name in jm._fields:
        want, got = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert got.shape == want.shape == (5,)
        if name == "poisson_res":
            np.testing.assert_allclose(got, want, rtol=POISSON_RES_RTOL, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=STEP_ATOL, err_msg=name)
    out = state_to_numpy(ts)
    for name in ("u", "v", "p", "t"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(js, name)), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)
    assert int(out["step"]) == int(js.step) == 25


@pytest.mark.parametrize("device, reads_host, want", [
    ("cpu", False, "loop"),
    ("cpu", True, "loop"),
    ("cuda", True, "loop"),
    ("cuda", False, "graph"),
    ("cuda:0", False, "graph"),
])
def test_chunk_route_decision(device, reads_host, want):
    mode, reason = chunk_route(device, reads_host)
    assert mode == want and reason


@pytest.mark.parametrize("cfg, reads_host", [
    (PoissonConfig(method="rbsor", iters=40, tol=1e-6, check_every=10), True),
    (PoissonConfig(method="jacobi", iters=40, tol=1e-6, check_every=10), True),
    (PoissonConfig(method="rbsor", iters=40), False),
    (PoissonConfig(method="jacobi", iters=40), False),
    (PoissonConfig(method="dct"), False),
    (PoissonConfig(method="mg", iters=2), False),
    (PoissonConfig(method="hybrid", iters=4), False),
    (PoissonConfig(method="rbsor_pallas", iters=40, tol=1e-6, check_every=10), False),
], ids=["rbsor_tol", "jacobi_tol", "rbsor", "jacobi", "dct", "mg", "hybrid", "kernel_a_tol"])
def test_solver_says_whether_it_reads_the_host(cfg, reads_host):
    solver = PoissonSolver((16, 16), 0.1, 0.1, cfg, device="cpu")
    assert solver.reads_host is reads_host
    # the route a step through this solver would take on a card, without one
    case = lid_cavity(n=16, Re=100.0, poisson=cfg, device="cpu")
    assert case.step.reads_host is reads_host
    chunk = make_chunk(case.cfg, case.step, 3, device="cuda")
    assert chunk.mode == ("loop" if reads_host else "graph")
    assert chunk.program is None  # nothing is captured before the first call


def test_make_chunk_on_the_cpu_is_the_loop_and_says_why():
    case = lid_cavity(n=16, Re=100.0, device="cpu")
    chunk = make_chunk(case.cfg, case.step, 3)
    assert isinstance(chunk, Chunk)
    assert chunk.mode == "loop" and "cpu" in chunk.reason
    with pytest.raises(ValueError, match="graph route is not open"):
        make_chunk(case.cfg, case.step, 3, route="graph")
    with pytest.raises(ValueError, match="unknown chunk route"):
        make_chunk(case.cfg, case.step, 3, route="scan")
    with pytest.raises(ValueError, match="at least one step"):
        make_chunk(case.cfg, case.step, 0)
    forced = make_chunk(case.cfg, case.step, 3, device="cuda", route="loop")
    assert forced.mode == "loop" and "asked" in forced.reason


def test_make_chunk_of_a_plain_callable():
    def step(state, cfl_scale):
        raise AssertionError("not called")

    with pytest.raises(ValueError, match="device="):
        make_chunk(None, step, 3)
    # a step that does not say whether it reads the host is taken to read it
    assert make_chunk(None, step, 3, device="cuda").mode == "loop"


@pytest.mark.parametrize("n_steps, want", [(100, 10), (600, 10), (20, 10), (5, 5), (7, 7),
                                           (13, 1), (36, 9), (1, 1)])
def test_steps_per_graph_divides_the_chunk(n_steps, want):
    case = lid_cavity(n=16, Re=100.0, device="cpu")
    chunk = make_chunk(case.cfg, case.step, n_steps, device="cuda")
    assert chunk.steps_per_graph == want and n_steps % chunk.steps_per_graph == 0


def test_chunk_leaves_its_input_and_its_earlier_results_alone():
    case = lid_cavity(n=16, Re=100.0, device="cpu")
    chunk = make_chunk(case.cfg, case.step, 3)
    u0 = case.state.u.clone()
    first, m_first = chunk(case.state, 1.0)
    kept_u, kept_dt = first.u.clone(), m_first.dt.clone()
    second, _ = chunk(first, 1.0)
    assert torch.equal(case.state.u, u0)
    assert torch.equal(first.u, kept_u) and torch.equal(m_first.dt, kept_dt)
    assert int(second.step) == 6


def test_runner_cfl_backoff_between_chunks():
    """An unhealthy chunk lowers the CFL scale; the next chunk of the same
    chunk object runs at the smaller dt."""
    case = lid_cavity(n=32, Re=100.0, device="cpu")
    cfg = RunnerConfig(t_final=1e9, max_steps=6, chunk_steps=2, div_threshold=1e-12,
                       warmup_div_threshold=1e-12, on_unhealthy="backoff", cfl_backoff=0.5,
                       cfl_scale_min=0.01, max_velocity=case.cfg.max_velocity)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    chunk = sim.chunk
    state, report = sim.run()
    assert sim.chunk is chunk and report["chunk_route"] == "loop"
    assert report["final_step"] == int(state.step) == 6
    dts = [h["dt"] for h in sim.metrics_history]
    # the cavity's dt is CFL-bound (max |u| = 1, the lid), so it follows the scale
    assert dts[1] == pytest.approx(0.5 * dts[0], rel=1e-5)
    assert dts[2] == pytest.approx(0.25 * dts[0], rel=1e-5)
    assert sim.cfl_scale == pytest.approx(0.125)


def test_cli_run_logs_and_reports_the_chunk_route(tmp_path):
    report = cli.main(["run", "cavity", "--n", "16", "--max-steps", "4", "--chunk-steps", "2",
                       "--device", "cpu", "--out", str(tmp_path)])
    assert report["chunk_route"] == "loop" and report["final_step"] == 4
    log = (tmp_path / "logs" / "cfdsim_tpu_torch.log").read_text()
    assert "chunk of 2 steps on cpu: loop route" in log


def test_kernel_counts_its_launches_in_device_memory(monkeypatch):
    """The wrapper hands the launcher the address of a count that lives with
    the kernel's device and never adds to it itself: the kernel does, so a
    launch that a graph replays is counted and a call that is only being
    captured is not. Here a stand-in launcher plays the kernel."""
    kernel = cuda_build.CudaKernel("predictor.cu", "cfd_fake", [])
    capturing = {"now": True}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["now"])
    assert kernel.launches == 0
    kernel._fn = lambda *args: 0  # "captured": the launcher succeeds, nothing runs
    with pytest.raises(RuntimeError, match="run it once eagerly first"):
        kernel(None)  # the count cannot be made under a capture
    capturing["now"] = False
    kernel._counts[0] = torch.zeros(1, dtype=torch.int64)  # stands in for the device's
    kernel(None)
    assert kernel.launches == 0

    def runs(*args):  # the count's address comes last, after the stream
        ctypes.c_int64.from_address(args[-1]).value += 1
        return 0

    kernel._fn = runs
    kernel(None)
    kernel(None)
    assert kernel.launches == 2
    kernel._fn = lambda *args: 1  # a refused launch raises and counts nothing
    kernel.error_string = lambda code: "refused"
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernel(None)
    assert kernel.launches == 2
    kernel.reset_launches()
    assert kernel.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_graph_chunk_equals_loop_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    case = SMALL_CASES[name]("cuda")
    graph = make_chunk(case.cfg, case.step, 20)
    loop = make_chunk(case.cfg, case.step, 20, route="loop")
    assert (graph.mode, loop.mode) == ("graph", "loop")
    sg, mg = graph(case.state, 1.0)
    sl, ml = loop(case.state, 1.0)
    _assert_same(sg, mg, sl, ml)
    # a second call replays the program captured at the first
    program = graph.program
    sg2, mg2 = graph(sg, 0.5)
    sl2, ml2 = loop(sl, 0.5)
    assert graph.program is program
    _assert_same(sg2, mg2, sl2, ml2)


@pytest.mark.cuda
def test_graph_chunk_replays_are_counted_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    case = SMALL_CASES["cavity_fused"]("cuda")
    chunk = make_chunk(case.cfg, case.step, 20, keep_graph=True)
    case.step(case.state, 1.0)  # the kernel's first call is an eager one
    pred.KERNEL.reset_launches()
    chunk(case.state, 1.0)  # the eager warm-up, the capture (no launch), 20 replayed steps
    assert pred.KERNEL.launches == 20 + chunk.steps_per_graph
    chunk(case.state, 1.0)
    assert pred.KERNEL.launches == 40 + chunk.steps_per_graph and chunk.program.nodes > 0
    plain = make_chunk(case.cfg, case.step, 20)
    plain(case.state, 1.0)
    with pytest.raises(RuntimeError, match="not kept"):
        plain.program.nodes
