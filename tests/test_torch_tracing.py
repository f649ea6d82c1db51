"""The port's recorder of spans and counters (``utils/profiling.py``): spans
nest and share their chunk's index in memory of a fixed size; while a
``torch.profiler`` runs each span is also a ``record_function`` range, and
never without one; the runner, the chunk on both routes, the kernel build
and the autotuner record where the work happens; ``PerfTracker`` reads its
rates from the recorder and leaves out a chunk that captured.

This file imports no JAX, so that its ``cuda`` test runs on a card's
machine: ``python -m pytest --noconftest tests/test_torch_tracing.py``.
"""

import math
import time

import pytest
import torch

from cfdsim_tpu_torch.cases import lid_cavity
from cfdsim_tpu_torch.models.incompressible import Chunk
from cfdsim_tpu_torch.ops.kernels import cuda_build
from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
from cfdsim_tpu_torch.solvers import autotune
from cfdsim_tpu_torch.utils import graphs, profiling
from cfdsim_tpu_torch.utils.profiling import (
    AUTOTUNE,
    CAPTURE,
    CHUNK,
    CONTROL,
    COPY_OUT,
    KERNEL_BUILD,
    READ,
    REPLAY,
    RECORDER,
    PerfTracker,
    Recorder,
)


def fake_chunk(rec, steps=50, replays=5, capture_s=0.0):
    """One chunk as the graph route and the runner record it."""
    rec.begin_chunk(steps)
    if capture_s:
        with rec.span(CAPTURE):
            time.sleep(capture_s)
            rec.graph_captures += 1
    for _ in range(replays):
        rec.open(REPLAY)
        rec.close()
    rec.open(COPY_OUT)
    rec.close()
    rec.open(READ)
    rec.close()
    rec.close()  # cfd.chunk
    rec.open(CONTROL)
    rec.end_chunk()


def test_spans_nest_share_the_chunk_index_and_stay_within_the_bound(monkeypatch):
    monkeypatch.setattr(profiling, "CHUNKS_HELD", 4)
    monkeypatch.setattr(profiling, "SETUP_SPANS_HELD", 2)
    rec = Recorder()
    fake_chunk(rec, capture_s=1e-3)
    (c,) = rec.chunk_records()
    assert (c.index, c.steps, c.replays, c.captures, c.profiled) == (0, 50, 5, 1, False)
    for name in ("cfd.chunk", "cfd.graph.replay", "cfd.chunk.copy_out", "cfd.runner.read",
                 "cfd.runner.control", "cfd.capture"):
        assert c.ms(name) > 0, name
    # the children lie inside cfd.chunk; the control span follows it
    inside = sum(c.ms(n) for n in ("cfd.capture", "cfd.graph.replay", "cfd.chunk.copy_out",
                                   "cfd.runner.read"))
    assert 1.0 <= inside <= c.ms("cfd.chunk")
    assert rec.setup[-1].chunk == 0 and rec.setup[-1].name == "cfd.capture"
    assert rec.wall_ns == c.ns[CHUNK] + c.ns[CONTROL] and rec.steady_steps == 0
    for _ in range(4 + 1 + 3):  # past N + 1 chunks, and set-up spans past theirs
        fake_chunk(rec, capture_s=1e-4)
    assert [c.index for c in rec.chunk_records()] == [5, 6, 7, 8]
    assert [c.index for c in rec.chunk_records(since=7)] == [7, 8]
    assert [s.chunk for s in rec.setup] == [7, 8] and rec.setup_spans == 9
    assert rec._stack == [] and rec._cur == -1


def test_one_chunk_may_open_any_number_of_spans():
    rec = Recorder()
    perf = PerfTracker(n_cells=10, recorder=rec)
    for replays in (5, 100_000, 5):
        fake_chunk(rec, replays=replays)
        perf.add_steps(50)
    big = rec.chunk_records()[1]
    assert big.replays == 100_000
    assert big.ms("cfd.graph.replay") <= big.ms("cfd.chunk")
    total = sum(c.ns[CHUNK] + c.ns[CONTROL] for c in rec.chunk_records())
    assert perf.elapsed == pytest.approx(1e-9 * total)
    assert perf.steps_per_sec == pytest.approx(150 / (1e-9 * total))


def test_spans_enter_the_profiler_only_while_it_runs(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = Recorder()
    fake_chunk(rec)
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fake_chunk(rec)
        with rec.span(KERNEL_BUILD):  # a set-up span outside a chunk
            pass
    fake_chunk(rec)
    with rec.span(KERNEL_BUILD):
        pass
    assert len(entered) == 10 and entered[0] == "cfd.chunk"
    assert [c.profiled for c in rec.chunk_records()] == [False, True, False]
    ours = [e for e in prof.events() if e.name.startswith("cfd.")]
    assert sorted(e.name for e in ours) == sorted(
        ["cfd.chunk", "cfd.chunk.copy_out", "cfd.runner.read",
         "cfd.runner.control", "cfd.kernel.build"] + ["cfd.graph.replay"] * 5)
    parents = {e.name: (e.cpu_parent.name if e.cpu_parent else None) for e in ours}
    assert parents["cfd.graph.replay"] == "cfd.chunk"
    assert parents["cfd.runner.read"] == "cfd.chunk"
    assert parents["cfd.runner.control"] is None and parents["cfd.chunk"] is None


def test_loop_route_simulation_fills_every_chunk():
    case = lid_cavity(n=32, Re=100.0, device="cpu")
    first = RECORDER.chunks
    sim = Simulation(case.step, case.state,
                     RunnerConfig(t_final=math.inf, max_steps=12, chunk_steps=4),
                     n_cells=case.grid.n_cells)
    _, report = sim.run()
    assert sim.chunk.mode == "loop"
    records = RECORDER.chunk_records(since=first)
    assert [c.index for c in records] == [first, first + 1, first + 2]
    for c in records:
        for name in ("cfd.chunk", "cfd.chunk.loop", "cfd.runner.read", "cfd.runner.control"):
            assert c.ms(name) is not None and c.ms(name) > 0, (c.index, name)
        assert c.ms("cfd.graph.replay") is None and c.replays == 0 and c.steps == 4
        assert c.ms("cfd.chunk.loop") + c.ms("cfd.runner.read") <= c.ms("cfd.chunk")
    assert report["chunk_route"] == "loop" and report["graph_captures"] == 0
    assert report["chunk_host_ms"]["launch"] > 0  # the loop span, on this route
    assert report["chunk_host_ms"]["wait"] > 0 and report["chunk_host_ms"]["control"] > 0
    assert report["steps_per_sec"] > 0 and report["total_steps"] == 12


def test_perf_tracker_rate_leaves_out_a_chunk_that_captured():
    rec = Recorder()
    perf = PerfTracker(n_cells=100, recorder=rec)
    fake_chunk(rec, steps=50, capture_s=0.05)
    for _ in range(3):
        fake_chunk(rec, steps=50)
        perf.add_steps(50)
    records = rec.chunk_records()
    assert [c.captures for c in records] == [1, 0, 0, 0]
    kept_s = 1e-9 * sum(c.ns[profiling.CHUNK] + c.ns[profiling.CONTROL] for c in records[1:])
    assert perf.steps_per_sec == pytest.approx(150 / kept_s)
    assert perf.cell_updates_per_sec == pytest.approx(100 * 150 / kept_s)
    assert perf.elapsed > 0.05 + kept_s  # the capture stays in the wall
    report = perf.report()
    assert report["graph_captures"] == 1 and report["chunk_host_ms"]["launch"] > 0
    assert report["setup"]["capture_s"] >= 0.05
    assert not hasattr(perf, "_t0")


def test_setup_seconds_leave_kernel_builds_out_of_the_capture():
    rec = Recorder()
    with rec.span(CAPTURE) as cap:
        t0 = time.perf_counter_ns()
        time.sleep(0.02)
        rec.record(KERNEL_BUILD, t0, time.perf_counter_ns())
    t0 = time.perf_counter_ns()
    rec.record(KERNEL_BUILD, t0, t0 + 10**6)
    build_in, capture = rec.setup[0], rec.setup[1]
    assert capture.name == "cfd.capture" and capture.serial == 1 and build_in.chunk == -1
    assert capture.start_ns <= build_in.start_ns <= build_in.end_ns <= capture.end_ns
    s = rec.setup_seconds()
    assert s["capture_s"] == pytest.approx(cap.seconds - 1e-9 * (build_in.end_ns
                                                                 - build_in.start_ns))
    assert s["kernel_build_s"] == pytest.approx(1e-9 * (build_in.end_ns - build_in.start_ns)
                                                + 1e-3)
    assert s["autotune_s"] is None
    assert rec.setup_seconds(since=2)["capture_s"] is None


def test_report_holds_its_own_simulations_setup():
    rec = Recorder()
    first = PerfTracker(n_cells=1, recorder=rec)
    fake_chunk(rec, capture_s=0.01)
    rec.count_compile()
    assert first.report()["setup"]["capture_s"] >= 0.01
    with rec.span(AUTOTUNE):  # the next case, built before its simulation
        pass
    second = PerfTracker(n_cells=1, recorder=rec)
    fake_chunk(rec)
    setup = second.report()["setup"]
    assert setup["capture_s"] is None and setup["autotune_s"] > 0
    assert setup["kernel_compiles"] == 0 and first.report()["setup"]["kernel_compiles"] == 1
    assert second.report()["graph_captures"] == 0 and first.report()["graph_captures"] == 1


def test_kernel_build_and_autotune_are_recorded(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_nvcc(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    compiles, spans = RECORDER.kernel_compiles, RECORDER.setup_spans
    cuda_build.build_library("predictor.cu")
    cuda_build.build_library("predictor.cu")
    assert RECORDER.kernel_compiles == compiles + 1  # the second loads
    assert [s.name for s in RECORDER.setup if s.serial >= spans] == ["cfd.kernel.build"] * 2
    autotune.measure_dct_variants((8, 8), 0.125, 0.125, device="cpu", turns=1, reps=1)
    assert RECORDER.setup[-1].name == "cfd.autotune"
    assert RECORDER.setup_seconds(since=spans)["autotune_s"] > 0


class _EagerProgram(graphs.CapturedProgram):
    """A stand-in for the captured program on the CPU: ``replay`` is
    ``CapturedProgram.replay`` itself, running ``fn`` where a card would
    launch its graph."""

    class _Plans:
        size = 0

    class _Graph:
        def __init__(self, fn):
            self.replay = fn

    def __init__(self, fn, keep_graph=False):
        fn()  # the eager pass
        self.graph = self._Graph(fn)
        self._plans, self.plans_at_capture = self._Plans(), 0
        self.kept, self.replays, self.capture_seconds = False, 0, 0.0
        RECORDER.graph_captures += 1


def _graph_route_records(sim, chunks):
    first = RECORDER.chunks
    sim.cfg.max_steps = int(sim.state.step) + chunks * sim.cfg.chunk_steps
    sim.run()
    return RECORDER.chunk_records(since=first)


def _check_graph_route(records, steps_per_graph):
    assert [c.captures for c in records] == [1] + [0] * (len(records) - 1)
    for c in records:
        assert c.replays == c.steps // steps_per_graph
        for name in ("cfd.graph.replay", "cfd.chunk.copy_out", "cfd.runner.read",
                     "cfd.runner.control"):
            assert c.ms(name) is not None, (c.index, name)
        assert c.ms("cfd.chunk.loop") is None
    assert records[0].ms("cfd.capture") is not None


def test_program_replays_inside_a_step_are_not_the_chunks_launch(monkeypatch):
    """A step that replays programs of its own (the Krylov solvers' loop
    bodies) on the loop route: those replays are neither spans nor the
    chunk's replays."""
    monkeypatch.setattr(graphs, "CapturedProgram", _EagerProgram)
    case = lid_cavity(n=16, Re=100.0, device="cpu")
    inner = graphs.CapturedProgram(lambda: None)

    def step(state, cfl):
        for _ in range(40):
            inner.replay()
        return case.step(state, cfl)

    sim = Simulation(step, case.state, RunnerConfig(t_final=math.inf, chunk_steps=5),
                     n_cells=case.grid.n_cells)
    sim.chunk = Chunk(step, 5, "cpu", "loop", "a step with programs of its own")
    records = _graph_route_records(sim, 2)
    assert inner.replays == 400
    assert [c.replays for c in records] == [0, 0] and [c.captures for c in records] == [0, 0]
    assert all(c.ms("cfd.graph.replay") is None and c.ms("cfd.chunk.loop") for c in records)


def test_graph_route_spans_against_a_stub_program(monkeypatch):
    monkeypatch.setattr(graphs, "CapturedProgram", _EagerProgram)
    case = lid_cavity(n=16, Re=100.0, device="cpu")
    sim = Simulation(case.step, case.state, RunnerConfig(t_final=math.inf, chunk_steps=50),
                     n_cells=case.grid.n_cells)
    sim.chunk = Chunk(case.step, 50, "cpu", "graph", "a stub program")
    records = _graph_route_records(sim, 3)
    assert [c.replays for c in records] == [5, 5, 5]
    _check_graph_route(records, 10)
    assert sim.perf.report()["graph_captures"] == 1


@pytest.mark.cuda
def test_graph_route_spans_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    case = lid_cavity(n=64, Re=100.0, fused_predictor=True, device="cuda")
    sim = Simulation(case.step, case.state, RunnerConfig(t_final=math.inf, chunk_steps=50),
                     n_cells=case.grid.n_cells)
    assert sim.chunk.mode == "graph"
    records = _graph_route_records(sim, 3)
    assert [c.replays for c in records] == [5, 5, 5]
    _check_graph_route(records, 10)
    record = [s for s in RECORDER.setup if s.name == "cfd.capture.record"][-1]
    assert sim.chunk.program.capture_seconds == pytest.approx(
        1e-9 * (record.end_ns - record.start_ns))
    assert sim.perf.report()["chunk_host_ms"]["launch"] > 0
