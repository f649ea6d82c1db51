"""The readers of the program's own spans (``harness/program_spans.py``) on
a recorder filled here: the window is the last chunks the program
recorded, less those that ran under the profiler or captured; a reader
returns None where the program has no recorder or the cell nothing to
read. On a card: the spans add no device operation to what the harness
reads from a trace."""

import sys
import time
import types

import pytest
import torch

from harness import trace
from harness.cells import load_reader
from harness.window import LayerRecord
from cfdsim_tpu_torch.utils import profiling
from cfdsim_tpu_torch.utils.profiling import CAPTURE, CONTROL, COPY_OUT, READ, REPLAY, Recorder

READERS = ("graph_launch_ms_per_chunk", "host_wait_ms_per_chunk",
           "runner_control_ms_per_chunk", "capture_s")


def chunk(rec, replay_s=0.0, read_s=0.0, capture_s=0.0, replays=5, copy_s=0.0):
    """One chunk as the program's graph route and runner record it."""
    rec.begin_chunk(50)
    if capture_s:
        with rec.span(CAPTURE):
            time.sleep(capture_s)
            rec.graph_captures += 1
    for _ in range(replays):
        rec.open(REPLAY)
        time.sleep(replay_s)
        rec.close()
    if replays:
        rec.open(COPY_OUT)
        time.sleep(copy_s)
        rec.close()
    rec.open(READ)
    time.sleep(read_s)
    rec.close()
    rec.close()  # cfd.chunk
    rec.open(CONTROL)
    rec.end_chunk()


def layer_record(untraced: int, traced: int) -> LayerRecord:
    return LayerRecord(cell="c", problem={}, chunk_steps=50, steps=50 * traced, chunks=traced,
                       window=(0.0, 1.0), ops=[], host_gaps_ms=[], counters={},
                       chunk_ms=[1.0] * untraced)


@pytest.fixture()
def rec(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def read(name, record):
    return load_reader(name).read(record)


def test_window_drops_setup_profiled_and_capturing_chunks(rec, monkeypatch):
    chunk(rec, capture_s=0.03)          # set-up: the capture
    chunk(rec, replay_s=0.004)          # set-up
    chunk(rec, replay_s=0.001, read_s=0.002)       # the window's first
    chunk(rec, replay_s=0.001, read_s=0.002, capture_s=0.001)  # a re-capture
    monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", True)
    chunk(rec, replay_s=0.004, read_s=0.004)       # traced
    monkeypatch.setattr(profiling._autograd_profiler, "_is_profiler_enabled", False)
    chunk(rec, replay_s=0.001, read_s=0.002)
    chunk(rec, replay_s=0.001, read_s=0.001, copy_s=0.001)  # the card's wait in the clones
    record = layer_record(untraced=4, traced=1)
    launch = read("graph_launch_ms_per_chunk", record)
    wait = read("host_wait_ms_per_chunk", record)
    # three chunks remain, each with 5 ms of replays and 2 ms of waiting
    assert 5.0 <= launch < 8.0 and 2.0 <= wait < 4.0
    assert 0.0 < read("runner_control_ms_per_chunk", record) < 1.0
    assert 0.029 < read("capture_s", record) < 0.06  # both captures, summed


def test_readers_return_none_with_nothing_to_read(rec):
    record = layer_record(untraced=3, traced=1)
    assert all(read(name, record) is None for name in READERS)  # no chunk at all
    for _ in range(4):
        chunk(rec, replays=0)  # the loop route
    assert read("graph_launch_ms_per_chunk", record) is None
    assert read("host_wait_ms_per_chunk", record) > 0
    assert read("capture_s", record) is None
    assert read("host_wait_ms_per_chunk", layer_record(0, 0)) is None


def test_readers_return_none_without_a_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "cfdsim_tpu_torch.utils.profiling",
                        types.ModuleType("cfdsim_tpu_torch.utils.profiling"))
    record = layer_record(untraced=3, traced=1)
    assert all(read(name, record) is None for name in READERS)


@pytest.mark.cuda
def test_program_spans_add_no_device_op_to_the_trace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' shadows appear only on its timeline")
    import math

    from torch.profiler import ProfilerActivity, profile

    from cfdsim_tpu_torch.cases import lid_cavity
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation

    case = lid_cavity(n=64, Re=100.0, fused_predictor=True, device="cuda")
    sim = Simulation(case.step, case.state, RunnerConfig(t_final=math.inf, chunk_steps=50),
                     n_cells=case.grid.n_cells)
    sim.cfg.max_steps = 50
    sim.run()  # the capture
    counts = {}
    for on in (True, False):
        profiling.RECORDER.enabled = on
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sim.cfg.max_steps += 100
                sim.run()
                torch.cuda.synchronize()
        finally:
            profiling.RECORDER.enabled = True
        device, host = trace.read_profile(prof)
        assert not [o.name for o in device if o.name.startswith("cfd.")]
        counts[on] = sum(1 for o in device if o.kind == "kernel")
        named = {h.name for h in host if h.name.startswith("cfd.")}
        assert named == ({"cfd.chunk", "cfd.graph.replay", "cfd.chunk.copy_out",
                          "cfd.runner.read", "cfd.runner.control"}
                         if on else set())
    assert counts[True] == counts[False] > 0
