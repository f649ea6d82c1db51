"""The trace arithmetic on a synthetic trace: device time is the union of
the operations' intervals, the idle share sets it against the untraced
chunks' wall time, and each idle gap is named by what the host was doing."""

import pytest

from harness import trace
from harness.cells import load_reader
from harness.trace import DeviceOp, HostOp
from harness.window import LayerRecord


def ops():
    # two overlapping kernels, a copy, and a kernel after an idle gap
    return [DeviceOp("k1", 10.0, 20.0, "kernel"), DeviceOp("k2", 15.0, 30.0, "kernel"),
            DeviceOp("Memcpy DtoD", 30.0, 32.0, "memcpy"), DeviceOp("k1", 60.0, 70.0, "kernel")]


def test_union_counts_overlap_once():
    assert trace.union_length([(o.start, o.end) for o in ops()]) == pytest.approx(32.0)
    assert trace.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3), (5, 7)]


def test_gaps_within_a_window():
    iv = [(o.start, o.end) for o in ops()]
    assert trace.gaps(iv, 0.0, 80.0) == [(0.0, 10.0), (32.0, 60.0), (70.0, 80.0)]


def record(window=(0.0, 80.0)):
    return LayerRecord(cell="c", problem={"ny": 4, "nx": 4}, chunk_steps=2, steps=2, chunks=1,
                       window=window, ops=ops(), host_gaps_ms=[0.5, 1.5], counters={},
                       chunk_ms=[0.03, 0.05])


def test_idle_share_and_device_time_readers():
    # 32 µs of device time a chunk against 0.04 ms of chunk and 1 ms of runner
    assert load_reader("device_idle_share").read(record()) == pytest.approx(
        100.0 * (1.0 - 0.032 / 1.04))
    no_runner = record()
    no_runner.host_gaps_ms = []
    assert load_reader("device_idle_share").read(no_runner) == pytest.approx(20.0)
    assert load_reader("step_device_ms").read(record()) == pytest.approx(0.016)
    assert load_reader("kernels_per_step").read(record()) == pytest.approx(1.5)
    assert load_reader("runner_host_ms_per_chunk").read(record()) == pytest.approx(1.0)
    chunks = record()
    chunks.chunk_ms = [float(i) for i in range(1, 101)]
    assert load_reader("chunk_ms_p95").read(chunks) == pytest.approx(95.05)


def test_readers_with_nothing_to_read_return_none():
    empty = LayerRecord(cell="c", problem={"ny": 4, "nx": 4, "poisson": {}}, chunk_steps=2,
                        steps=2, chunks=1, window=(0.0, 1.0), ops=[], host_gaps_ms=[],
                        counters={})
    for name in ("device_idle_share", "step_device_ms", "kernels_per_step",
                 "runner_host_ms_per_chunk", "pressure_sweeps_per_step", "fft_ms_per_step",
                 "predictor_ms_per_step", "kernel_a_roofline", "kernel_b_roofline",
                 "chunk_ms_p95"):
        assert load_reader(name).read(empty) is None, name


def test_breakdown_names_gaps_by_host_activity():
    host = [HostOp(trace.CHUNK_SPAN, 0.0, 50.0), HostOp("cudaGraphLaunch", 0.0, 12.0),
            HostOp("cudaStreamSynchronize", 30.0, 50.0)]
    b = trace.breakdown(ops(), host, 0.0, 80.0)
    assert b["device_ops"][0][0] == "k1"
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    idle = dict(b["idle_gaps"])
    assert idle["chunk: cudaGraphLaunch"] == pytest.approx(10e-6)
    assert idle["chunk: cudaStreamSynchronize"] == pytest.approx(28e-6)
    assert idle["runner between chunks"] == pytest.approx(10e-6)


def test_kernel_b_roofline_refuses_another_launch_count():
    """Kernel B's bound counts one finest-level pass a launch; where a
    step holds another number of launches it raises, not inflate it."""
    reader = load_reader("kernel_b_roofline")
    b = [DeviceOp("void rbsor_blocked_kernel<2>(float*)", 10.0 * i, 10.0 * i + 8.0, "kernel")
         for i in range(8)]
    rec = LayerRecord(cell="c", problem={"ny": 1024, "nx": 1024, "poisson": {
        "cycles": 2, "pre": 2, "post": 2}}, chunk_steps=2, steps=2, chunks=1,
        window=(0.0, 100.0), ops=b, host_gaps_ms=[], counters={})
    assert reader.read(rec) == pytest.approx(100.0 * 3.76e-3 / 8e-3, rel=2e-3)
    rec.ops = b + b[:2]
    with pytest.raises(ValueError, match="finest level"):
        reader.read(rec)
