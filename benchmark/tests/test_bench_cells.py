"""Every cell of BENCHMARK.json, run through the harness on the CPU at its
configuration's tiny size: the program's answer passes the cell's check,
and the result carries what the driver reads."""

import math

import pytest

from bench_helpers import run_tiny, spec

CELLS = [w["name"] for w in spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    r = run_tiny(name, seed=2**33 + 11)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"cell_updates_per_s", "setup_s"}
    for m in r["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
    assert r["device"]["count"] == 1


@pytest.mark.parametrize("name", CELLS[:1])
def test_traced_run_reports_per_layer_metrics(name):
    r = run_tiny(name, seed=5, seconds=0.6, trace=True)
    assert r["correct"] is True
    assert "runner_host_ms_per_chunk" in r["metrics"]
    assert "breakdown" in r and list(r)[-1] == "checks"
    assert r["device"]["window_s"] > 0


def test_check_carries_the_reference_from_the_start():
    """Set-up's chunks and the window's first are compared as the
    reference carries its own state from the start; the sampled window
    chunk starts from the program's state before it."""
    from harness import window
    from harness.cells import load_cell

    from bench_helpers import tiny_options

    cell = load_cell(CELLS[0])
    out = window.measure(cell, tiny_options(cell, seed=9, seconds=0.6), 0.0, emit=lambda s: None)
    assert [c["index"] for c in out.chain] == list(range(-window.WARM_CHUNKS, 1))
    assert all(c["pre"] is None for c in out.chain)
    assert len(out.sampled) == window.SAMPLED_CHUNKS
    assert all(c["pre"] is not None and c["index"] >= 1 for c in out.sampled)
