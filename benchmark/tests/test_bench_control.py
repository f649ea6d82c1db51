"""The check refuses what it must: the controls (the program's own
bfloat16 storage path, and the reference computed in bfloat16 in the
program's place; bfloat16 is the precision below the configuration's
float32), and each fault a cell can have planted under the timed path: a
step that returns its state unchanged, and an answer altered where it is
produced. At the tiny sizes, through the harness's whole run but the look
for a card."""

import pytest
import torch

from harness import check, faults, window
from harness.cells import load_cell
from reference.flow2d import ReferenceFlow, spacing

from bench_helpers import run_tiny, spec, tiny_options

CELLS = [w["name"] for w in spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_program_bf16_control_fails_the_check(name):
    """The control: the program's own lower-precision path, u and v kept
    in bfloat16 between steps."""
    r = run_tiny(name, seed=31, args_override={"storage": "bf16"})
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_bf16_control_fails_the_check(name):
    """The reference computed in bfloat16, put in the program's place."""
    cell = load_cell(name)
    out = window.measure(cell, tiny_options(cell, seed=31), 0.0, emit=lambda s: None)
    chunks = window.compared(out)
    refs = check.follow(ReferenceFlow(out.problem, "cpu", torch.float32), chunks,
                        out.perturbation, out.chunk_steps)
    low = check.follow(ReferenceFlow(out.problem, "cpu", torch.bfloat16), chunks,
                       out.perturbation, out.chunk_steps)
    worst = check.worst([check.chunk_gaps(a, r, spacing(out.problem))
                         for a, r in zip(low, refs)])
    assert any(worst[k] > float(cell.limits[k]) for k in check.NUMBERS), worst


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    r = run_tiny(name, seed=2**32 + 1, step_hook=faults.hook(fault))
    assert r["correct"] is False, r["checks"]
    assert r["failed"] >= 1
