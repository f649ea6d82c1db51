"""The plain reference against the program's step on the CPU at the
configurations' tiny sizes: from the same start, the same steps give the
same flow to float32 rounding, on every path a cell drives."""

import pytest
import torch

from harness import check, window
from harness.cells import load_cell
from reference.flow2d import METRICS, ReferenceFlow, spacing

from bench_helpers import spec, tiny_options

CELLS = [w["name"] for w in spec()["workloads"]]
STEPS = 6


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_program_step(name):
    cell = load_cell(name)
    opts = tiny_options(cell, seed=77)
    problem = {**cell.problem, **opts.problem_override}
    case = window.build_case(cell, opts)
    du, dv = window.perturbation(problem, cell.config, 77, "cpu")
    state = case.state._replace(u=case.state.u + du, v=case.state.v + dv)
    rows = []
    for _ in range(STEPS):
        state, m = case.step(state, 1.0)
        rows.append([float(x) for x in m])
    flow = ReferenceFlow(problem, "cpu", torch.float32)
    ref, ref_rows = flow.run(flow.initial_state((du, dv)), STEPS)
    import numpy as np

    gaps = check.chunk_gaps({"u": state.u, "v": state.v, "p": state.p,
                             "metrics": np.asarray(rows)}, {**ref, "metrics": ref_rows},
                            spacing(problem))
    for k, v in gaps.items():
        assert v < 2e-5, (k, v)
    assert len(ref_rows[0]) == len(METRICS)
