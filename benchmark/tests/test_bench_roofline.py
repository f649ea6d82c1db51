"""The kernels' work formulas and the published peaks give the bound times
that the repo's kernel table has held since the kernels were written:
kernel A 0.000878 ms for one 50-sweep masked chunk at 600×180, kernel B
0.00376 ms for a 2-sweep pass at 1024², and the predictor's 0.00501 ms at
1024² from the same peaks (its share is not reported: see its metric)."""

import pytest

from harness.cells import load_cell, load_reader
from reference.flow2d import fluid_cells


def test_predictor_bound():
    from harness.peaks import bound_seconds

    cells = 1024 * 1024  # u, v read and u*, v* written; 40 operations a cell
    assert bound_seconds(16.0 * cells, 40.0 * cells) * 1e3 == pytest.approx(0.00501, abs=5e-6)


def test_kernel_a_bound_per_chunk():
    r = load_reader("kernel_a_roofline")
    problem = load_cell("cylinder600x180.rbsor").problem
    assert fluid_cells(problem) == 106_948
    assert r.bound_per_launch(problem, 50) * 1e3 == pytest.approx(0.000878, abs=5e-7)


def test_kernel_b_bound_per_pass():
    r = load_reader("kernel_b_roofline")
    assert r.bound_per_launch(1024, 1024, 2) * 1e3 == pytest.approx(0.00376, abs=5e-6)


def test_roofline_share_is_none_without_a_time():
    from harness.peaks import roofline_percent

    assert roofline_percent(1.0, 0.0) is None
    assert roofline_percent(1.0, 4.0) == 25.0
