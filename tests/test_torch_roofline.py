"""The port's roofline accounting (``utils/roofline.py``), the twin of
tests/test_autotune.py:76-89 on ``cavity_mac`` at 32², on the CPU: the
counts come from a dispatch mode over one eager step (pre-fusion, per aten
op), which runs the same ops on the CPU as on the card, apart from the hand
kernels, whose wrappers report their own cost there."""

import math

import numpy as np
import pytest
import torch

from cfdsim_tpu_torch.cases import build, lid_cavity_mac
from cfdsim_tpu_torch.ops.kernels.cuda_build import report_cost
from cfdsim_tpu_torch.utils import roofline as rl
from cfdsim_tpu_torch.utils.tree import leaves


def test_roofline_costs_and_classification():
    case = lid_cavity_mac(n=32, Re=100.0, device="cpu")
    costs = rl.step_costs(case.step, case.state, 1.0)
    assert costs["flops"] > 32 * 32  # at least O(cells) work
    assert costs["bytes"] > 32 * 32 * 4
    row = rl.roofline(case.step, case.state, 32 * 32, 1e6,
                      {"peak_flops": 1e12, "peak_bw": 1e11}, 1.0)
    assert row["bound"] in ("compute", "bandwidth")
    assert row["ceiling_cells_per_sec"] > 0
    assert 0 < row["pct_of_roof"] < 1e6
    assert row["datasheet_ceiling_cells_per_sec"] > 0
    assert row["counts"].startswith("pre-fusion")


@pytest.mark.parametrize("name, kw", [("cavity_mac", dict(n=32)),
                                      ("cavity_stretched", dict(n=24)),
                                      ("cavity", dict(n=32))])
def test_step_moves_at_least_its_state(name, kw):
    """One step reads its state and writes a new one: the counted bytes are
    at least the state's bytes."""
    case = build(name, device="cpu", **kw)
    state_bytes = sum(x.numel() * x.element_size() for x in leaves(case.state))
    costs = rl.step_costs(case.step, case.state, 1.0)
    assert costs["bytes"] >= state_bytes and costs["aten_ops"] > 10
    assert costs["hand_kernel_launches"] == 0


def test_counting_rules():
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    x = torch.ones(64, 32)
    with rl.CostMode() as mode:
        a @ b
    assert mode.flops == 2 * 8 * 16 * 4 and mode.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    with rl.CostMode() as mode:
        torch.fft.rfft2(x)
    assert mode.flops == pytest.approx(2.5 * x.numel() * math.log2(64 * 32))
    with rl.CostMode() as mode:
        y = x[:, 1:]  # a view moves nothing
        z = torch.empty_like(x)
        z.copy_(x)  # the destination is only written
    assert mode.ops == 1 and mode.bytes == 2 * 4 * x.numel() and y.shape == (64, 31)
    with rl.CostMode() as mode:
        report_cost(100.0, 7.0)  # a hand kernel's wrapper
    assert (mode.bytes, mode.flops, mode.kernels) == (100.0, 7.0, 1)
    report_cost(1.0, 1.0)  # outside a count: nothing to tell


def test_fdm_products_count_as_matmuls():
    case = build("cavity_stretched", n=16, device="cpu")
    fdm = case.step.fdm
    rhs = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32))
    with rl.CostMode() as mode:
        fdm(rhs)
    assert mode.flops >= 4 * 2 * 16**3


def test_measure_peaks_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.measure_peaks("cpu")
