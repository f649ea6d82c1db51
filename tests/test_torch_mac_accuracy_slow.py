"""MAC-grid Re = 1000 cavity against the Botella & Peyret spectral
benchmark on the port (slow; CFDSIM_SLOW_TESTS=1): the twin of
``tests/test_mac_accuracy_slow.py``, its cases, end times and tolerances
(the JAX package measured 6e-3 at 128², 1.6e-3 at 256² and 4.3e-4 at
512² at t = 250; 1.246e-4 at 1024², t = 500, with the incremental
projection). The errors are ``examples/cavity_accuracy_1024.py::
extrema_errors`` of the port.

Runs on ``cuda`` (``CFDSIM_TORCH_TEST_DEVICE=cpu`` names the CPU; the flag
set without CUDA fails). The 1024² north star (~2.6 million steps) also
needs CFDSIM_CHIP_TESTS=1. On the card's machine (no JAX):
``CFDSIM_SLOW_TESTS=1 python -m pytest --noconftest tests/test_torch_mac_accuracy_slow.py``.
"""

import json
import os
import time

import pytest

from test_torch_ghia_slow import slow_test_device

pytestmark = pytest.mark.skipif(
    os.environ.get("CFDSIM_SLOW_TESTS") != "1",
    reason="set CFDSIM_SLOW_TESTS=1 to run the Re=1000 MAC accuracy check",
)


def run_cavity(n, t_end, projection, chunk_steps):
    from cfdsim_tpu_torch.cases import lid_cavity_mac
    from cfdsim_tpu_torch.examples.cavity_accuracy_1024 import extrema_errors
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    device = slow_test_device()
    t0 = time.perf_counter()
    case = lid_cavity_mac(n=n, Re=1000.0, projection=projection, device=device)
    chunk = make_chunk(case.cfg, case.step, chunk_steps)
    s = case.state
    while float(s.t) < t_end:
        s, _ = chunk(s, 1.0)
    errs = extrema_errors(s, n)
    print(json.dumps({"twin": f"mac_accuracy_{n}", "projection": projection, "t": float(s.t),
                      "steps": int(s.step), **errs, "max_err": max(errs.values()),
                      "route": chunk.mode, "wall_s": time.perf_counter() - t0}))
    return errs


@pytest.mark.parametrize("n,t_end,tol", [(128, 200.0, 0.009), (256, 200.0, 0.0028)])
def test_mac_cavity_re1000_vs_spectral(n, t_end, tol):
    errs = run_cavity(n, t_end, "chorin", 2000)
    assert max(errs.values()) < tol, errs


@pytest.mark.skipif(
    os.environ.get("CFDSIM_CHIP_TESTS") != "1",
    reason="1024² to t=500 needs the card (~25 min); set CFDSIM_CHIP_TESTS=1",
)
def test_mac_cavity_re1000_1024_north_star():
    """1024², Re = 1000, incremental projection → ≤ 1.5e-4 max extremum
    error against Botella & Peyret at t = 500."""
    errs = run_cavity(1024, 500.0, "incremental", 5000)
    assert max(errs.values()) <= 1.5e-4, errs
