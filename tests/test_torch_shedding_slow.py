"""Kármán vortex-street / Strouhal regression on the port (slow;
CFDSIM_SLOW_TESTS=1): the twin of ``tests/test_shedding_slow.py``, through
the port's ``examples/cylinder_shedding.py::run_shedding`` at Re = 150,
300×90, to t = 70: shedding must exist (probe amplitude > 0.1) with St in
[0.12, 0.27], the JAX file's band.

Runs on ``cuda`` (``CFDSIM_TORCH_TEST_DEVICE=cpu`` names the CPU; the flag
set without CUDA fails). On the card's machine (no JAX):
``CFDSIM_SLOW_TESTS=1 python -m pytest --noconftest tests/test_torch_shedding_slow.py``.
"""

import json
import os
import time

import numpy as np
import pytest

from test_torch_ghia_slow import slow_test_device

pytestmark = pytest.mark.skipif(
    os.environ.get("CFDSIM_SLOW_TESTS") != "1",
    reason="set CFDSIM_SLOW_TESTS=1 to run shedding regression",
)


def test_cylinder_vortex_shedding_strouhal():
    from cfdsim_tpu_torch.examples.cylinder_shedding import run_shedding
    from cfdsim_tpu_torch.validation import strouhal_number

    device = slow_test_device()
    t0 = time.perf_counter()
    times, probe, case, state = run_shedding(Re=150.0, t_final=70.0, nx=300, ny=90,
                                             verbose=False, device=device)
    n0 = int(0.4 * len(probe))
    sample_dt = float(np.mean(np.diff(times[n0:])))
    amp = float(np.std(probe[n0:]))
    St = strouhal_number(probe[n0:], sample_dt, 2 * case.extras["radius"], 1.0)
    print(json.dumps({"twin": "shedding_re150", "t": float(state.t), "steps": int(state.step),
                      "St": St, "amplitude": amp, "wall_s": time.perf_counter() - t0}))
    assert amp > 0.1, f"no vortex shedding (probe amplitude {amp})"
    assert 0.12 <= St <= 0.27, f"Strouhal {St} outside plausible band"
