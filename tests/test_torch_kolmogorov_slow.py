"""Stationary inverse-cascade regression on the port (slow;
CFDSIM_SLOW_TESTS=1): the twin of ``tests/test_kolmogorov_slow.py``,
through the port's ``examples/kolmogorov_spectrum.py::run``: the 256²
pseudo-spectral tier with linear Ekman friction to t = 40 at dt = 1e-3; the
tail-averaged E(k) peaks at the friction-arrest shell (2-8), the inverse
band's slope lies in (−2.0, −1.1) and the enstrophy range's is below −2.5,
the JAX file's bounds.

Runs on ``cuda`` (``CFDSIM_TORCH_TEST_DEVICE=cpu`` names the CPU; the flag
set without CUDA fails). On the card's machine (no JAX):
``CFDSIM_SLOW_TESTS=1 python -m pytest --noconftest tests/test_torch_kolmogorov_slow.py``.
"""

import json
import os
import time

import pytest

from test_torch_ghia_slow import slow_test_device

pytestmark = pytest.mark.skipif(
    os.environ.get("CFDSIM_SLOW_TESTS") != "1",
    reason="set CFDSIM_SLOW_TESTS=1 to run the cascade regression",
)


def test_stationary_inverse_cascade_256():
    from cfdsim_tpu_torch.examples.kolmogorov_spectrum import run

    device = slow_test_device()
    t0 = time.perf_counter()
    r = run(n=256, t_final=40.0, k_force=32, nu=1e-5, alpha=0.1, forcing_scale=0.5,
            noise=0.05, dt=1e-3, solver="ps", verbose=False, device=device)
    print(json.dumps({"twin": "kolmogorov_256", "k_peak": r["k_peak"],
                      "slope_inverse": r["slope_inverse"], "slope_direct": r["slope_direct"],
                      "wall_s": time.perf_counter() - t0}))
    # arrest peak below the injection shell, clear of the box scale
    assert 2 <= r["k_peak"] <= 8, r["k_peak"]
    # the inverse-cascade band within the measured window of -5/3
    assert -2.0 < r["slope_inverse"] < -1.1, r["slope_inverse"]
    # the enstrophy range steeper than -2.5 (ideal -3)
    assert r["slope_direct"] < -2.5, r["slope_direct"]
