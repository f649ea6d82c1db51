"""High-Re Ghia cavity regression at 128² on the port (slow;
CFDSIM_SLOW_TESTS=1): the twin of ``tests/test_ghia_slow.py``, its cases,
end times and tolerances (measured on the JAX package + 20%).

Runs on ``cuda`` (500-step chunks, one CUDA graph of 10 steps replayed);
``CFDSIM_TORCH_TEST_DEVICE=cpu`` names the CPU. With the flag set and no
CUDA the test fails: it neither skips nor falls back to the CPU. On the
card's machine (no JAX) run it without ``tests/conftest.py``:
``CFDSIM_SLOW_TESTS=1 python -m pytest --noconftest tests/test_torch_ghia_slow.py``.
"""

import json
import os
import time

import pytest
import torch

pytestmark = pytest.mark.skipif(
    os.environ.get("CFDSIM_SLOW_TESTS") != "1",
    reason="set CFDSIM_SLOW_TESTS=1 to run high-Re Ghia regressions",
)


def slow_test_device() -> torch.device:
    """``CFDSIM_TORCH_TEST_DEVICE`` (default cuda); fails without CUDA."""
    device = torch.device(os.environ.get("CFDSIM_TORCH_TEST_DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        pytest.fail("CUDA is not available: the slow twins run on the card "
                    "(CFDSIM_TORCH_TEST_DEVICE=cpu names the CPU)")
    return device


@pytest.mark.parametrize("Re,t_end,tol", [(100, 30.0, 0.006),
                                          (400, 60.0, 0.029),
                                          (1000, 100.0, 0.10)])
def test_ghia_profiles_128(Re, t_end, tol):
    from cfdsim_tpu_torch.cases import lid_cavity
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.validation import ghia_error

    device = slow_test_device()
    t0 = time.perf_counter()
    case = lid_cavity(n=128, Re=float(Re), diffusion="implicit", cfl=0.6, device=device)
    chunk = make_chunk(case.cfg, case.step, 500)
    state = case.state
    while float(state.t) < t_end:
        state, _ = chunk(state, 1.0)
    assert bool(torch.isfinite(state.u).all())
    eu, ev = (float(e) for e in ghia_error(state.u.cpu().numpy(), state.v.cpu().numpy(), Re,
                                           case.grid.y_coords(), case.grid.x_coords()))
    print(json.dumps({"twin": "ghia_128", "Re": Re, "t": float(state.t),
                      "steps": int(state.step), "eu": eu, "ev": ev, "tol": tol,
                      "route": chunk.mode, "wall_s": time.perf_counter() - t0}))
    assert eu < tol, f"Re={Re} u-profile RMS {eu}"
    assert ev < tol, f"Re={Re} v-profile RMS {ev}"
