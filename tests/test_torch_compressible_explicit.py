"""The 2D compressible step on gloo ranks
(``parallel/compressible_explicit.py``, through ``make_sharded_step``)
against the JAX package's single-device jitted step: the twin of
tests/test_parallel.py:87-99 (the MUSCL wedge at 64×32, one step, rtol
1e-4, atol 1e-5, the JAX GSPMD test's) and the same band on the wedge's
mirror-ghost slip wall, its aligned frame, SSP-RK2, and the supersonic
cavity (pinned block, and the real plate under SSP-RK2), on one group of
2×2 ranks.
"""

import pytest

from test_torch_sharded_step import (
    STATE_ATOL,
    STATE_RTOL,
    assert_fields,
    jax_run,
    run_beside,
)

WEDGE = dict(nx=64, ny=32, reconstruction="muscl")
CASES = [
    ("wedge", WEDGE, 1),
    ("wedge", dict(WEDGE, wall_treatment="ghost"), 2),
    ("wedge", dict(WEDGE, frame="wedge_aligned"), 2),
    ("wedge", dict(WEDGE, time_order=2), 2),
    ("cavity_supersonic", dict(nx=64, ny=32), 2),
    ("cavity_supersonic", dict(nx=64, ny=32, real_geometry=True, time_order=2), 2),
]
IDS = ["wedge", "wedge_ghost", "wedge_aligned", "wedge_rk2", "cavity_pinned", "cavity_plate"]


@pytest.fixture(scope="module")
def results():
    return run_beside(CASES, jax_run)


@pytest.mark.parametrize("k", range(len(CASES)), ids=IDS)
def test_compressible_explicit_matches_jax(results, k):
    got, ref = results["ranks"][k], results["ref"][k]
    assert_fields(got, ref, STATE_RTOL, STATE_ATOL, ("U",))
    assert got["step"] == CASES[k][2]
    for name in ("dt", "max_vel", "min_rho", "min_p", "max_mach", "energy"):
        assert got["metrics"][-1][name] == pytest.approx(ref["metrics"][name], rel=1e-4), name
