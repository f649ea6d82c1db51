"""The 3D compressible step on gloo ranks
(``parallel/compressible3d_explicit.py``, through ``make_sharded_step``)
against the JAX package's single-device jitted step: the twin of
tests/test_parallel.py:222-252 (``blast3d(n=16)``, five steps, rtol 1e-4,
atol 1e-5, the JAX GSPMD test's), and SSP-RK2, on one group of 2×2 ranks
((5, 16, 8, 8) blocks).
"""

import pytest

from test_torch_sharded_step import (
    STATE_ATOL,
    STATE_RTOL,
    assert_fields,
    jax_run,
    run_beside,
)

CASES = [("blast3d", dict(n=16), 5), ("blast3d", dict(n=16, time_order=2), 3)]


@pytest.fixture(scope="module")
def results():
    return run_beside(CASES, jax_run)


@pytest.mark.parametrize("k", range(len(CASES)), ids=["euler", "rk2"])
def test_compressible3d_explicit_matches_jax(results, k):
    got, ref = results["ranks"][k], results["ref"][k]
    assert_fields(got, ref, STATE_RTOL, STATE_ATOL, ("U",))
    for name in ("dt", "max_vel", "min_rho", "min_p", "max_mach", "energy"):
        assert got["metrics"][-1][name] == pytest.approx(ref["metrics"][name], rel=1e-4), name
