"""The stable-fluids (Kolmogorov) step on gloo ranks
(``parallel/spectral_explicit.py``, through ``make_sharded_step``) against
the JAX package's single-device jitted step: the twin of
tests/test_parallel.py:102-118 (64×64, seeded white-noise u and v, one
step, rtol 1e-5, atol 1e-5, the JAX GSPMD test's), and BFECC advection and
three steps in the same band, on one group of 2×2 ranks. The white noise
fills the Nyquist lines, where the full-spectrum projection must give the
rfft half spectrum's result.
"""

import pytest

from test_torch_sharded_step import assert_fields, jax_run, run_beside

RTOL = ATOL = 1e-5  # tests/test_parallel.py:115-116
KOL = dict(ny=64, aspect=1.0, random_uv=0)
CASES = [("kolmogorov", KOL, 1), ("kolmogorov", dict(KOL, advection="bfecc"), 1),
         ("kolmogorov", KOL, 3)]


@pytest.fixture(scope="module")
def results():
    return run_beside(CASES, jax_run)


@pytest.mark.parametrize("k", range(len(CASES)), ids=["sl", "bfecc", "sl_3_steps"])
def test_spectral_explicit_matches_jax(results, k):
    got, ref = results["ranks"][k], results["ref"][k]
    assert_fields(got, ref, RTOL, ATOL, ("u", "v"))
    for name in ("max_vel", "energy"):
        assert got["metrics"][-1][name] == pytest.approx(ref["metrics"][name], rel=RTOL), name
    # the spectral divergence after the projection is rounding on both sides
    assert got["metrics"][-1]["max_div"] < 1e-6 and ref["metrics"]["max_div"] < 1e-6
