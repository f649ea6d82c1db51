"""The collocated 3D step and the distributed 3D Poisson solve on gloo ranks
(``parallel/incompressible3d_explicit.py``, through ``make_sharded_step``)
against the JAX package's single-device jitted step: the twin of
tests/test_3d.py:80-92 (``cavity3d(n=16)``, two steps, rtol 1e-4, atol
1e-5, the JAX GSPMD test's) with the case's multigrid, the multigrid down
to levels whose blocks fall below two cells (``mg_min_size=2``: the
residual is gathered at the 4³ level's 2×2-cell blocks and the 2³ level
runs replicated), the pencil DCT and red-black SOR, on one group of 2×2
ranks.
"""

import pytest

from test_torch_sharded_step import (
    STATE_ATOL,
    STATE_RTOL,
    assert_fields,
    jax_run,
    run_beside,
)

CAV = dict(n=16, Re=100.0)
CASES = [
    ("cavity3d", CAV, 2),
    ("cavity3d", dict(CAV, poisson3d=dict(method="mg", iters=2, mg_min_size=2)), 2),
    ("cavity3d", dict(CAV, poisson3d=dict(method="dct")), 2),
    ("cavity3d", dict(CAV, poisson3d=dict(method="rbsor", iters=30)), 2),
]


@pytest.fixture(scope="module")
def results():
    return run_beside(CASES, jax_run)


@pytest.mark.parametrize("k", range(len(CASES)), ids=["mg", "mg_gathered", "dct", "rbsor"])
def test_incompressible3d_explicit_matches_jax(results, k):
    got, ref = results["ranks"][k], results["ref"][k]
    assert_fields(got, ref, STATE_RTOL, STATE_ATOL, ("u", "v", "w"))
    for name in ("dt", "max_vel", "energy", "div_pre"):
        assert got["metrics"][-1][name] == pytest.approx(ref["metrics"][name], rel=1e-4), name
