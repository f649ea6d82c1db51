"""The port's autotuned exact-DCT dispatch (``solvers/autotune.py``), the
twin of tests/test_autotune.py:29-74: every variant is exact and identical;
``"auto"`` measures once, then hits the in-process and the on-disk cache;
``CFDSIM_DCT_VARIANT`` forces a variant; ``resolve_poisson_config`` pins
``"auto"`` when a step is built.

Tolerances are tests/test_autotune.py's: residual < 5e-3·max|rhs|, and
every variant within atol 2e-4 of the rfft solve (observed ≤ 2e-6).
"""

import json

import numpy as np
import pytest
import torch

from cfdsim_tpu_torch.cases import lid_cavity_mac
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.solvers import autotune
from cfdsim_tpu_torch.solvers.poisson import (
    PoissonConfig,
    PoissonSolver,
    poisson_residual,
    solve_poisson,
)

VARIANTS = ["rfft", "rfft2", "rfft_split", "rfft_split4", "rfft_split8", "packed", "matmul"]


@pytest.fixture()
def rhs():
    r = np.random.default_rng(3).standard_normal((48, 64)).astype(np.float32)
    return torch.from_numpy(r - r.mean())


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """A cache directory of the test's own, no forced variant, and an empty
    in-process cache."""
    monkeypatch.setenv("CFDSIM_AUTOTUNE_CACHE", str(tmp_path))
    monkeypatch.delenv("CFDSIM_DCT_VARIANT", raising=False)
    monkeypatch.setattr(autotune, "_MEM", {})
    return tmp_path / "autotune.json"


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_variant_is_exact_and_identical(rhs, variant):
    dx, dy = 1.0 / 64, 1.0 / 48
    phi = solve_poisson(torch.zeros_like(rhs), rhs, dx, dy,
                        PoissonConfig(method="dct", dct_variant=variant))
    res = float(poisson_residual(phi, rhs, dx, dy, None, "neumann"))
    assert res < 5e-3 * float(rhs.abs().max())
    ref = solve_poisson(torch.zeros_like(rhs), rhs, dx, dy, PoissonConfig(method="dct"))
    assert float((phi - ref).abs().max()) <= 2e-4


def test_auto_dispatch_measures_once_and_caches(rhs, cache, monkeypatch):
    dx, dy = 1.0 / 64, 1.0 / 48
    v1 = autotune.best_dct_variant(rhs.shape, dx, dy, device="cpu")
    assert v1 in autotune._VARIANTS
    data = json.loads(cache.read_text())
    (key, entry), = data.items()
    assert key == "cpu|dct2d|48x64" and entry["variant"] == v1
    assert set(entry["ms"]) == set(autotune._VARIANTS)
    assert all(t > 0 for t in entry["ms"].values())
    # the in-process cache answers without timing
    monkeypatch.setattr(autotune, "measure_dct_variants",
                        lambda *a, **k: pytest.fail("re-measured despite the cache"))
    assert autotune.best_dct_variant(rhs.shape, dx, dy, device="cpu") == v1
    # a fresh process (an empty in-process cache) reads the disk
    autotune._MEM.clear()
    assert autotune.best_dct_variant(rhs.shape, dx, dy, device="cpu") == v1
    assert autotune._MEM == {key: v1}
    # the solver built with "auto" is that variant, and solves as rfft does
    solver = PoissonSolver(tuple(rhs.shape), dx, dy,
                           PoissonConfig(method="dct", dct_variant="auto"), device="cpu")
    assert solver.dct.variant == v1
    ref = solve_poisson(torch.zeros_like(rhs), rhs, dx, dy, PoissonConfig(method="dct"))
    assert float((solver(torch.zeros_like(rhs), rhs) - ref).abs().max()) <= 2e-4


def test_deep_variants_join_from_4096():
    assert autotune._variants_for((2048, 4096)) == autotune._VARIANTS
    assert autotune._variants_for((4096, 4096))[-2:] == ("rfft_split4", "rfft_split8")


def test_env_force_overrides(monkeypatch, cache):
    monkeypatch.setenv("CFDSIM_DCT_VARIANT", "matmul")
    monkeypatch.setattr(autotune, "measure_dct_variants",
                        lambda *a, **k: pytest.fail("timed despite the force"))
    assert autotune.best_dct_variant((8, 8), 0.1, 0.1, device="cpu") == "matmul"
    assert not cache.exists()


def test_default_cache_is_under_build(monkeypatch):
    monkeypatch.delenv("CFDSIM_AUTOTUNE_CACHE", raising=False)
    path = autotune._cache_path()
    assert path.name == "autotune.json" and path.parent.parts[-2:] == ("build",
                                                                       "cfdsim_tpu_torch")


def test_resolve_pins_auto_at_build(cache):
    """``resolve_poisson_config`` turns "auto" into the measured winner, and
    a MAC step built with "auto" carries the pinned config (its captured
    chunk never times anything)."""
    pois = PoissonConfig(method="dct", dct_variant="auto")
    pinned = autotune.resolve_poisson_config(pois, (16, 16), 1 / 16, 1 / 16, device="cpu")
    assert pinned.dct_variant in autotune._VARIANTS and pinned.method == "dct"
    mg = PoissonConfig(method="mg")
    assert autotune.resolve_poisson_config(mg, (16, 16), 0.1, 0.1, device="cpu") is mg
    case = lid_cavity_mac(n=16, poisson=pois, device="cpu")
    assert case.step.cfg.poisson == pinned
    assert isinstance(case.step, mac.MACStep)
