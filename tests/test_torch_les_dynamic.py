"""The dynamic Smagorinsky (Germano–Lilly) model of the port
(``ops/les_dynamic.py``) against the JAX package's
``cfdsim_tpu.ops.les_dynamic``.

Tolerances:
- ``box_filter_3d`` preserves a constant to 1e-6 (tests/test_les_dynamic.py:28);
- ``lilly_integrand_3d`` pointwise within 1e-6 of each field's max
  (float32 products and filters on both sides; XLA may contract them into
  FMAs);
- ``dynamic_cs2_3d`` where it activates (the broadband field of
  tests/test_les_dynamic.py:52-74): within 1e-6·κ relative, κ =
  Σ|L·M| / |Σ L·M| over the contracted cells (80 on this field). The
  quotient is a ratio of two float32 volume sums of ~10⁴ terms of both
  signs, summed in XLA's order on one side and ``torch.sum``'s on the
  other; a float32 sum's rounding is ~1e-6 of the sum of its terms'
  magnitudes, which the cancellation in ⟨LM⟩ lifts by κ (measured 7.9e-6:
  the port's float32 quotient is within 1e-7 of its float64 sum, the JAX
  package's 7.9e-6 from it); the masked contraction by the same rule (κ
  4.2; measured 6.4e-7);
- on a resolved field (a single Taylor–Green mode) the quotient clips at 0
  on both sides, or stays below 2% of the static coefficient, as
  tests/test_les_dynamic.py:42 holds it;
- the fluid masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import ibm_ghost as jg
from cfdsim_tpu.ops import les_dynamic as jl
from cfdsim_tpu_torch import ibm_ghost as tg
from cfdsim_tpu_torch.ops import les_dynamic as tl

FIELD_RTOL = 1e-6
SUM_ROUNDING = 1e-6  # a float32 sum's rounding, of the sum of its terms' magnitudes


def _tgv_centers(n, h, k=1.0):
    xc = (np.arange(n) + 0.5) * h
    u = np.sin(k * xc)[None, None, :] * np.cos(k * xc)[None, :, None] * np.cos(
        k * xc)[:, None, None]
    v = -np.cos(k * xc)[None, None, :] * np.sin(k * xc)[None, :, None] * np.cos(
        k * xc)[:, None, None]
    return tuple(a.astype(np.float32) for a in (u, v, np.zeros((n, n, n))))


def _noise(n, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, n, n)).astype(np.float32) for _ in range(3))


def _t(fields):
    return tuple(torch.tensor(a) for a in fields)


def _kappa(fields, h, mask=None):
    """κ = Σ|L·M| / |Σ L·M| over the cells the quotient contracts."""
    lm, _ = tl.lilly_integrand_3d(*_t(fields), 0.5 / h, 0.5 / h, 0.5 / h, h * h)
    if mask is not None:
        lm = torch.where(torch.tensor(mask), lm, 0.0)
    lm = lm[3:-3, 3:-3, 3:-3].double()
    return float(lm.abs().sum() / lm.sum().abs())


def test_box_filter_preserves_constants_and_smooths():
    f = torch.full((8, 9, 10), 3.25)
    assert float((tl.box_filter_3d(f) - 3.25).abs().max()) < 1e-6
    g = torch.tensor(np.random.default_rng(0).standard_normal((16, 16, 16)).astype(np.float32))
    gf = tl.box_filter_3d(g)
    assert float(gf.std()) < float(g.std())
    assert float(gf.max()) <= float(g.max()) + 1e-6 and float(gf.min()) >= float(g.min()) - 1e-6
    want = np.asarray(jax.jit(jl.box_filter_3d)(jnp.asarray(g.numpy())))
    assert float(np.abs(gf.numpy() - want).max()) <= FIELD_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_lilly_integrand_matches_jax(stretched):
    n = 16
    h = np.pi / n
    fields = _noise(n, 2)
    if stretched:  # per-axis gap vectors and a Δ² field, as the stretched tier passes them
        g = 0.5 / (h * (1.0 + 0.3 * np.sin(np.arange(n) * 0.4))).astype(np.float32)
        inv = (g[None, None, :], g[None, :, None], g[:, None, None])
        d2 = ((h * (1.0 + 0.1 * np.cos(np.arange(n))))[:, None, None] ** 2
              * np.ones((n, n, n))).astype(np.float32)
        args_j = tuple(jnp.asarray(a) for a in inv) + (jnp.asarray(d2),)
        args_t = tuple(torch.tensor(a) for a in inv) + (torch.tensor(d2),)
    else:
        args_j = args_t = (0.5 / h, 0.5 / h, 0.5 / h, h * h)
    want = jax.jit(lambda u, v, w, *a: jl.lilly_integrand_3d(u, v, w, *a))(
        *(jnp.asarray(a) for a in fields), *args_j)
    got = tl.lilly_integrand_3d(*_t(fields), *args_t)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert float(np.abs(a - b.numpy()).max()) <= FIELD_RTOL * float(np.abs(a).max())


def test_dynamic_cs2_where_it_activates_matches_jax():
    """The broadband field of tests/test_les_dynamic.py:52: the model
    switches on, and the port's quotient is the JAX package's."""
    n = 32
    h = np.pi / n
    fields = _noise(n, 1)
    want = float(jax.jit(lambda u, v, w: jl.dynamic_cs2_3d(u, v, w, 0.5 / h, 0.5 / h, 0.5 / h,
                                                           h * h))(*fields))
    got = tl.dynamic_cs2_3d(*_t(fields), 0.5 / h, 0.5 / h, 0.5 / h, h * h)
    assert got.shape == () and got.dtype == torch.float32
    assert np.sqrt(want) > 0.02  # active, well above the resolved level
    kappa = _kappa(fields, h)
    assert abs(float(got) - want) <= SUM_ROUNDING * kappa * want, (float(got), want, kappa)
    c = tl.dynamic_coefficient_3d(*_t(fields), h, h, h)
    assert 0.0 <= float(c) <= 0.3**2 * h * h * (1.0 + 1e-5)


def test_dynamic_cs2_clips_on_a_resolved_field():
    n = 32
    h = np.pi / n
    fields = _tgv_centers(n, h)
    want = float(jax.jit(lambda u, v, w: jl.dynamic_coefficient_3d(u, v, w, h, h, h))(*fields))
    got = float(tl.dynamic_coefficient_3d(*_t(fields), h, h, h))
    c_static = 0.17**2 * h * h
    assert 0.0 <= got < 0.02 * c_static and 0.0 <= want < 0.02 * c_static, (got, want)


def test_boundary_skip_refuses_small_grids():
    fields = _t(_noise(6))
    with pytest.raises(ValueError, match="too small"):
        tl.dynamic_cs2_3d(*fields, 1.0, 1.0, 1.0, 1.0)
    # without the skip the same grid runs
    assert float(tl.dynamic_cs2_3d(*fields, 1.0, 1.0, 1.0, 1.0, boundary_skip=0)) >= 0.0


def test_masked_contraction_matches_jax():
    n = 16
    h = 1.0 / n
    fields = _noise(n, 3)
    mask = np.random.default_rng(4).random((n, n, n)) > 0.2
    want = float(jax.jit(lambda u, v, w, m: jl.dynamic_cs2_3d(
        u, v, w, 0.5 / h, 0.5 / h, 0.5 / h, h * h, mask=m))(*fields, mask))
    got = float(tl.dynamic_cs2_3d(*_t(fields), 0.5 / h, 0.5 / h, 0.5 / h, h * h,
                                  mask=torch.tensor(mask)))
    kappa = _kappa(fields, h, mask)
    assert abs(got - want) <= SUM_ROUNDING * kappa * want, (got, want, kappa)


def test_fluid_mask_from_penalization_masks_matches_jax():
    n = 12
    rng = np.random.default_rng(5)
    masks = [rng.random(s).astype(np.float32)
             for s in ((n, n, n + 1), (n, n + 1, n), (n + 1, n, n))]
    want = np.asarray(jl.ibm_fluid_mask_centers(*(jnp.asarray(m) for m in masks)))
    got = tl.ibm_fluid_mask_centers(*(torch.tensor(m) for m in masks))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) < got.numel()
    assert tl.ibm_fluid_mask_centers() is None and jl.ibm_fluid_mask_centers() is None


def test_fluid_mask_from_ghost_stencils_matches_jax():
    xf = np.linspace(0.0, 4.0, 25)
    yf = zf = np.linspace(0.0, 2.0, 13)
    j = jg.sphere_ghost_ibm(xf, yf, zf, (1.5, 1.0, 1.0), 0.6)
    t = tg.sphere_ghost_ibm(xf, yf, zf, (1.5, 1.0, 1.0), 0.6, device="cpu")
    want = np.asarray(jl.ibm_fluid_mask_centers(ibm_ghost=j))
    got = tl.ibm_fluid_mask_centers(ibm_ghost=t)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert not bool(got.all())
