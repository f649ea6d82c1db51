"""The immersed bodies of the staggered tiers against the JAX package: the
face-sampled masks and initial fields, the moving bodies, five steps of
``cylinder_mac`` (shell and sharp masks) and of ``cylinder_oscillating``
(uniform and stretched, forces included), the golden
``cylinder_mac_forces``, and a co-moving body that feels no force (the twin
of tests/test_moving_ibm.py:71).

Tolerances: masks, initial fields and the body's motion bit for bit (the
same numpy code; the motion the same float32 torch and XLA ops, within 1
ulp); five steps as in tests/test_torch_mac.py (u, v 1e-5 of max|u|, p
1e-4 of max|p|, metrics 1e-4 relative, the forces against the larger of
|fx|, |fy|).

The golden ``cylinder_mac_forces`` (96×48, Re=100, sharp masks, 200 steps)
is held under the rule of tests/test_goldens.py:112-124, RTOL 2e-5, on nine
of its eleven keys. Two sit below what this run reproduces in float32
outside the one XLA compilation that wrote them, and are held by the bands
the five-step comparisons use for their kind:
- ``fy``, the lift of a symmetric flow (2.2e-4 against |fx| 0.099), a small
  cancellation of O(fx) terms: 2e-5 of the larger of |fx|, |fy|, the force
  rule of tests/test_torch_cylinder.py;
- ``max_p``: the pressure is div u*/dt at dt = 5e-4, so a last-bit
  difference in u* is amplified 2000 times: 1e-4 relative, the p band.
The JAX package itself misses them at RTOL 2e-5 when the same 200 steps run
through its step jitted alone (fy 1.56e-4 relative, max_p 5.1e-6) or
eagerly (fy 1.27e-4, max_p 2.76e-5) instead of through the jitted scan; the
port on the CPU is at fy 7.2e-5, max_p 4.7e-5 (on the card 4.9e-4 and
6.7e-5: 1.1e-6 of |fx| for fy).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import ibm as jibm
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid as JGrid
from cfdsim_tpu_torch import ibm as tibm
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

# the five-step comparison of tests/test_torch_mac.py
from test_torch_mac import compare_steps  # noqa: E402

GOLDEN_RTOL = 2e-5
P_RTOL = 1e-4
GOLDENS = json.loads((Path(__file__).parent / "goldens.json").read_text())


@pytest.mark.parametrize("profile", ["shell", "sharp"])
def test_masks_and_potential_flow_bit_equal(profile):
    kw = dict(nx=96, ny=48, x_max=24.0, y_max=8.0, centering="cell")
    jg, tg = JGrid(**kw), Grid(**kw)
    jm = jibm.cylinder_masks_mac(jg, (6.0, 4.0), 0.5, profile=profile)
    tm = tibm.cylinder_masks_mac(tg, (6.0, 4.0), 0.5, profile=profile)
    for a, b in zip(jm, tm):
        assert b.dtype == np.float32 and np.array_equal(np.asarray(a), b)
    ju = jibm.potential_flow_cylinder_mac(jg, (6.0, 4.0), 0.5, 1.0, *jm)
    tu = tibm.potential_flow_cylinder_mac(tg, (6.0, 4.0), 0.5, 1.0, *tm)
    for a, b in zip(ju, tu):
        assert np.array_equal(np.asarray(a), b)
    d = np.linspace(0.0, 2.0, 101)
    assert np.array_equal(jibm._gaussian_shell(d, 0.5, 0.1), tibm._gaussian_shell(d, 0.5, 0.1))
    with pytest.raises(ValueError, match="profile"):
        tibm.cylinder_masks_mac(tg, (6.0, 4.0), 0.5, profile="soft")


def test_moving_bodies_match_jax():
    pairs = [(jibm.oscillating_cylinder((6.0, 3.0), 0.5, 0.8, 5.0),
              tibm.oscillating_cylinder((6.0, 3.0), 0.5, 0.8, 5.0)),
             (jibm.oscillating_cylinder((6.0, 3.0), 0.5, 0.8, 5.0, axis=1),
              tibm.oscillating_cylinder((6.0, 3.0), 0.5, 0.8, 5.0, axis=1)),
             (jibm.translating_body((4.0, 4.0), (1.0, 0.5), 0.5),
              tibm.translating_body((4.0, 4.0), (1.0, 0.5), 0.5))]
    for t in (0.0, 0.37, 2.5, 11.3):
        jt, tt = jnp.float32(t), torch.tensor(t, dtype=torch.float32)
        for jb, tb in pairs:
            assert jb.radius == tb.radius
            for a, b in zip((*jb.center(jt), *jb.velocity(jt)),
                            (*tb.center(tt), *tb.velocity(tt))):
                a, b = float(a), float(b)
                assert abs(a - b) <= 2 ** -22 * max(1.0, abs(a)), (t, a, b)


@pytest.mark.parametrize("profile", ["shell", "sharp"])
def test_cylinder_mac_five_steps_match_jax(profile):
    kw = dict(nx=96, ny=48, Re=100.0, ibm_profile=profile)
    j, t = j_build("cylinder_mac", **kw), build("cylinder_mac", device="cpu", **kw)
    for k in ("ibm_mask_u", "ibm_mask_v"):
        assert np.array_equal(np.asarray(j.extras[k]), t.extras[k])
    compare_steps(j.step, t.step, j.state, 8.0 / 48)


@pytest.mark.parametrize("stretched", [False, True])
def test_cylinder_oscillating_five_steps_match_jax(stretched):
    kw = dict(nx=64, ny=32, stretched=stretched)
    j, t = j_build("cylinder_oscillating", **kw), build("cylinder_oscillating", device="cpu", **kw)
    assert type(t.cfg).__name__ == type(j.cfg).__name__
    h = t.extras["h_min"] if stretched else 12.0 / 32
    compare_steps(j.step, t.step, j.state, h)


def test_golden_cylinder_mac_forces():
    case = build("cylinder_mac", nx=96, ny=48, Re=100.0, ibm_profile="sharp", device="cpu")
    s = case.state
    for _ in range(200):
        s, _ = case.step(s, 1.0)
    _, m = case.step(s, 1.0)
    sig = {}
    for name in ("u", "v", "p"):
        f = getattr(s, name)
        sig[f"l2_{name}"] = float(torch.sqrt(torch.mean(f * f)))
        sig[f"max_{name}"] = float(f.abs().max())
    for name in ("energy", "max_vel", "fx", "fy", "vort_max"):
        sig[name] = float(getattr(m, name))
    ref = GOLDENS["cylinder_mac_forces"]
    atol = 1e-6 * max(abs(v) for v in ref.values())
    for key, want in ref.items():
        if key == "fy":
            tol = GOLDEN_RTOL * max(abs(ref["fx"]), abs(want))
        else:
            tol = (P_RTOL if key == "max_p" else GOLDEN_RTOL) * abs(want)
        assert abs(sig[key] - want) <= max(tol, atol), (key, sig[key], want)


def test_comoving_body_feels_no_force():
    """A body translating at exactly the stream velocity has zero relative
    velocity everywhere: the penalization must not disturb the uniform flow
    and the reported force must vanish."""
    grid = Grid(nx=96, ny=32, x_max=24.0, y_max=8.0, centering="cell")
    cfg = mac.MACConfig(grid=grid, nu=0.005, scheme="tvd", poisson=PoissonConfig(method="dct"))
    bcs = mac.external_flow_bcs(1.0, grid.y_min + (np.arange(grid.ny) + 0.5) * grid.dy,
                                grid.y_max, perturb_amp=0.0, device="cpu")
    body = tibm.translating_body((4.0, 4.0), (1.0, 0.0), 0.5)
    step = mac.make_step(cfg, bcs, moving_body=body, device="cpu")
    s = mac.init_state(cfg, u0=np.ones((32, 97), np.float32), device="cpu")
    for _ in range(30):
        s, m = step(s, 1.0)
    assert float((s.u - 1.0).abs().max()) <= 1e-5
    assert float(s.v.abs().max()) <= 1e-5
    assert abs(float(m.fx)) < 1e-5 and abs(float(m.fy)) < 1e-5


def test_cylinder_mac_through_kernel_a_route_on_cpu():
    """``poisson="rbsor_pallas"`` on the MAC cylinder: on the CPU the
    wrapper runs kernel A's plain version, five steps against the JAX
    package's ``rbsor_pallas`` (interpret mode there)."""
    kw = dict(nx=48, ny=16, Re=100.0, ibm_profile="sharp")
    pois = dict(method="rbsor_pallas", iters=60, omega=1.7)
    from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig

    j = j_build("cylinder_mac", poisson=JConfig(**pois), **kw)
    t = build("cylinder_mac", device="cpu", poisson=PoissonConfig(**pois), **kw)
    compare_steps(j.step, t.step, j.state, 8.0 / 16, pre=5, exact=False)
