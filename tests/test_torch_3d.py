"""The 3D core of the port (``grid.py::Grid3D``, the 3D DCT of
``solvers/poisson.py``, ``solvers/poisson3d.py``,
``models/incompressible3d.py`` and the case ``cavity3d``) against the JAX
package on seeded inputs, and the command line's ``run cavity3d_mac``.

Tolerances:
- ``Grid3D``: spacings and shapes equal;
- the 3D DCT (``_dct3d_rfftn``, ``_idct3d_rfftn``) within 1e-6 of the
  output's max against JAX, and against the per-axis path (the same
  transform, another FFT summation order);
- ``solve_poisson_3d``: dct within 1e-5 of max|φ| (FFT summation order),
  mg and rbsor within 1e-5 of max|φ| (the same sweeps; ``_restrict``'s
  eight-term mean may sum in another order), on 16³ and 24×20×16 (whose
  hierarchy stops at an odd side); ``residual_3d`` within 1e-5 relative;
- five ``cavity3d`` steps at 16³ (``mg:2``) from the state after 20 jitted
  JAX steps: u, v, w within 1e-6 of max|u, v, w|, p within 1e-5 of max|p|,
  metrics within 1e-5 relative; ``poisson_res``, the residual of an
  unconverged solve, within 1e-2 relative plus 1e-5 of max|rhs| (the band
  of tests/test_torch_mac.py; observed 3.4e-3 relative, 3e-7 of |rhs|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu.grid import Grid3D as JGrid3D
from cfdsim_tpu.solvers import poisson as jp
from cfdsim_tpu.solvers import poisson3d as jp3
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.convert import state3d_from_numpy, state_to_numpy
from cfdsim_tpu_torch.grid import Grid3D
from cfdsim_tpu_torch.io_.native import csnap_steps
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.solvers import poisson as tp
from cfdsim_tpu_torch.solvers import poisson3d as tp3

DCT_RTOL = 1e-6
SOLVE_RTOL = 1e-5
UV_RTOL = 1e-6
P_RTOL = 1e-5
METRIC_RTOL = 1e-5
RES_RTOL, RES_NOISE = 1e-2, 1e-5


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("centering", ["node", "cell"])
def test_grid3d_matches_jax(centering):
    kw = dict(nx=24, ny=20, nz=16, x_max=2.0, z_min=-1.0, centering=centering)
    j, t = JGrid3D(**kw), Grid3D(**kw)
    assert (t.dx, t.dy, t.dz) == (j.dx, j.dy, j.dz)
    assert t.shape == j.shape == (16, 20, 24) and t.n_cells == j.n_cells
    z = t.zeros(device="cpu")
    assert z.shape == (16, 20, 24) and z.dtype == torch.float32
    with pytest.raises(ValueError, match="centering"):
        Grid3D(nx=4, ny=4, nz=4, centering="face")


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 20)])
def test_dct3d_matches_jax_and_per_axis(shape):
    x = _rand(shape, 1)
    fwd = tp._dct3d_rfftn(torch.tensor(x))
    assert _rel(fwd.numpy(), jax.jit(jp._dct3d_rfftn)(jnp.asarray(x))) <= DCT_RTOL
    per_axis = tp._dct_fwd(tp._dct_fwd(tp._dct_fwd(torch.tensor(x), 0), 1), 2)
    assert _rel(fwd.numpy(), per_axis.numpy()) <= DCT_RTOL
    scale = np.random.default_rng(2).random(shape).astype(np.float32)
    X = torch.tensor(x)
    inv = tp._idct3d_rfftn(X, scale=torch.tensor(scale))
    want = jax.jit(jp._idct3d_rfftn)(jnp.asarray(x), scale=jnp.asarray(scale))
    assert _rel(inv.numpy(), want) <= DCT_RTOL
    back = tp._idct3d_rfftn(tp._dct3d_rfftn(torch.tensor(x)))
    assert _rel(back.numpy(), x) <= DCT_RTOL
    unf = tp._spectral_unfold(torch.tensor(x).to(torch.complex64), torch.tensor(1j), 1)
    assert _rel(unf.numpy(), jp._spectral_unfold(jnp.asarray(x).astype(jnp.complex64),
                                                 jnp.complex64(1j), 1)) <= DCT_RTOL


CONFIGS = [
    dict(method="dct"),
    dict(method="dct", dct_variant="rfft"),
    dict(method="mg", iters=2),
    dict(method="mg", iters=3, mg_pre=1, mg_post=3, mg_coarse=5),
    dict(method="rbsor", iters=15, omega=1.5),
]


@pytest.mark.parametrize("shape", [(16, 16, 16), (24, 20, 16), (15, 24, 32)])
@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_solve_poisson_3d_matches_jax(shape, kw):
    rhs = _rand(shape, 3)
    rhs = rhs - rhs.mean()
    phi0 = 0.1 * _rand(shape, 4)
    d = (0.1, 0.07, 0.09)
    # jitted: XLA compiles the DCT's several hundred primitives once, not one by one
    solve = jax.jit(lambda p, r: jp3.solve_poisson_3d(p, r, *d, jp3.Poisson3DConfig(**kw)))
    want = np.asarray(solve(jnp.asarray(phi0), jnp.asarray(rhs)))
    cfg = tp3.Poisson3DConfig(**kw)
    t_phi0, t_rhs = torch.tensor(phi0), torch.tensor(rhs)
    got = tp3.solve_poisson_3d(t_phi0, t_rhs, *d, cfg)
    assert _rel(got.numpy(), want) <= SOLVE_RTOL
    assert torch.equal(t_phi0, torch.tensor(phi0))  # the warm start is not written
    a = float(jp3.residual_3d(jnp.asarray(want), jnp.asarray(rhs), *d))
    b = float(tp3.residual_3d(torch.tensor(want), t_rhs, *d))
    assert abs(a - b) <= 1e-5 * a
    assert tp3.Poisson3DSolver(shape, *d, cfg, device="cpu").reads_host is False


def test_multigrid_helpers_match_jax():
    e = _rand((5, 6, 7), 5)
    for axis in range(3):
        assert np.array_equal(tp3._prolong_axis(torch.tensor(e), axis).numpy(),
                              np.asarray(jp3._prolong_axis(jnp.asarray(e), axis)))
    r = _rand((8, 6, 4), 6)
    assert _rel(tp3._restrict(torch.tensor(r)).numpy(), jp3._restrict(jnp.asarray(r))) <= 1e-6
    for shape in ((16, 16, 16), (24, 20, 16), (256, 256, 256), (15, 24, 32)):
        assert tp3._level_shapes(shape, 4) == jp3._level_shapes(shape, 4)
    assert tp3._level_shapes((24, 20, 16), 4)[-1] == (6, 5, 4)
    assert np.array_equal(tp3._parity_mask((3, 4, 5)),
                          np.asarray(jp3._parity_mask((3, 4, 5))))
    x = _rand((6, 7, 8), 7)
    assert _rel(tp3.lap_neumann_3d(torch.tensor(x), 0.1, 0.2, 0.3).numpy(),
                jp3.lap_neumann_3d(jnp.asarray(x), 0.1, 0.2, 0.3)) <= 1e-6


def test_refused_3d_configs_raise():
    with pytest.raises(ValueError, match="method"):
        tp3.Poisson3DSolver((8, 8, 8), 0.1, 0.1, 0.1, tp3.Poisson3DConfig(method="fft"),
                            device="cpu")
    with pytest.raises(ValueError, match="dct_variant"):
        tp3.Poisson3DSolver((8, 8, 8), 0.1, 0.1, 0.1,
                            tp3.Poisson3DConfig(method="dct", dct_variant="matmul"),
                            device="cpu")


def test_dct_solve_is_exact():
    """tests/test_3d.py:30: a manufactured solution at 32³."""
    n = 32
    x = np.linspace(0, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    phi_ex = torch.tensor((np.cos(np.pi * X) * np.cos(2 * np.pi * Y)
                           * np.cos(np.pi * Z)).astype(np.float32))
    h = float(x[1] - x[0])
    rhs = tp3.lap_neumann_3d(phi_ex, h, h, h)
    phi = tp3.solve_poisson_3d(torch.zeros_like(rhs), rhs, h, h, h,
                               tp3.Poisson3DConfig(method="dct"))
    assert float(tp3.residual_3d(phi, rhs, h, h, h)) < 5e-2
    d = (phi - phi.mean()) - (phi_ex - phi_ex.mean())
    assert float(d.abs().max()) < 5e-3


def _to_port(js):
    return state3d_from_numpy(*(np.asarray(getattr(js, k)) for k in ("u", "v", "w", "p", "t",
                                                                      "step")), device="cpu")


def test_cavity3d_five_steps_match_jax():
    j = j_build("cavity3d", n=16)
    t = build("cavity3d", n=16, poisson="mg:2", device="cpu")
    assert t.cfg.poisson == tp3.Poisson3DConfig(method="mg", iters=2)
    assert t.step.reads_host is False
    j_step = jax.jit(j.step)
    js = j.state
    for _ in range(20):
        js, _ = j_step(js, jnp.float32(1.0))
    ts = _to_port(js)
    for _ in range(5):
        js, jm = j_step(js, jnp.float32(1.0))
        ts, tm = t.step(ts, 1.0)
    got = state_to_numpy(ts)
    vel = max(np.abs(np.asarray(getattr(js, k))).max() for k in ("u", "v", "w"))
    for k in ("u", "v", "w"):
        assert np.abs(got[k] - np.asarray(getattr(js, k))).max() <= UV_RTOL * vel, k
    assert _rel(got["p"], js.p) <= P_RTOL
    assert got["step"] == int(js.step) and abs(got["t"] - float(js.t)) <= 1e-6
    rhs_max = float(jm.div_pre) / float(jm.dt)
    for name in jm._fields:
        a, b = float(getattr(jm, name)), float(getattr(tm, name))
        if name == "poisson_res":
            assert abs(a - b) <= RES_RTOL * a + RES_NOISE * rhs_max, (a, b)
        else:
            assert abs(a - b) <= METRIC_RTOL * max(abs(a), 1e-12), (name, a, b)


def test_cavity3d_steps_healthy_and_bcs_in_place_on_copies():
    """tests/test_3d.py:64 at 16³, through the chunk; the step leaves its
    input state as it was."""
    case = build("cavity3d", n=16, Re=100.0, device="cpu")
    s0 = case.state
    s, m = make_chunk(case.cfg, case.step, 40)(s0, 1.0)
    assert all(bool(torch.isfinite(getattr(s, k)).all()) for k in ("u", "v", "w", "p"))
    assert float(m.max_vel[-1]) <= 1.0 + 1e-3 and float(m.div_post[-1]) < 1.0
    assert float(s.u.min()) < -1e-3  # the return flow under the lid
    before = {k: getattr(s, k).clone() for k in s._fields}
    case.step(s, 1.0)
    assert all(torch.equal(getattr(s, k), before[k]) for k in s._fields)


def test_cli_run_cavity3d_mac_resume_bit_exact(tmp_path):
    """``run cavity3d_mac --n 16`` for 20 steps, with native snapshots and
    a ``--resume`` against one uninterrupted run, bit for bit."""
    common = ["--n", "16", "--chunk-steps", "10", "--snapshot-interval", "10", "--device", "cpu",
              "--io", "native"]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", "cavity3d_mac", "--max-steps", "10", "--out", str(out_a), *common])
    report = cli.main(["run", "cavity3d_mac", "--max-steps", "20", "--out", str(out_a),
                       "--resume", *common])
    assert report["final_step"] == 20 and not report["stopped_reason"]
    cli.main(["run", "cavity3d_mac", "--max-steps", "20", "--out", str(out_b), *common])
    a, b = csnap_steps(out_a / "snapshots.csnap"), csnap_steps(out_b / "snapshots.csnap")
    assert sorted(a) == sorted(b) == [0, 10, 20]
    for step in a:
        assert {k: v.shape for k, v in a[step][0].items()} == {
            "u": (16, 16, 17), "v": (16, 17, 16), "w": (17, 16, 16), "p": (16, 16, 16)}
        for name in a[step][0]:
            np.testing.assert_array_equal(a[step][0][name], b[step][0][name])
