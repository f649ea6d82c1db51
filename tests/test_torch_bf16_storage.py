"""bf16 inter-step velocity storage in the port (``storage="bf16"`` on the
collocated and MAC tiers) against the JAX package.

- The three gates of tests/test_bf16_storage.py on the port: the dtypes
  (u, v bfloat16, p float32), health after 50 steps, the projection
  measured before rounding (MAC ``div_post`` < 1e-3), the MAC trajectory
  within 5e-2 of the float32 one and different from it.
- Parity with the JAX bf16 run from one carried-over developed state:
  after one step within one bfloat16 ulp of |u| elementwise (both sides
  compute in float32, whose last-bit differences can flip one rounding);
  after 50 steps within 5e-2, the JAX test's band between bf16 and fp32.
- A bf16 state goes through an HDF5 and a native snapshot and comes back
  in its dtype, bit for bit, and a resumed run repeats the uninterrupted one.
- The bench driver's rows at a tiny size on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import lid_cavity as j_lid_cavity
from cfdsim_tpu.cases import lid_cavity_mac as j_lid_cavity_mac
from cfdsim_tpu_torch.cases import lid_cavity, lid_cavity_mac
from cfdsim_tpu_torch.io_ import SnapshotWriter, restore
from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter
from cfdsim_tpu_torch.models.incompressible import make_chunk

TRACK_ATOL = 5e-2  # tests/test_bf16_storage.py:45
DIV_POST_MAX = 1e-3  # tests/test_bf16_storage.py:33

CASES = {"collocated": (lid_cavity, j_lid_cavity), "mac": (lid_cavity_mac, j_lid_cavity_mac)}


def _run(case, n):
    chunk = make_chunk(case.cfg, case.step, n)
    return chunk(case.state, 1.0)


def _jax_run(case, state, n):
    f = jax.jit(lambda s: jax.lax.scan(
        lambda st, _: case.step(st, jnp.float32(1.0)), s, None, length=n))
    return f(state)


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(jnp.asarray(x, jnp.float32))


def test_mac_bf16_storage_roundtrip_and_health():
    case = lid_cavity_mac(n=64, Re=100.0, storage="bf16", device="cpu")
    assert case.state.u.dtype == torch.bfloat16 and case.state.v.dtype == torch.bfloat16
    assert case.state.p.dtype == torch.float32  # p warm-starts the solve
    s, m = _run(case, 50)
    assert s.u.dtype == torch.bfloat16 and s.p.dtype == torch.float32
    assert bool(torch.isfinite(s.u.float()).all())
    assert float(m.div_post[-1]) < DIV_POST_MAX


def test_mac_bf16_tracks_fp32_to_rounding():
    s32, _ = _run(lid_cavity_mac(n=64, Re=100.0, device="cpu"), 50)
    s16, _ = _run(lid_cavity_mac(n=64, Re=100.0, storage="bf16", device="cpu"), 50)
    err = float((s16.u.float() - s32.u).abs().max())
    assert 0 < err < TRACK_ATOL, err


def test_collocated_bf16_storage_runs():
    case = lid_cavity(n=64, Re=100.0, storage="bf16", device="cpu")
    assert case.state.u.dtype == torch.bfloat16
    s, _ = _run(case, 50)
    assert s.u.dtype == torch.bfloat16
    u = s.u.float()
    assert bool(torch.isfinite(u).all())
    assert 0.0 < float(u.abs().max()) <= 1.5


def _bf16_ulp(a):
    """One bfloat16 ulp at each |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.fixture(scope="module", params=sorted(CASES))
def developed(request):
    """(tier, JAX bf16 state after 20 steps from rest)."""
    tier = request.param
    j_case = CASES[tier][1](n=32, Re=100.0, storage="bf16")
    s, _ = _jax_run(j_case, j_case.state, 20)
    return tier, s


def _torch_state(case, js):
    st = case.state
    return st._replace(
        u=torch.tensor(_f32(js.u)).to(torch.bfloat16), v=torch.tensor(_f32(js.v)).to(
            torch.bfloat16), p=torch.tensor(np.asarray(js.p)),
        t=torch.tensor(np.float32(js.t)), step=torch.tensor(np.int32(js.step)))


@pytest.mark.parametrize("steps", [1, 50])
def test_bf16_matches_jax_bf16(developed, steps):
    tier, js0 = developed
    t_fn, j_fn = CASES[tier]
    j_case = j_fn(n=32, Re=100.0, storage="bf16")
    t_case = t_fn(n=32, Re=100.0, storage="bf16", device="cpu")
    js, jm = _jax_run(j_case, js0, steps)
    ts, tm = make_chunk(t_case.cfg, t_case.step, steps)(_torch_state(t_case, js0), 1.0)
    assert ts.u.dtype == torch.bfloat16 and ts.p.dtype == torch.float32
    for name in ("u", "v"):
        a, b = _f32(getattr(ts, name)), _f32(getattr(js, name))
        if steps == 1:
            bad = np.abs(a - b) > _bf16_ulp(b)
            assert not bad.any(), (name, np.abs(a - b).max(), int(bad.sum()))
        else:
            assert np.abs(a - b).max() < TRACK_ATOL, (name, np.abs(a - b).max())
    # the metrics read the unrounded float32 fields on both sides
    np.testing.assert_allclose(float(tm.energy[-1]), float(jm.energy[-1]), rtol=1e-3)


@pytest.mark.parametrize("io", ["hdf5", "native"])
@pytest.mark.parametrize("tier", sorted(CASES))
def test_bf16_snapshot_restores_dtype_and_resumes(tmp_path, io, tier):
    case = CASES[tier][0](n=32, Re=100.0, storage="bf16", device="cpu")
    s3, _ = _run(case, 3)
    if io == "hdf5":
        path = tmp_path / "s.h5"
        w = SnapshotWriter(path)
        w.save(int(s3.step), float(s3.t), u=s3.u, v=s3.v, p=s3.p)
    else:
        path = tmp_path / "s.csnap"
        w = NativeSnapshotWriter(path)
        w.save(int(s3.step), float(s3.t), u=s3.u, v=s3.v, p=s3.p)
        w.close()
    back = restore(case.state, path)
    assert back.u.dtype == torch.bfloat16 and back.p.dtype == torch.float32
    for name in ("u", "v", "p", "t", "step"):
        assert torch.equal(getattr(back, name), getattr(s3, name)), name
    chunk = make_chunk(case.cfg, case.step, 2)
    a, _ = chunk(s3, 1.0)
    b, _ = chunk(back, 1.0)
    for name in ("u", "v", "p", "t", "step"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_bf16_bench_rows(capsys):
    from cfdsim_tpu_torch.examples import bf16_storage_bench as bench

    rows = bench.main([16], ("collocated", "mac"), device="cpu", short=2, long=4)
    out = capsys.readouterr().out
    assert [(t, n) for t, n, _ in rows] == [("collocated", 16), ("mac", 16)]
    for tier in ("collocated", "mac"):
        for storage in ("fp32", "bf16"):
            assert f'"metric": "cells_per_sec_{tier}16_{storage}"' in out
    assert all(r["fp32"] > 0 and r["bf16"] > 0 for _, _, r in rows)
