"""The fused central predictor: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and unfused ops, the kernel
against the plain version on a card on every route of its plan, the plan
itself, and the wrapper's routing.

Tolerance: atol 1e-6 (the band of tests/test_pallas.py:127-128). The
fused and unfused forms group the same terms differently, which moves the
O(1) results by an ulp or two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.ops.convection import convection_central as j_conv
from cfdsim_tpu.ops.pallas.predictor import fused_predictor_central as j_fused
from cfdsim_tpu.ops.stencil import laplacian_coeff as j_lap
from cfdsim_tpu_torch.cases import lid_cavity
from cfdsim_tpu_torch.ops.kernels import predictor as pred

ATOL = 1e-6
DT, NU, DX, DY = 1e-3, 0.01, 0.02, 0.03


def _uv(shape, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("against", ["pallas_interpret", "unfused_jnp"])
@pytest.mark.parametrize("shape", [(48, 64), (37, 129), (16, 128), (9, 132), (3, 3), (4, 5)])
def test_plain_predictor_matches_jax(shape, against):
    u, v = _uv(shape)
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    if against == "pallas_interpret":
        want = j_fused(ju, jv, DT, NU, DX, DY, rows_per_block=16, interpret=True)
    else:
        want = (ju + DT * (j_lap(ju, DX, DY, NU) - j_conv(ju, jv, ju, DX, DY)),
                jv + DT * (j_lap(jv, DX, DY, NU) - j_conv(ju, jv, jv, DX, DY)))
    got = pred.fused_predictor_central_ref(torch.from_numpy(u), torch.from_numpy(v),
                                           DT, NU, DX, DY)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_cpu_tensors_take_the_plain_version():
    u, v = _uv((37, 129))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    pred.KERNEL.reset_launches()
    got = pred.fused_predictor_central(tu, tv, torch.tensor(DT), NU, DX, DY)
    want = pred.fused_predictor_central_ref(tu, tv, torch.tensor(DT), NU, DX, DY)
    assert pred.KERNEL.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the boundary frame passes through unchanged
    assert torch.equal(got[0][0], tu[0]) and torch.equal(got[1][:, -1], tv[:, -1])


def test_non_cpu_non_cuda_tensors_raise():
    u = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pred.fused_predictor_central(u, u, 1e-3, NU, DX, DY)


def test_fused_predictor_rejects_unsupported():
    with pytest.raises(ValueError, match="fused_predictor"):
        lid_cavity(n=32, Re=100.0, scheme="upwind", fused_predictor=True, device="cpu")


@pytest.mark.parametrize("shape, align, vec", [
    ((1024, 1024), 16, 4),  # the main path
    ((4096, 4096), 16, 4),
    ((48, 64), 16, 4),
    ((4, 8), 16, 4),
    ((1000, 1030), 16, 2),  # a pitch of 4120 bytes: a multiple of 8, not of 16
    ((37, 129), 16, 1),  # a pitch of 516 bytes
    ((3, 3), 16, 1),
    ((4, 5), 16, 1),
    ((1024, 1024), 8, 2),  # pointers aligned to 8 bytes only
    ((1024, 1024), 4, 1),  # a slice that starts one float into a buffer
    ((1000, 1030), 4, 1),
    ((48, 64), 12, 1),
], ids=str)
def test_plan_predictor(shape, align, vec):
    plan = pred.plan_predictor(shape, align)
    assert plan.vec == vec
    # never a width the pitch or the pointers do not allow
    assert shape[1] % plan.vec == 0 and align % (4 * plan.vec) == 0
    assert plan.route == f"vec{plan.vec}"
    # the plan depends on sizes alone
    assert pred.plan_predictor(shape, align) == plan


def test_pointer_alignment():
    buf = torch.zeros(64)
    base = pred.pointer_alignment(buf)
    assert base in (4, 8, 16) and buf.data_ptr() % base == 0
    assert pred.pointer_alignment(buf, buf[1:]) == 4
    assert pred.pointer_alignment(buf[2:]) == min(base, 8)
    assert pred.pointer_alignment(buf[4:]) == base


# (shape, floats the fields start past their buffer's first element): every
# vector width of the plan, the edge grids, a base pointer 4-byte aligned,
# and per width a grid whose last strip is ragged both ways
CARD_CASES = [((48, 64), 0), ((1000, 1030), 0), ((37, 129), 0), ((1024, 1024), 0),
              ((16, 128), 0), ((9, 132), 0), ((3, 3), 0), ((4, 5), 0), ((4, 8), 0),
              ((48, 64), 1), ((64, 128), 2), ((133, 260), 0), ((133, 130), 0),
              ((133, 129), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, offset", CARD_CASES, ids=str)
def test_kernel_matches_plain_on_card(shape, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ny, nx = shape
    rng = np.random.default_rng(5)
    tu, tv = (torch.from_numpy(rng.standard_normal(ny * nx + offset).astype(np.float32))
              .cuda()[offset:].view(ny, nx) for _ in range(2))
    dt = torch.tensor(DT, device="cuda")
    before = pred.KERNEL.launches
    got = pred.fused_predictor_central(tu, tv, dt, NU, DX, DY)
    want = pred.fused_predictor_central_ref(tu, tv, dt, NU, DX, DY)
    torch.cuda.synchronize()
    assert pred.KERNEL.launches == before + 1
    for g, w, x in zip(got, want, (tu, tv)):
        assert float((g - w).abs().max()) <= ATOL
        assert torch.equal(g[0], x[0]) and torch.equal(g[-1], x[-1])
        assert torch.equal(g[:, 0], x[:, 0]) and torch.equal(g[:, -1], x[:, -1])
