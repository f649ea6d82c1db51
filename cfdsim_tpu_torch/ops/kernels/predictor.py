"""Fused incompressible predictor: the CUDA kernel and its plain version.

The port of ``cfdsim_tpu/ops/pallas/predictor.py::fused_predictor_central``.
One pass computes

    u* = u + dt·(ν ∇²u − u·∇u),   v* = v + dt·(ν ∇²v − u·∇v)

on the interior, and passes the boundary frame through unchanged. On a
CUDA tensor the wrapper launches ``csrc/predictor.cu`` (built for sm_90a at
first use) or raises; on a CPU tensor it runs the plain torch version,
:func:`fused_predictor_central_ref`. Nothing falls back from one to the
other.

The kernel gives each warp a strip of 32·``vec`` columns × 4 rows, each lane
``vec`` consecutive columns as one aligned vector. :func:`plan_predictor`
picks the vector width from the shape and the pointers' alignment, before
the launch; the strip height and the block size are constants of the
kernel source.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cfdsim_tpu_torch.ops.convection import convection_central
from cfdsim_tpu_torch.ops.kernels.cuda_build import CudaKernel, report_cost
from cfdsim_tpu_torch.ops.stencil import laplacian_coeff

_p = ctypes.c_void_p
_f = ctypes.c_float
_i = ctypes.c_int
# float32 operations per cell: two fields × (9 Laplacian + 7 convection + 4 update)
FLOPS_PER_CELL = 40

KERNEL = CudaKernel(
    "predictor.cu",
    "cfd_fused_predictor_central",
    # u, v, dt, u*, v*, ny, nx, vec, nu, 1/dx², 1/dy², 0.5/dx, 0.5/dy, stream
    [_p, _p, _p, _p, _p, _i, _i, _i, _f, _f, _f, _f, _f, _p],
)


class PredictorPlan(NamedTuple):
    """How the kernel runs one call: each lane holds ``vec`` columns (one
    4·``vec``-byte vector), each warp a strip of 32·``vec`` columns."""

    vec: int

    @property
    def route(self) -> str:
        return f"vec{self.vec}"


def plan_predictor(shape, align_bytes: int) -> PredictorPlan:
    """The kernel's plan for fields of ``shape`` whose pointers (u, v, u*,
    v*) are all aligned to ``align_bytes``, from these sizes alone.

    The vector width is the largest of 4, 2, 1 that divides nx (so every
    row starts on a vector boundary and no vector straddles a row's end)
    with vectors of 4·vec bytes aligned at the pointers."""
    ny, nx = shape
    vec = next(w for w in (4, 2, 1) if nx % w == 0 and align_bytes % (4 * w) == 0)
    return PredictorPlan(vec)


def pointer_alignment(*tensors) -> int:
    """The largest power of two, up to 16, that divides every tensor's
    data pointer."""
    bits = 16
    for t in tensors:
        bits |= t.data_ptr()
    return bits & -bits


def fused_predictor_central_ref(u, v, dt, nu: float, dx: float, dy: float):
    """Plain torch predictor: the unfused ops the kernel replaces."""
    us = u + dt * (laplacian_coeff(u, dx, dy, nu) - convection_central(u, v, u, dx, dy))
    vs = v + dt * (laplacian_coeff(v, dx, dy, nu) - convection_central(u, v, v, dx, dy))
    return us, vs


def _check_cuda_args(u, v, dt):
    if v.device != u.device:
        raise ValueError(f"u on {u.device} but v on {v.device}")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"fused predictor takes float32, got {u.dtype}/{v.dtype}")
    if u.ndim != 2 or u.shape != v.shape:
        raise ValueError(f"u and v must be equal 2D shapes, got {tuple(u.shape)}/{tuple(v.shape)}")
    if not (u.is_contiguous() and v.is_contiguous()):
        raise ValueError("u and v must be contiguous")
    if u.requires_grad or v.requires_grad:
        raise RuntimeError("the fused predictor kernel has no backward")
    if dt.device != u.device or dt.dtype != torch.float32 or dt.numel() != 1:
        raise ValueError(
            f"dt must be one float32 value on {u.device}, got {dt.dtype} "
            f"{tuple(dt.shape)} on {dt.device}"
        )


def fused_predictor_central(u, v, dt, nu: float, dx: float, dy: float):
    """Fused central predictor; returns (u*, v*).

    ``dt`` is a 0-dim float32 tensor on the fields' device (a Python float
    is accepted and copied there); the kernel reads it from device memory,
    so the launch never waits for the host.
    """
    if u.device.type == "cpu" and v.device.type == "cpu":
        return fused_predictor_central_ref(u, v, dt, nu, dx, dy)
    if u.device.type != "cuda":
        raise ValueError(f"fused predictor runs on cuda or cpu tensors, not {u.device}")
    if not torch.is_tensor(dt):
        dt = torch.tensor(dt, dtype=torch.float32, device=u.device)
    _check_cuda_args(u, v, dt)
    us = torch.empty_like(u)
    vs = torch.empty_like(v)
    plan = plan_predictor(tuple(u.shape), pointer_alignment(u, v, us, vs))
    ny, nx = u.shape
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        KERNEL(
            u.data_ptr(), v.data_ptr(), dt.data_ptr(), us.data_ptr(), vs.data_ptr(),
            ny, nx, plan.vec,
            float(nu), 1.0 / (dx * dx), 1.0 / (dy * dy), 0.5 / dx, 0.5 / dy,
            stream,
        )
    report_cost(16 * ny * nx, FLOPS_PER_CELL * ny * nx)  # u, v in; u*, v* out
    return us, vs
