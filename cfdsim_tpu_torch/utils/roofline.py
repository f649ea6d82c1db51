"""Roofline accounting for a solver step on the card
(``cfdsim_tpu.utils.roofline``).

``step_costs`` counts what one eager step moves and computes, with a
:class:`CostMode` (a ``TorchDispatchMode``) over the step. In the port each
aten op is a kernel of its own (nothing fuses eager ops), so the counts are
the traffic of the graph that actually runs, op by op: **pre-fusion**
counts. The JAX package's were XLA's post-fusion cost analysis, so the two
are not comparable. Per aten op:

- bytes: every input tensor read once, every output written once (an
  in-place op's destination counts as read and written, except for the ops
  that only overwrite it: ``copy_``, ``fill_``, ``zero_``); views move
  nothing;
- flops: 2·m·n·k per matrix product, 2.5·T·log₂N per real FFT and
  5·T·log₂N per complex FFT of T elements over transform lengths of
  product N, and one per output element for every other op.

The hand kernels are launched through ``ctypes``, which the mode cannot
see: each wrapper reports its own bytes and operations by the formulas of
PERF.md §6 (``ops/kernels/cuda_build.py::report_cost``).

``measure_peaks`` times a 2048³ float32 matmul (TF32 off) and a 64 MB copy
with CUDA events; ``roofline`` classifies a tier as compute- or
bandwidth-bound against those peaks and against the H100 SXM data sheet's
(3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores):

    ceiling(cells/s) = min(peak_flops / flops_per_cell, peak_bw / bytes_per_cell)
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from cfdsim_tpu_torch.solvers.fdm import full_fp32_matmul
from cfdsim_tpu_torch.utils.tree import leaves

DATASHEET_BW = 3.35e12  # H100 SXM HBM3, bytes/s
DATASHEET_FLOPS_F32 = 67e12  # H100 SXM float32 outside the tensor cores, flop/s

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}
_OVERWRITE = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default}
_FFT_REAL = {_aten._fft_r2c.default, _aten._fft_c2r.default}
_FFT_COMPLEX = {_aten._fft_c2c.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fft_flops(func, args, out) -> float:
    """c·T·log₂N of one FFT op: T the elements of the real (or complex)
    side, N the product of the transformed lengths."""
    x, dims = args[0], args[1]
    full = out if func is _aten._fft_c2r.default else x  # the real or full-length side
    n = math.prod(full.shape[d] for d in dims)
    c = 5.0 if func in _FFT_COMPLEX else 2.5
    return c * full.numel() * math.log2(max(n, 2))


class CostMode(TorchDispatchMode):
    """Counts ``bytes``, ``flops`` and ``ops`` of the aten ops run inside it,
    and ``kernels``, the hand-kernel launches whose wrappers reported their
    cost (:meth:`add_kernel_cost`)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.flops = 0.0
        self.ops = 0
        self.kernels = 0

    def add_kernel_cost(self, bytes_moved: float, flops: float) -> None:
        self.bytes += bytes_moved
        self.flops += flops
        self.kernels += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.name().startswith(("aten::empty", "aten::_local_scalar")):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if func in _OVERWRITE:
            ins = ins[1:]  # the destination is only written
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if func in _MATMULS:
            a, b = (args[0], args[1]) if func in (_aten.mm.default, _aten.bmm.default) else (
                args[1], args[2])
            self.flops += 2.0 * a.numel() * b.shape[-1]
        elif func in _FFT_REAL or func in _FFT_COMPLEX:
            self.flops += _fft_flops(func, args, outs[0])
        else:
            self.flops += sum(t.numel() for t in outs)
        self.ops += 1
        return out


def step_costs(step_fn, state, *args) -> dict:
    """flops and bytes of one eager call ``step_fn(state, *args)``, counted
    op by op (pre-fusion, see the module docstring)."""
    with CostMode() as mode:
        step_fn(state, *args)
    return {"flops": mode.flops, "bytes": mode.bytes, "aten_ops": mode.ops,
            "hand_kernel_launches": mode.kernels}


def _device_seconds(fn, reps: int) -> float:
    """Seconds per call of ``fn`` on the current CUDA stream, between two
    CUDA events after a warm-up."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e-3 / reps


def measure_peaks(device="cuda", n_mm: int = 2048, copy_mb: int = 64, reps: int = 20) -> dict:
    """Achievable peaks of the card: float32 matmul flop/s (an ``n_mm``³
    product, TF32 off) and device-memory bytes/s (a ``copy_mb`` MB copy,
    one read and one write stream). A CUDA device only: a CPU number is not
    a device peak."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"measure_peaks measures a CUDA device, got {device}")
    a = torch.full((n_mm, n_mm), 1.0 / n_mm, dtype=torch.float32, device=device)
    c = torch.empty_like(a)
    with full_fp32_matmul():
        sec = _device_seconds(lambda: torch.mm(a, a, out=c), reps)
    flops = 2.0 * n_mm**3 / sec
    n = int(copy_mb * 1e6 / 4)
    x = torch.ones(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    sec = _device_seconds(lambda: y.copy_(x), reps)
    return {"peak_flops": flops, "peak_bw": 2.0 * n * 4 / sec,
            "device": torch.cuda.get_device_name(device)}


def roofline(step_fn, state, n_cells: int, measured_cells_per_sec=None, peaks=None,
             *step_args) -> dict:
    """Roofline row for one tier: per-cell costs, the bound, the ceiling on
    this card's measured peaks (``peaks``, else :func:`measure_peaks` on the
    state's device) and on the data sheet's, and, given a measured rate,
    the share of the roof it reached."""
    costs = step_costs(step_fn, state, *step_args)
    f_c = costs["flops"] / n_cells
    b_c = costs["bytes"] / n_cells
    pk = peaks or measure_peaks(leaves(state)[0].device)
    roof_flops = pk["peak_flops"] / max(f_c, 1e-12)
    roof_bw = pk["peak_bw"] / max(b_c, 1e-12)
    ceiling = min(roof_flops, roof_bw)
    row = {
        "flops_per_cell": f_c,
        "bytes_per_cell": b_c,
        "intensity_flops_per_byte": f_c / max(b_c, 1e-12),
        "aten_ops_per_step": costs["aten_ops"],
        "hand_kernel_launches_per_step": costs["hand_kernel_launches"],
        "bound": "compute" if roof_flops < roof_bw else "bandwidth",
        "ceiling_cells_per_sec": ceiling,
        "datasheet_ceiling_cells_per_sec": min(DATASHEET_FLOPS_F32 / max(f_c, 1e-12),
                                               DATASHEET_BW / max(b_c, 1e-12)),
        "counts": "pre-fusion, per aten op",
    }
    if measured_cells_per_sec is not None:
        row["measured_cells_per_sec"] = measured_cells_per_sec
        row["pct_of_roof"] = 100.0 * measured_cells_per_sec / ceiling
        row["pct_of_datasheet_roof"] = (100.0 * measured_cells_per_sec
                                        / row["datasheet_ceiling_cells_per_sec"])
    return row
