"""Red-black SOR sweeps: the two CUDA kernels and their plain versions.

The port of ``cfdsim_tpu/ops/pallas/poisson_rb.py``:

- :func:`rbsor` (kernel A, ``csrc/rbsor.cu::rbsor_kernel``) is the
  counterpart of ``rbsor_pallas``'s single-block kernel: ``iters`` full
  red-black SOR sweeps of ∇²φ = rhs with relaxation ω, Neumann (clamped
  edge) or Dirichlet (fixed frame), with an optional solid mask (≥ 0.5)
  that freezes φ. With ``tol > 0`` it runs the early exit of
  ``solve_poisson(method="rbsor_pallas")``: up to ``max(1, iters //
  check_every)`` chunks of ``check_every`` sweeps, each run only while the
  max residual after the previous chunk is above ``tol``. On the card each
  chunk is one launch that reads and writes a device flag, so the host
  never waits for the residual.
- :func:`rbsor_blocked` (kernel B, ``rbsor_blocked_kernel``) is the
  counterpart of ``rbsor_pallas_blocked``: Neumann, unmasked, temporally
  blocked, K = ``sweeps_per_pass`` sweeps per pass on tiles of edge
  ``rows_per_block`` with a 2K halo, then an ``iters % K`` tail pass;
  exactly ``iters`` global sweeps.
- :func:`rbsor_routed` keeps the JAX wrapper's routing rule: Neumann,
  unmasked and larger than :data:`MAX_ELEMS` goes to :func:`rbsor_blocked`,
  everything else to :func:`rbsor` (which has no size limit on the card,
  so the oversize masked or Dirichlet problem the JAX package streams
  through jnp runs kernel A here).

On a CUDA tensor each wrapper launches its kernel (built for sm_90a at
first use) or raises; on a CPU tensor it runs the plain torch version of
the same signature, :func:`rbsor_ref` or :func:`rbsor_blocked_ref`.
Nothing falls back from one to the other. The kernels spell out every
rounding, so they give the plain versions' bits.
"""

from __future__ import annotations

import ctypes

import torch

from cfdsim_tpu_torch.ops.kernels.cuda_build import CudaKernel
from cfdsim_tpu_torch.solvers.poisson import poisson_residual

# routing threshold of the JAX wrapper (its single-VMEM-block limit), kept
# for parity; where kernel A and B cross over on the H100 is not measured
MAX_ELEMS = 512 * 512
TILE = 32  # kernel B's default tile edge (rows_per_block=None)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90

_p = ctypes.c_void_p
_f = ctypes.c_float
_i = ctypes.c_int
KERNEL_A = CudaKernel(
    "rbsor.cu",
    "cfd_rbsor",
    # φ, rhs, mask, ny, nx, iters, ax, ay, denom_inv, ω, 1−ω, dirichlet,
    # ctl, count, tol, 2(ax+ay), stream
    [_p, _p, _p, _i, _i, _i, _f, _f, _f, _f, _f, _i, _p, _p, _f, _f, _p],
)
KERNEL_B = CudaKernel(
    "rbsor.cu",
    "cfd_rbsor_blocked",
    # φ in, rhs, φ out, ny, nx, sweeps, tile, ax, ay, denom_inv, ω, 1−ω, stream
    [_p, _p, _p, _i, _i, _i, _i, _f, _f, _f, _f, _f, _p],
)


def _coeffs(dx: float, dy: float):
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    return ax, ay, 1.0 / (2.0 * (ax + ay))


def _colours(shape, bc: str, solid_mask, device):
    """(red, black) boolean masks of the updatable cells."""
    ny, nx = shape
    i = torch.arange(ny, device=device)[:, None]
    j = torch.arange(nx, device=device)[None, :]
    red = (i + j) % 2 == 0
    upd = torch.ones(shape, dtype=torch.bool, device=device)
    if bc != "neumann":  # dirichlet: the frame is fixed
        upd = torch.zeros_like(upd)
        upd[1:-1, 1:-1] = True
    if solid_mask is not None:
        upd = upd & (solid_mask < 0.5 if solid_mask.is_floating_point() else ~solid_mask)
    return red & upd, ~red & upd


def _nbsum(p, ax: float, ay: float):
    """((E + W)·ax + ay·N) + ay·S with clamped edges: the Pallas kernel's
    order (the streaming solver sums ax·(E+W) + ay·(N+S))."""
    e = torch.cat([p[:, 1:], p[:, -1:]], 1)
    w = torch.cat([p[:, :1], p[:, :-1]], 1)
    n = torch.cat([p[1:], p[-1:]], 0)
    s = torch.cat([p[:1], p[:-1]], 0)
    acc = (e + w) * ax
    acc = acc + ay * n
    return acc + ay * s


def _sweeps_ref(phi, rhs, dx, dy, iters, omega, colours):
    ax, ay, denom_inv = _coeffs(dx, dy)
    for _ in range(iters):
        for colour in colours:
            star = (_nbsum(phi, ax, ay) - rhs) * denom_inv
            phi = torch.where(colour, (1.0 - omega) * phi + omega * star, phi)
    return phi


def rbsor_ref(phi0, rhs, dx: float, dy: float, iters: int = 100, omega: float = 1.7,
              bc: str = "neumann", solid_mask=None, tol: float = 0.0,
              check_every: int = 8, chunks_run=None):
    """Plain torch red-black SOR (the sweeps kernel A runs). With
    ``tol > 0``, the early exit; ``chunks_run`` (a 0-dim int32 tensor, or
    None) is incremented by each chunk that runs."""
    colours = _colours(tuple(phi0.shape), bc, solid_mask, phi0.device)
    if tol <= 0.0:
        return _sweeps_ref(phi0, rhs, dx, dy, iters, omega, colours)
    check = max(1, check_every)
    phi = phi0
    for _ in range(max(1, iters // check)):
        phi = _sweeps_ref(phi, rhs, dx, dy, check, omega, colours)
        if chunks_run is not None:
            chunks_run += 1
        # the plain version stops on the host; the kernel does not read back
        if not bool(poisson_residual(phi, rhs, dx, dy, solid_mask, bc) > tol):
            break
    return phi


def rbsor_blocked_ref(phi0, rhs, dx: float, dy: float, iters: int = 100,
                      omega: float = 1.7, rows_per_block=None, sweeps_per_pass: int = 8):
    """Plain version of :func:`rbsor_blocked`: the blocked passes are
    defined to equal ``iters`` global Neumann sweeps, so it runs those."""
    return rbsor_ref(phi0, rhs, dx, dy, iters=iters, omega=omega)


def _field(name: str, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.requires_grad:
        raise RuntimeError("the RB-SOR kernels have no backward")
    return t.contiguous()


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"}:
        raise ValueError(f"the RB-SOR kernels run on cuda or cpu tensors, got {devices}")
    return False


def _check_grid(phi0):
    if phi0.ndim != 2 or min(phi0.shape) < 2:
        raise ValueError(f"φ must be a 2D grid of at least 2×2, got {tuple(phi0.shape)}")
    if phi0.numel() >= 2**31:
        raise ValueError(f"grid of {phi0.numel()} cells: the kernels index with 32-bit ints")


def rbsor(phi0, rhs, dx: float, dy: float, iters: int = 100, omega: float = 1.7,
          bc: str = "neumann", solid_mask=None, tol: float = 0.0,
          check_every: int = 8, chunks_run=None):
    """Red-black SOR through kernel A; returns a new φ.

    ``solid_mask`` is bool or float (≥ 0.5 = solid). ``chunks_run``, if
    given, is a 0-dim int32 tensor on the fields' device that each chunk
    run increments (on the device, in the kernel)."""
    if bc not in ("neumann", "dirichlet"):
        raise ValueError(f"rbsor solves bc 'neumann' or 'dirichlet', got {bc!r}")
    if _on_cpu(phi0, rhs, solid_mask):
        return rbsor_ref(phi0, rhs, dx, dy, iters, omega, bc, solid_mask, tol,
                         check_every, chunks_run)
    _check_grid(phi0)
    device, shape = phi0.device, tuple(phi0.shape)
    rhs = _field("rhs", rhs, device, shape)
    out = _field("phi0", phi0, device, shape).clone()
    mask = None
    if solid_mask is not None:
        mask = _field("solid_mask", solid_mask.to(torch.float32), device, shape)
    ax, ay, denom_inv = _coeffs(dx, dy)
    ny, nx = shape
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (ny, nx)
    coeffs = (ax, ay, denom_inv, omega, 1.0 - omega, int(bc == "dirichlet"))
    mask_ptr = None if mask is None else mask.data_ptr()
    with torch.cuda.device(device):
        if tol <= 0.0:
            KERNEL_A(out.data_ptr(), rhs.data_ptr(), mask_ptr, *args, iters, *coeffs,
                     None, None, 0.0, 2.0 * (ax + ay), stream)
            return out
        if chunks_run is not None and (chunks_run.device != device
                                       or chunks_run.dtype != torch.int32
                                       or chunks_run.numel() != 1):
            raise ValueError("chunks_run must be one int32 value on the fields' device")
        # ctl[0] = active; ctl[1] holds the residual's bits, which each
        # chunk zeroes before it reduces (a device fill: no host copy, so
        # the solve can be captured in a CUDA graph)
        ctl = torch.ones(2, dtype=torch.int32, device=device)
        check = max(1, check_every)
        count_ptr = None if chunks_run is None else chunks_run.data_ptr()
        for _ in range(max(1, iters // check)):
            KERNEL_A(out.data_ptr(), rhs.data_ptr(), mask_ptr, *args, check, *coeffs,
                     ctl.data_ptr(), count_ptr, float(tol), 2.0 * (ax + ay), stream)
    return out


def _tile_and_sweeps(iters: int, rows_per_block, sweeps_per_pass: int):
    tile = TILE if rows_per_block is None else int(rows_per_block)
    k = min(int(sweeps_per_pass), iters)
    if tile < 1 or k < 1:
        raise ValueError(f"tile edge {tile} and sweeps per pass {k} must be ≥ 1")
    edge = tile + 4 * k
    if 2 * edge * edge * 4 > SMEM_LIMIT:
        raise ValueError(
            f"a {tile}-cell tile with {k} sweeps per pass needs {2 * edge * edge * 4} "
            f"bytes of shared memory, above {SMEM_LIMIT}")
    return tile, k


def rbsor_blocked(phi0, rhs, dx: float, dy: float, iters: int = 100, omega: float = 1.7,
                  rows_per_block=None, sweeps_per_pass: int = 8):
    """Temporally blocked Neumann red-black SOR through kernel B: ``iters //
    K`` passes of K = min(``sweeps_per_pass``, ``iters``) sweeps, then one
    pass of ``iters % K``; tiles of edge ``rows_per_block`` (default 32)."""
    if _on_cpu(phi0, rhs):
        return rbsor_blocked_ref(phi0, rhs, dx, dy, iters, omega, rows_per_block,
                                 sweeps_per_pass)
    _check_grid(phi0)
    device, shape = phi0.device, tuple(phi0.shape)
    rhs = _field("rhs", rhs, device, shape)
    src = _field("phi0", phi0, device, shape)
    if iters <= 0:
        return src.clone()
    tile, k = _tile_and_sweeps(iters, rows_per_block, sweeps_per_pass)
    ax, ay, denom_inv = _coeffs(dx, dy)
    ny, nx = shape
    stream = torch.cuda.current_stream(device).cuda_stream
    passes = [k] * (iters // k) + ([iters % k] if iters % k else [])
    bufs = (torch.empty_like(src), torch.empty_like(src) if len(passes) > 1 else None)
    with torch.cuda.device(device):
        for n, sweeps in enumerate(passes):
            dst = bufs[n % 2]
            KERNEL_B(src.data_ptr(), rhs.data_ptr(), dst.data_ptr(), ny, nx, sweeps, tile,
                     ax, ay, denom_inv, omega, 1.0 - omega, stream)
            src = dst
    return src


def rbsor_routed(phi0, rhs, dx: float, dy: float, iters: int = 100, omega: float = 1.7,
                 bc: str = "neumann", solid_mask=None):
    """``iters`` sweeps by the JAX wrapper's rule: Neumann, unmasked and
    above :data:`MAX_ELEMS` through :func:`rbsor_blocked`, else
    :func:`rbsor`."""
    if phi0.numel() > MAX_ELEMS and bc == "neumann" and solid_mask is None:
        return rbsor_blocked(phi0, rhs, dx, dy, iters=iters, omega=omega)
    return rbsor(phi0, rhs, dx, dy, iters=iters, omega=omega, bc=bc, solid_mask=solid_mask)
