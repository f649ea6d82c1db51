"""Red-black SOR sweeps: the CUDA kernels and their plain versions.

The port of ``cfdsim_tpu/ops/pallas/poisson_rb.py``:

- :func:`rbsor` (kernel A) is the counterpart of ``rbsor_pallas``'s
  single-block kernel: ``iters`` full red-black SOR sweeps of ∇²φ = rhs
  with relaxation ω, Neumann (clamped edge) or Dirichlet (fixed frame),
  with an optional solid mask (≥ 0.5) that freezes φ. With ``tol > 0`` it
  runs the early exit of ``solve_poisson(method="rbsor_pallas")``: up to
  ``max(1, iters // check_every)`` chunks of ``check_every`` sweeps, each
  run only while the max residual after the previous chunk is above
  ``tol``. :func:`plan_rbsor` picks its route by size and sweeps before
  the launch: a long solve on a large grid runs the whole solve, early
  exit included, in one cooperative launch of
  ``csrc/rbsor.cu::tiled::rbsor_kernel`` across the card (one CTA per
  tile, halo exchanges through L2 every few sweeps); another grid that
  fits the registers and shared memory of one thread-block cluster does
  so in one launch of ``rbsor_cluster_kernel``; a larger one, or a short
  solve on large bands, runs ``rbsor_kernel``, one cooperative launch per
  chunk with a device flag. The host never waits for the residual.
- :func:`rbsor_blocked` (kernel B, ``rbsor_blocked_kernel``) is the
  counterpart of ``rbsor_pallas_blocked``: Neumann, unmasked, temporally
  blocked, K = ``sweeps_per_pass`` sweeps per pass on tiles of
  ``rows_per_block`` × 128 cells with a 2K halo (:func:`plan_blocked`),
  then an ``iters % K`` tail pass; exactly ``iters`` global sweeps. Its
  ``parity0`` is the colour parity of the array's (0, 0) cell in a larger
  grid's indices: the distributed solve (``parallel/poisson2d_explicit.py``)
  sweeps a rank's block padded by a 2K halo as one array.
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
from typing import NamedTuple

import torch

from cfdsim_tpu_torch.ops.kernels.cuda_build import CudaKernel, report_cost
from cfdsim_tpu_torch.solvers.poisson import poisson_residual

# routing threshold of the JAX wrapper (its single-VMEM-block limit), kept
# for parity; where kernel A and B cross over on the H100 is not measured
MAX_ELEMS = 512 * 512
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90
MAX_CLUSTER = 16  # the largest cluster sm_90 allows (non-portable above 8)
CLUSTER_THREADS = 1024
# the cluster route gives a problem one CTA per this many cells (and at
# least as many as it needs to fit), up to the largest cluster the card
# schedules, so that a CTA's share of a half-sweep stays short
CELLS_PER_CTA = 4096
# The cluster route stages its bands once and then sweeps on at most 16
# SMs; the cooperative kernel sweeps on every SM with a grid sync per
# half-sweep. Bands of more than LARGE_BAND cells cost the cluster more than
# the syncs it saves unless the solve runs CLUSTER_MIN_SWEEPS sweeps or more
# (`bench --routes` on the H100: at 512², 16,384 cells per CTA, the cluster
# route takes 2.0× the cooperative kernel's time at 2 sweeps, 1.07× at 16,
# 0.98× at 32; at 180×600 masked, 7,200 cells per CTA, 0.98× at 2 and 0.76×
# at 4; at 256², 4,096 cells per CTA, 0.90× at 2)
LARGE_BAND = 8192
CLUSTER_MIN_SWEEPS = 32
# The tiled route spreads one solve over the whole card, one CTA per tile,
# and pays a halo exchange through L2 (1.45 µs on 132 CTAs, PERF.md) once
# every SWEEPS_PER_PASS sweeps: the masked 180×600 1500-sweep solve takes
# 2.39, 1.50, 1.30, 1.27, 1.21, 1.24 ms at K = 1 … 6 on the H100 (the
# cluster 2.84). `bench --routes` has it faster than the cluster and the
# cooperative kernel from 64² (4,096 cells) at 4 sweeps or more, and on
# most grids at 1 or 2, so TILED_MIN_CELLS is measured. TILED_MIN_SWEEPS
# is not a crossover but a fence: it keeps the multigrid's 2-sweep
# smoothing calls on the routes they were measured on. An early exit checked
# every few sweeps pays an exchange, a reduction and a grid sync a chunk,
# and still beats the cluster at a check every sweep (400 masked sweeps at
# 180×600: 1.61 ms against 1.84; at 240×720 1.84 against 3.19), so the
# rule reads the solve's sweeps, not a chunk's.
SWEEPS_PER_PASS = 5
TILE_WIDTH = 64  # staged columns of a tile: 32 column pairs, one warp a row
TILED_MIN_SWEEPS = 8
TILED_MIN_CELLS = 4096
TILE_ROWS_PER_THREAD = (1, 2, 4)  # the instantiations of tiled::rbsor_kernel
FLAG_STRIDE = 32  # words between two tiles' epoch flags (csrc/rbsor.cu): one 128-byte line
# kernel B's default tile rows (rows_per_block=None): 32 for passes of up
# to 2 sweeps, 64 above, where the 2K halo rows weigh more (PERF.md)
TILE_ROWS = (32, 64)
TILE_COLS = 128  # kernel B's tile columns
TMA_BOX_MAX = 256  # cells per dimension of one TMA box
B_ROUTES = {"tma": 0, "cp_async": 1}

_p = ctypes.c_void_p
_f = ctypes.c_float
_i = ctypes.c_int
FLOPS_PER_UPDATE = 11  # float32 operations of csrc/rbsor.cu::relax per cell update

KERNEL_A = CudaKernel(
    "rbsor.cu",
    "cfd_rbsor_cluster",
    # φ, rhs, mask, ny, nx, cluster, rows per CTA, threads, rows per thread,
    # shared bytes, sweeps per chunk, chunks, ax, ay, denom_inv, ω, 1−ω,
    # dirichlet, count, tol, 2(ax+ay), stream
    [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _f, _i, _p, _f, _f, _p],
)
KERNEL_A_COOP = CudaKernel(
    "rbsor.cu",
    "cfd_rbsor",
    # φ, rhs, mask, ny, nx, iters, ax, ay, denom_inv, ω, 1−ω, dirichlet,
    # ctl, count, tol, 2(ax+ay), stream
    [_p, _p, _p, _i, _i, _i, _f, _f, _f, _f, _f, _i, _p, _p, _f, _f, _p],
)
KERNEL_A_TILED = CudaKernel(
    "rbsor.cu",
    "cfd_rbsor_tiled",
    # φ, rhs, mask, ny, nx, tile rows, tile cols, rows per thread, sweeps per
    # pass, sweeps per chunk, chunks, ax, ay, denom_inv, ω, 1−ω, dirichlet,
    # count, tol, 2(ax+ay), exchange buffers, flags, flag words, stream
    [_p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _f, _i, _p, _f, _f, _p, _p, _i,
     _p],
)
KERNEL_B = CudaKernel(
    "rbsor.cu",
    "cfd_rbsor_blocked",
    # φ in, rhs, φ out, ny, nx, sweeps, tile rows, tile cols, route, ax, ay,
    # denom_inv, ω, 1−ω, parity0, stream
    [_p, _p, _p, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _f, _i, _p],
)
KERNELS = (KERNEL_A, KERNEL_A_COOP, KERNEL_A_TILED, KERNEL_B)


class RbsorPlan(NamedTuple):
    """How kernel A runs one problem: ``route`` "cluster" (the grid in one
    cluster of ``cluster`` CTAs of ``threads`` threads, each CTA a band of
    ``rows_per_cta`` rows or one fewer, each thread a column pair over
    ``rows_per_thread`` rows, with ``smem_bytes`` of shared memory),
    "tiled" (``tiles`` CTAs, each owning a tile of ``rows_per_cta`` ×
    ``tile_cols`` cells and sweeping ``sweeps_per_pass`` sweeps between halo
    exchanges; threads, rows per thread and shared memory as the cluster's)
    or "cooperative" (the other fields 0)."""

    route: str
    cluster: int = 0
    rows_per_cta: int = 0
    threads: int = 0
    rows_per_thread: int = 0
    smem_bytes: int = 0
    tiles: int = 0
    tile_cols: int = 0
    sweeps_per_pass: int = 0


ROWS_PER_THREAD = (1, 2, 4, 8)  # the instantiations of rbsor_cluster_kernel


def band_plan(shape, cluster: int, smem_limit: int):
    """(rows per CTA, threads, rows per thread, shared bytes) of a cluster
    of ``cluster`` CTAs, or None where a band does not fit one CTA: a
    thread holds one column pair (threads per row: the pairs rounded up to
    a warp) over at most 8 rows, a CTA at most 1024 threads; the shared
    memory holds φ with a halo row per side, two sets of residual slots,
    scratch and two halo mbarriers."""
    ny, nx = shape
    rows = -(-ny // cluster)
    hw = (nx + 1) // 2
    tx = -(-hw // 32) * 32
    if tx > CLUSTER_THREADS:
        return None
    need = -(-rows // (CLUSTER_THREADS // tx))
    rt = next((r for r in ROWS_PER_THREAD if r >= need), None)
    smem = 4 * ((rows + 2) * 2 * hw + 2 * MAX_CLUSTER + 32) + 16
    if rt is None or smem > smem_limit:
        return None
    return rows, tx * -(-rows // rt), rt, smem


def tile_plan(shape, sms: int, sweeps_per_pass: int = SWEEPS_PER_PASS):
    """The tiled route's plan on a card of ``sms`` SMs, or None where the
    grid needs more tiles than that: windows :data:`TILE_WIDTH` columns
    wide, so a tile owns ``TILE_WIDTH − 4K`` columns (K sweeps a pass, a
    halo of 2K a side); as many rows of tiles as the SMs left allow, each
    tile at least 2K rows (so its halo reaches only the 8 tiles around it);
    each thread a column pair over the fewest rows
    (:data:`TILE_ROWS_PER_THREAD`) that keep a CTA at 1024 threads. Shared
    memory: the window with a spare row per side, and 32 words of scratch."""
    ny, nx = shape
    halo = 2 * sweeps_per_pass
    cols = TILE_WIDTH - 2 * halo
    tiles_x = -(-nx // cols)
    if cols < halo or tiles_x > sms:
        return None
    rows = max(halo, -(-ny // (sms // tiles_x)))
    staged = rows + 2 * halo
    rt = next((r for r in TILE_ROWS_PER_THREAD
               if -(-staged // r) * TILE_WIDTH // 2 <= CLUSTER_THREADS), None)
    if rt is None:
        return None
    return RbsorPlan("tiled", rows_per_cta=rows, threads=TILE_WIDTH // 2 * -(-staged // rt),
                     rows_per_thread=rt, smem_bytes=4 * ((staged + 2) * TILE_WIDTH + 32),
                     tiles=tiles_x * -(-ny // rows), tile_cols=cols,
                     sweeps_per_pass=sweeps_per_pass)


def plan_rbsor(shape, max_cluster: int, smem_limit: int = SMEM_LIMIT,
               sweeps: int | None = None, sms: int = 0) -> RbsorPlan:
    """Kernel A's route for a grid of ``shape`` and a solve of at most
    ``sweeps`` sweeps (None: any number), chosen before the launch: on a
    card of ``sms`` SMs (0: the tiled route is not considered) the tiled
    route (:func:`tile_plan`) for a solve of at least
    :data:`TILED_MIN_SWEEPS` sweeps on at least :data:`TILED_MIN_CELLS`
    cells; else the cluster route when the grid fits one cluster of at most
    ``max_cluster`` CTAs (:func:`band_plan`), with one CTA per
    :data:`CELLS_PER_CTA` cells and at least as many as it needs, unless its
    bands hold more than :data:`LARGE_BAND` cells and the solve runs fewer
    than :data:`CLUSTER_MIN_SWEEPS` sweeps; else the cooperative route."""
    ny, nx = shape
    if sms and sweeps is not None and sweeps >= TILED_MIN_SWEEPS and ny * nx >= TILED_MIN_CELLS:
        plan = tile_plan(shape, sms)
        if plan is not None:
            return plan
    most = min(max_cluster, MAX_CLUSTER, ny)
    fits = [c for c in range(1, most + 1) if band_plan(shape, c, smem_limit)]
    if not fits:
        return RbsorPlan("cooperative")
    cluster = max(fits[0], min(most, -(-ny * nx // CELLS_PER_CTA)))
    plan = RbsorPlan("cluster", cluster, *band_plan(shape, cluster, smem_limit))
    if sweeps is not None and plan.rows_per_cta * nx > LARGE_BAND and sweeps < CLUSTER_MIN_SWEEPS:
        return RbsorPlan("cooperative")
    return plan


class BlockedPlan(NamedTuple):
    """How kernel B runs one pass: one block per centre tile of
    ``tile_rows`` × ``tile_cols`` with a 2K halo, loaded by ``route``
    ("tma" where the row pitch is a multiple of 16 bytes, else
    "cp_async"), in ``smem_bytes``."""

    tile_rows: int
    tile_cols: int
    route: str
    smem_bytes: int


def plan_blocked(shape, sweeps: int, rows_per_block=None,
                 smem_limit: int = SMEM_LIMIT) -> BlockedPlan:
    """Kernel B's tiles and load route for one pass of ``sweeps`` sweeps.
    Raises for a tile that fits neither a TMA box nor the shared memory."""
    ny, nx = shape
    if rows_per_block is None:
        rows = TILE_ROWS[0] if sweeps <= 2 else TILE_ROWS[1]
    else:
        rows = int(rows_per_block)
    if rows < 1 or sweeps < 1:
        raise ValueError(f"tile rows {rows} and sweeps per pass {sweeps} must be ≥ 1")
    # halo: 2K rows and 2K columns per side, the columns rounded up to 4 so
    # that a staged row starts on a 16-byte boundary (a TMA box must)
    sh, sw = rows + 4 * sweeps, TILE_COLS + 2 * (-(-2 * sweeps // 4) * 4)
    if max(sh, sw) > TMA_BOX_MAX:
        raise ValueError(f"a {rows}×{TILE_COLS} tile with {sweeps} sweeps per pass stages "
                         f"{sh}×{sw} cells, above {TMA_BOX_MAX} per dimension")
    arr = -(-sh * sw // 32) * 32  # csrc/rbsor.cu: each array rounded up to 128 bytes
    smem = 2 * arr * 4 + 8  # φ, rhs and the TMA route's mbarrier
    if smem > smem_limit:
        raise ValueError(f"a {rows}×{TILE_COLS} tile with {sweeps} sweeps per pass needs "
                         f"{smem} bytes of shared memory, above {smem_limit}")
    return BlockedPlan(rows, TILE_COLS, "tma" if nx % 4 == 0 else "cp_async", smem)


_max_cluster: dict = {}


def max_cluster(device) -> int:
    """The largest cluster of kernel A's cluster route that ``device`` can
    schedule at full size (1024 threads and all shared memory per CTA),
    asked once per device."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _max_cluster:
        fn = KERNEL_A.library().cfd_rbsor_max_cluster
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(SMEM_LIMIT, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"cannot size kernel A's cluster: CUDA error {rc} "
                               f"({KERNEL_A.error_string(rc)})")
        _max_cluster[index] = out.value
    return _max_cluster[index]


def card_sms(device) -> int:
    """The SMs of ``device``: the tiled route's most tiles."""
    return torch.cuda.get_device_properties(torch.device(device)).multi_processor_count


def _coeffs(dx: float, dy: float):
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)
    return ax, ay, 1.0 / (2.0 * (ax + ay))


def _colours(shape, bc: str, solid_mask, device, parity0: int = 0):
    """(red, black) boolean masks of the updatable cells; red cells have
    i + j + ``parity0`` even."""
    ny, nx = shape
    i = torch.arange(ny, device=device)[:, None]
    j = torch.arange(nx, device=device)[None, :]
    red = (i + j + parity0) % 2 == 0
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
              check_every: int = 8, chunks_run=None, parity0: int = 0):
    """Plain torch red-black SOR (the sweeps kernel A runs). With
    ``tol > 0``, the early exit; ``chunks_run`` (a 0-dim int32 tensor, or
    None) is incremented by each chunk that runs. ``parity0`` offsets the
    colours (:func:`_colours`)."""
    colours = _colours(tuple(phi0.shape), bc, solid_mask, phi0.device, parity0)
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
                      omega: float = 1.7, rows_per_block=None, sweeps_per_pass: int = 8,
                      parity0: int = 0):
    """Plain version of :func:`rbsor_blocked`: the blocked passes are
    defined to equal ``iters`` global Neumann sweeps, so it runs those."""
    return rbsor_ref(phi0, rhs, dx, dy, iters=iters, omega=omega, parity0=parity0)


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
    run increments (on the device, in the kernel). The route is
    :func:`plan_rbsor`'s for the most sweeps the solve runs."""
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
    if tol > 0.0 and chunks_run is not None and (chunks_run.device != device
                                                 or chunks_run.dtype != torch.int32
                                                 or chunks_run.numel() != 1):
        raise ValueError("chunks_run must be one int32 value on the fields' device")
    # the most sweeps the solve runs: every chunk of the early exit
    check = max(1, check_every)
    sweeps = max(1, iters // check) * check if tol > 0.0 else iters
    plan = plan_rbsor(shape, max_cluster(device), sweeps=sweeps, sms=card_sms(device))
    with torch.cuda.device(device):
        solve_a(out, rhs, mask, plan, dx, dy, iters, omega, bc, tol, check_every, chunks_run)
    return out


def solve_a(phi, rhs, mask, plan: RbsorPlan, dx: float, dy: float, iters: int, omega: float,
            bc: str = "neumann", tol: float = 0.0, check_every: int = 8, chunks_run=None):
    """Kernel A on checked CUDA fields by ``plan``: φ is updated in place.
    :func:`rbsor` is the wrapper; this is its launch, for a caller that
    measures one route."""
    ax, ay, denom_inv = _coeffs(dx, dy)
    ny, nx = phi.shape
    stream = torch.cuda.current_stream(phi.device).cuda_stream
    coeffs = (ax, ay, denom_inv, omega, 1.0 - omega, int(bc == "dirichlet"))
    mask_ptr = None if mask is None else mask.data_ptr()
    check = max(1, check_every)
    count_ptr = None if chunks_run is None or tol <= 0.0 else chunks_run.data_ptr()
    # φ, rhs (and the mask) in, φ out; every cell updated in every sweep the
    # solve may run (all chunks of an early exit, masked cells included):
    # an upper bound that reads nothing back from the device
    fields = 3 if mask is None else 4
    most = max(1, iters // check) * check if tol > 0.0 else iters
    report_cost(4 * fields * ny * nx, FLOPS_PER_UPDATE * ny * nx * most)
    # the cluster and tiled routes run the whole early exit in one launch: up
    # to max(1, iters // check) chunks of `check` sweeps; without tol one
    # chunk of `iters`
    sweeps, chunks = (check, max(1, iters // check)) if tol > 0.0 else (iters, 1)
    if plan.route == "cluster":
        KERNEL_A(phi.data_ptr(), rhs.data_ptr(), mask_ptr, ny, nx, plan.cluster,
                 plan.rows_per_cta, plan.threads, plan.rows_per_thread, plan.smem_bytes,
                 sweeps, chunks, *coeffs, count_ptr, float(tol), 2.0 * (ax + ay), stream)
        return
    if plan.route == "tiled":
        # scratch the kernel resets itself: two exchange buffers, an epoch
        # flag per tile and three residual slots (no fill launch)
        xbuf = torch.empty((2, ny, nx), dtype=torch.float32, device=phi.device)
        flags = torch.empty(FLAG_STRIDE * plan.tiles + 3, dtype=torch.int32, device=phi.device)
        KERNEL_A_TILED(phi.data_ptr(), rhs.data_ptr(), mask_ptr, ny, nx, plan.rows_per_cta,
                       plan.tile_cols, plan.rows_per_thread, plan.sweeps_per_pass, sweeps, chunks,
                       *coeffs, count_ptr, float(tol), 2.0 * (ax + ay), xbuf.data_ptr(),
                       flags.data_ptr(), flags.numel(), stream)
        return
    if tol <= 0.0:
        KERNEL_A_COOP(phi.data_ptr(), rhs.data_ptr(), mask_ptr, ny, nx, iters, *coeffs,
                      None, None, 0.0, 2.0 * (ax + ay), stream)
        return
    # one launch per chunk; ctl[0] = active, ctl[1] holds the residual's
    # bits, which each chunk zeroes before it reduces (a device fill: no
    # host copy, so the solve can be captured in a CUDA graph)
    ctl = torch.ones(2, dtype=torch.int32, device=phi.device)
    for _ in range(max(1, iters // check)):
        KERNEL_A_COOP(phi.data_ptr(), rhs.data_ptr(), mask_ptr, ny, nx, check, *coeffs,
                      ctl.data_ptr(), count_ptr, float(tol), 2.0 * (ax + ay), stream)


def _aligned(t):
    """``t``, or a fresh copy where its data is not 16-byte aligned (TMA and
    cp.async read whole aligned vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rbsor_blocked(phi0, rhs, dx: float, dy: float, iters: int = 100, omega: float = 1.7,
                  rows_per_block=None, sweeps_per_pass: int = 8, parity0: int = 0):
    """Temporally blocked Neumann red-black SOR through kernel B: ``iters //
    K`` passes of K = min(``sweeps_per_pass``, ``iters``) sweeps, then one
    pass of ``iters % K``; tiles of ``rows_per_block`` (default
    :data:`TILE_ROWS`) × 128 cells, by :func:`plan_blocked`. Red cells
    have i + j + ``parity0`` even (0: the array's own checkerboard)."""
    if parity0 not in (0, 1):
        raise ValueError(f"parity0 is 0 or 1, got {parity0!r}")
    if _on_cpu(phi0, rhs):
        return rbsor_blocked_ref(phi0, rhs, dx, dy, iters, omega, rows_per_block,
                                 sweeps_per_pass, parity0)
    _check_grid(phi0)
    device, shape = phi0.device, tuple(phi0.shape)
    rhs = _aligned(_field("rhs", rhs, device, shape))
    src = _aligned(_field("phi0", phi0, device, shape))
    if iters <= 0:
        return src.clone()
    k = min(int(sweeps_per_pass), iters)
    if k < 1:
        raise ValueError(f"sweeps per pass {k} must be ≥ 1")
    passes = [k] * (iters // k) + ([iters % k] if iters % k else [])
    plans = {n: plan_blocked(shape, n, rows_per_block) for n in set(passes)}  # raise before any launch
    ax, ay, denom_inv = _coeffs(dx, dy)
    ny, nx = shape
    stream = torch.cuda.current_stream(device).cuda_stream
    bufs = (torch.empty_like(src), torch.empty_like(src) if len(passes) > 1 else None)
    with torch.cuda.device(device):
        for n, sweeps in enumerate(passes):
            dst, plan = bufs[n % 2], plans[sweeps]
            KERNEL_B(src.data_ptr(), rhs.data_ptr(), dst.data_ptr(), ny, nx, sweeps,
                     plan.tile_rows, plan.tile_cols, B_ROUTES[plan.route],
                     ax, ay, denom_inv, omega, 1.0 - omega, parity0, stream)
            report_cost(12 * ny * nx, FLOPS_PER_UPDATE * ny * nx * sweeps)  # φ, rhs in; φ out
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
