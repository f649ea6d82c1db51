"""Benchmarks of the port on one CUDA card.

The headline number is cell-updates/sec on the 1024² lid-driven cavity,
Re=1000 (the step ``bench.py::run_bench`` of the JAX package times). The
full step runs: adaptive CFL dt, central convection and diffusion (the
fused predictor kernel when ``fused_predictor``), BCs, the exact DCT
pressure projection with ``dct_variant="auto"``: the fastest variant on
this card, measured once per shape when the step is built and cached
(``solvers/autotune.py``); the row names the variant that won. Throughput
is measured marginally between a short and a long chunk of steps from the
same initial state, so the per-chunk constant (first-launch and
synchronisation cost) cancels. Each chunk ends in
``torch.cuda.synchronize()``. A chunk is what
``models/incompressible.py::make_chunk`` builds: on the card one captured
device program (the ``"graph"`` route, the path's metric, as the JAX bench
times a jitted chunk); ``route="loop"`` times the eager Python loop of step
calls beside it, host dispatch included.

``--sweep`` adds, per grid size, the device times of the predictor (kernel,
plain torch, a plain copy of the same bytes and an empty launch), of one DCT
solve by every variant and of one step (fused and unfused), next to the
chunk's and the eager loop's cells/s. ``--profile`` counts the device
events of a chunk of steps under ``torch.profiler`` and sets the device's
busy time against the wall time, for both routes, on every path: the
collocated ones, the staggered tiers' with their ghost-IBM cylinders
(:func:`mac_paths`), the Boussinesq cavities, the 3D cavities, the 3D
bodies (:func:`sphere_paths`) and the compressible and spectral cells. ``--all`` is the twin of the JAX bench's
``run_secondary``: marginal streaming rbsor sweeps/s, RB-SOR kernel
sweeps/s, multigrid V-cycles/s (kernel and plain smoothing) and DCT
solves/s at 1024², the device time of one Dirichlet Helmholtz (DST) solve,
the MAC-1024², stretched-512² and sphere-192×96×96 cells/s, and ms per step
of the implicit cavity, the LES cylinder, the transport cavity, the 1024²
heated cavity (DCT and ``mg:2``), the 256³ cavities, the 3D bodies and
the compressible and spectral cells (:func:`run_paths` over
:func:`new_paths`, :func:`boussinesq_paths`, :func:`threed_paths`,
:func:`sphere_paths`, :func:`compressible_paths` and
:func:`spectral_paths`), and the FEM cylinder's monolithic and projection
steps/s (:func:`run_fem`; ``--fem`` runs those alone). ``--roofline`` is the twin
of ``run_roofline``: the card's measured peaks and, per tier (the sphere
included), flops and bytes per cell of one step (``utils/roofline.py``,
pre-fusion counts) against them. ``--cylinder``
times the reference-parity cylinder at 600×180 with its pressure solve
through kernel A and through streaming rbsor. ``--routes`` times kernel
A's cluster, cooperative and tiled routes side by side per grid and sweep
count, the measurement behind ``poisson_rb.plan_rbsor``. Every function here
refuses to run without a CUDA device: a CPU number is not a device metric.

    python -m cfdsim_tpu_torch bench [--n 1024]
    python -m cfdsim_tpu_torch bench --sweep
    python -m cfdsim_tpu_torch bench --profile [--n 1024]
    python -m cfdsim_tpu_torch bench --all [--n 1024]
    python -m cfdsim_tpu_torch bench --fem
    python -m cfdsim_tpu_torch bench --roofline [--n 1024]
    python -m cfdsim_tpu_torch bench --cylinder
    python -m cfdsim_tpu_torch bench --routes
"""

from __future__ import annotations

import ctypes
import itertools
import math
import time

import numpy as np
import torch

from cfdsim_tpu_torch.cases import (
    Case,
    build,
    cavity3d,
    cavity3d_mac,
    cavity_stretched,
    cylinder,
    heated_cavity,
    lid_cavity,
    lid_cavity_mac,
    transport,
)
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ibm import cylinder_masks
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.ops.kernels import poisson_rb
from cfdsim_tpu_torch.ops.kernels import predictor as pred
from cfdsim_tpu_torch.ops.kernels.cuda_build import build_library
from cfdsim_tpu_torch.ops.kernels.predictor import (
    fused_predictor_central,
    fused_predictor_central_ref,
)
from cfdsim_tpu_torch.solvers.helmholtz import DirichletHelmholtz
from cfdsim_tpu_torch.solvers.autotune import _variants_for
from cfdsim_tpu_torch.solvers.poisson import NeumannDCT, PoissonConfig, PoissonSolver
from cfdsim_tpu_torch.utils.profiling import card_name_and_power_limit, device_ms, eager_ms
from cfdsim_tpu_torch.utils.tree import leaves

# the JAX bench's main path (bench.py:54): the fastest exact DCT variant on
# this card, measured once per shape and cached (solvers/autotune.py)
POISSON = PoissonConfig(method="dct", dct_variant="auto")
# the staggered tier's twin (bench.py:131-132): the default DCT variant
MAC_POISSON = PoissonConfig(method="dct")
# the reference-parity cylinder's pressure budget through kernel A
CYLINDER_KERNEL_POISSON = PoissonConfig(method="rbsor_pallas", iters=1500, tol=1e-8,
                                        check_every=50, omega=1.7)


def _require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the benchmark measures a CUDA device; got {device}")
    return device


def _cavity(n, fused_predictor, device):
    return lid_cavity(n=n, Re=1000.0, poisson=POISSON, compute_metrics=False,
                      fused_predictor=fused_predictor, device=device)


def _timed_chunk(case, state, n_steps: int, route=None):
    """(best seconds of 3 runs, final state, the chunk) for ``n_steps`` steps
    from ``state`` through :func:`make_chunk`'s chunk: the captured program
    on the card, or with ``route="loop"`` the eager loop (on a CPU state,
    the loop, timed without a device synchronisation)."""
    chunk = make_chunk(case.cfg, case.step, n_steps, route=route, keep_graph=True)

    def sync():
        if state.t.device.type == "cuda":
            torch.cuda.synchronize(state.t.device)

    out, _ = chunk(state, 1.0)  # warm-up: kernel build and load, cuFFT plans, the capture
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = chunk(state, 1.0)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out, chunk


def _chunk_facts(chunk) -> dict:
    """The route a chunk took and, for a captured one, what its capture cost."""
    facts = {"route": chunk.mode}
    if chunk.program is not None:
        facts.update(steps_per_graph=chunk.steps_per_graph, nodes=chunk.program.nodes,
                     capture_s=chunk.program.capture_seconds)
    return facts


def run_bench(n=1024, short=100, long=600, device="cuda", fused_predictor=True, route=None):
    case = _cavity(n, fused_predictor, _require_cuda(device))
    t_short, _, _ = _timed_chunk(case, case.state, short, route)
    t_long, state_l, chunk = _timed_chunk(case, case.state, long, route)

    # sanity: the simulation must be healthy after the long chunk
    if not bool(torch.isfinite(state_l.u).all()):
        raise RuntimeError("non-finite state after the long chunk")
    max_u = float(state_l.u.abs().max())
    if max_u > 1.5:
        raise RuntimeError(f"velocity blow-up: {max_u}")

    cups = n * n * (long - short) / (t_long - t_short)
    return {
        "metric": f"cell_updates_per_sec_cavity{n}",
        "value": cups,
        "unit": "cells/s",
        "fused_predictor": fused_predictor,
        "dct_variant": case.step.cfg.poisson.dct_variant,  # the variant "auto" chose
        **_chunk_facts(chunk),
        "ms_per_step": (t_long - t_short) / (long - short) * 1e3,
        "t_short_s": t_short,
        "t_long_s": t_long,
        "steps": [short, long],
        "device": torch.cuda.get_device_name(case.state.u.device),
        "card": card_name_and_power_limit(),
    }


def _ring(fn, args_ring):
    """``fn`` over a ring of argument tuples, one per call in turn; the last
    ``len(args_ring)`` results stay alive, so the outputs rotate too."""
    outs = [None] * len(args_ring)
    calls = itertools.count()

    def call():
        j = next(calls) % len(args_ring)
        outs[j] = fn(*args_ring[j])

    return call


def _ring_len(device, bytes_per_call: int) -> int:
    """Enough buffer sets that a ring's traffic is twice the card's L2: each
    call then reads and writes device memory, as it does inside a step."""
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return max(1, math.ceil(2 * l2 / bytes_per_call))


def _field(rng, n, device, scale=1.0):
    return torch.tensor(rng.standard_normal((n, n)) * scale, dtype=torch.float32, device=device)


EMPTY_SOURCE = "empty_launch.cu"
_empty_launch = None


def empty_launch(stream: int) -> None:
    """One launch of a kernel of one thread that does nothing
    (``csrc/empty_launch.cu``, built at first use): the floor under any
    kernel's time. It is on no path of the solver."""
    global _empty_launch
    if _empty_launch is None:
        fn = ctypes.CDLL(str(build_library(EMPTY_SOURCE))).cfd_empty_launch
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        _empty_launch = fn
    rc = _empty_launch(stream)
    if rc != 0:
        raise RuntimeError(f"the empty launch failed: CUDA error {rc}")


def predictor_ms(n=1024, reps=200, device="cuda") -> dict:
    """Device and eager ms of one predictor call at n², the kernel against
    plain torch, in turns plain, kernel, kernel, plain; beside them the
    card's practical time for the same bytes, a plain ``copy_`` of two
    fields into two fields (``copy_device_ms``; not the same function), and
    the floor under any kernel, an empty launch (``empty_device_ms``). u
    and v rotate through a ring of buffers (:func:`_ring_len`), so no call
    finds its inputs in L2."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    h = 1.0 / (n - 1)
    dt = torch.tensor(1e-4, dtype=torch.float32, device=device)
    ring = _ring_len(device, 4 * 4 * n * n)  # u, v in; u*, v* out
    args = [(_field(rng, n, device, 0.1), _field(rng, n, device, 0.1), dt, 1e-3, h, h)
            for _ in range(ring)]
    fns = {"kernel": _ring(fused_predictor_central, args),
           "plain": _ring(fused_predictor_central_ref, args)}
    plan = pred.plan_predictor((n, n), pred.pointer_alignment(*args[0][:2]))
    out = {"n": n, "ring": ring, "route": plan.route}
    for which in ("plain", "kernel", "kernel", "plain"):
        out.setdefault(f"{which}_device_ms", []).append(device_ms(fns[which], reps))
        out.setdefault(f"{which}_eager_ms", []).append(eager_ms(fns[which], reps))
    dst = [(torch.empty_like(u), torch.empty_like(v)) for u, v, *_ in args]
    turn = itertools.count()

    def copy():
        j = next(turn) % ring
        dst[j][0].copy_(args[j][0])
        dst[j][1].copy_(args[j][1])

    out["copy_device_ms"] = [device_ms(copy, reps) for _ in range(2)]
    out["empty_device_ms"] = [
        device_ms(lambda: empty_launch(torch.cuda.current_stream(device).cuda_stream), reps)
        for _ in range(2)]
    return out


def dct_solve_ms(n=1024, reps=50, device="cuda") -> dict:
    """Device ms of one DCT solve at n² by every variant the autotuner times
    at that shape (the deep splits from 4096² on), in turns forward, then
    backward through the variants; the right-hand side rotates through a
    ring. ``winner`` is the variant with the least time."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    h = 1.0 / (n - 1)
    ring = _ring_len(device, 2 * 4 * n * n)  # rhs in, φ out
    args = [(_field(rng, n, device),) for _ in range(ring)]
    variants = _variants_for((n, n))
    fns = {var: _ring(NeumannDCT((n, n), h, h, var, device=device), args) for var in variants}
    out = {"n": n, "ring": ring}
    for var in (*variants, *reversed(variants)):
        out.setdefault(f"{var}_device_ms", []).append(device_ms(fns[var], reps))
    out["winner"] = min(variants, key=lambda v: min(out[f"{v}_device_ms"]))
    return out


def helmholtz_solve_ms(n=1024, reps=50, device="cuda") -> dict:
    """Device ms of one Dirichlet Helmholtz solve (two forward and two
    inverse 1-D DST-I passes over the (n−2)² interior, odd extension of
    length 2(n−1)) at n², twice, beside one DCT solve (rfft2) on the same
    ring of right-hand sides; ``coeff`` is a device scalar, as in the step."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    h = 1.0 / (n - 1)
    ring = _ring_len(device, 2 * 4 * n * n)  # b in, u out
    coeff = torch.tensor(0.5 * h * 1e-3, dtype=torch.float32, device=device)
    fields = [_field(rng, n, device) for _ in range(ring)]
    solver = DirichletHelmholtz((n, n), h, h, device=device)
    fns = {"helmholtz": _ring(solver, [(b, coeff) for b in fields]),
           "dct_rfft2": _ring(NeumannDCT((n, n), h, h, "rfft2", device=device),
                              [(b,) for b in fields])}
    out = {"n": n, "ring": ring, "dst_length": 2 * (n - 1)}
    for which in ("helmholtz", "dct_rfft2", "dct_rfft2", "helmholtz"):
        out.setdefault(f"{which}_device_ms", []).append(device_ms(fns[which], reps))
    return out


def new_paths(n=1024, compute_metrics=False, device="cuda") -> dict:
    """The cases of the implicit, LES and transport paths at full width:
    the n² implicit cavity (DST Helmholtz, DCT projection), the same with
    LES (so the damped Jacobi back end, 12 sweeps with the BCs inside
    each), the LES + SUPG + IBM reference-parity cylinder at 600×180
    through kernel A, and the n² transport cavity with the fused predictor."""
    return {
        f"cavity{n}_implicit_dst": lid_cavity(
            n=n, Re=1000.0, diffusion="implicit", cfl=0.6, poisson=POISSON,
            compute_metrics=compute_metrics, device=device),
        f"cavity{n}_les_implicit_jacobi": lid_cavity(
            n=n, Re=1000.0, diffusion="implicit", use_les=True, cfl=0.6, poisson=POISSON,
            compute_metrics=compute_metrics, device=device),
        "cylinder600x180_les_rbsor_pallas": cylinder(
            ref_parity=True, scheme="supg", use_les=True, poisson=CYLINDER_KERNEL_POISSON,
            compute_metrics=compute_metrics, device=device),
        f"transport{n}_fused": transport(
            n=n, Re=1000.0, Pe=1000.0, fused_predictor=True, poisson=POISSON,
            compute_metrics=compute_metrics, device=device),
    }


def mac_paths(n=1024, compute_metrics=False, device="cuda") -> dict:
    """The cells of the staggered tiers at full width: the n² MAC cavity at
    Re=1000 (chorin; incremental; implicit, Crank–Nicolson by the MAC
    Helmholtz transforms; ``mg:2``, through kernels A and B), the MAC
    cylinder at its default 720×240, the oscillating cylinder at 480×240
    (uniform and stretched), the (n/2)² stretched cavity and the 512×256
    stretched cylinder (fast diagonalization)."""
    mac = dict(n=n, Re=1000.0, compute_metrics=compute_metrics, device=device)
    rest = dict(compute_metrics=compute_metrics, device=device)
    return {
        f"cavity_mac{n}_chorin": lid_cavity_mac(poisson=MAC_POISSON, **mac),
        f"cavity_mac{n}_incremental": lid_cavity_mac(poisson=MAC_POISSON,
                                                     projection="incremental", **mac),
        f"cavity_mac{n}_implicit": lid_cavity_mac(poisson=MAC_POISSON, diffusion="implicit",
                                                  **mac),
        f"cavity_mac{n}_mg2": lid_cavity_mac(poisson="mg:2", **mac),
        "cylinder_mac720x240": build("cylinder_mac", **rest),
        "cylinder_oscillating480x240": build("cylinder_oscillating", **rest),
        "cylinder_oscillating480x240_stretched": build("cylinder_oscillating", stretched=True,
                                                       **rest),
        f"cavity_stretched{n // 2}": cavity_stretched(n=n // 2, Re=1000.0, beta=1.5, **rest),
        "cylinder_stretched512x256": build("cylinder_stretched", **rest),
        "cylinder_mac720x240_ghost": build("cylinder_mac", ibm_scheme="ghost", **rest),
        "cylinder_oscillating480x240_ghost": build("cylinder_oscillating", ibm_scheme="ghost",
                                                   **rest),
        "cylinder_oscillating480x240_stretched_ghost": build(
            "cylinder_oscillating", stretched=True, ibm_scheme="ghost", **rest),
    }


def boussinesq_paths(n=1024, device="cuda") -> dict:
    """The Boussinesq cells: the n² differentially heated cavity at Ra =
    1e4 with the exact DCT projection and with ``mg:2`` (kernel B on the
    fine level above 512², kernel A below). Its metrics (the Nusselt
    numbers) are always on, as in the JAX package."""
    return {f"heated_cavity{n}_dct": heated_cavity(n=n, Ra=1e4, device=device),
            f"heated_cavity{n}_mg2": heated_cavity(n=n, Ra=1e4, poisson="mg:2", device=device)}


def threed_paths(n=256, compute_metrics=False, device="cuda") -> dict:
    """The 3D cells at BASELINE.json config 5's size: the n³ collocated
    cavity with ``mg:2`` and the n³ MAC cavity with the exact ``rfftn`` DCT,
    Re = 400 (plain torch and cuFFT: the JAX package has no kernel here)."""
    return {f"cavity3d{n}_mg2": cavity3d(n=n, poisson="mg:2", compute_metrics=compute_metrics,
                                        device=device),
            f"cavity3d_mac{n}_dct": cavity3d_mac(n=n, compute_metrics=compute_metrics,
                                                 device=device)}


# the moving sphere's physics: cases.cylinder_oscillating's defaults (KC =
# 5, Re = 100, D = 1, T = 5) on the sphere cases' (16D, 8D, 8D) box
MOVING_SPHERE_GRID = (192, 96, 96)
MOVING_SPHERE_DOMAIN = (16.0, 8.0, 8.0)
MOVING_SPHERE_KC, MOVING_SPHERE_RE = 5.0, 100.0
MOVING_SPHERE_RADIUS, MOVING_SPHERE_PERIOD = 0.5, 5.0


def moving_sphere(compute_metrics=False, device="cuda") -> Case:
    """An in-line oscillating sphere in fluid at rest on the uniform 3D MAC
    grid, the 3D twin of ``cylinder_oscillating``: x_c(t) = x0 + A·sin(2πt/T),
    KC = 2πA/D, Re = U_max·D/ν, free-slip box, TVD, the exact DCT
    projection, ghost-cell forcing rebuilt on the device every stage (the
    JAX package builds it through ``mac3d.make_step(moving_body=...)``; it
    has no named case)."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import oscillating_sphere
    from cfdsim_tpu_torch.models import mac3d

    (nx, ny, nz), domain = MOVING_SPHERE_GRID, MOVING_SPHERE_DOMAIN
    radius, period = MOVING_SPHERE_RADIUS, MOVING_SPHERE_PERIOD
    D = 2 * radius
    A = MOVING_SPHERE_KC * D / (2 * np.pi)
    u_max = 2 * np.pi * A / period
    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1], z_max=domain[2],
                  centering="cell")
    center = tuple(0.5 * d for d in domain)
    body = oscillating_sphere(center, radius, A, period)
    cfg = mac3d.MAC3DConfig(grid=grid, nu=u_max * D / MOVING_SPHERE_RE, scheme="tvd",
                            cfl_target=0.4, dt_max=0.4 * grid.dx / u_max, dt_min=1e-6,
                            max_velocity=5.0 * u_max, compute_metrics=compute_metrics)
    step = mac3d.make_step(cfg, mac3d.free_slip_bcs3d(), moving_body=body,
                           moving_scheme="ghost", device=device)
    return Case("moving_sphere", cfg, step, mac3d.init_state(cfg, device=device), grid,
                {"body": body, "amplitude": A, "period": period, "u_max": u_max,
                 "center": center, "radius": radius,
                 "coeff_scale": 2.0 / (u_max**2 * np.pi * radius**2)})


def sphere_paths(compute_metrics=False, device="cuda") -> dict:
    """The 3D bodies at full width: ``sphere()`` at its default 192×96×96
    (TVD, exact DCT; the JAX bench's ``sphere3d`` cell),
    ``sphere_stretched`` with ghost stencils and dynamic LES at Re = 3900,
    ``heated_sphere_stretched`` with ghost stencils for momentum and θ, the
    128³ stretched cavity (FDM) and :func:`moving_sphere` (plain torch,
    cuFFT and cuBLAS: the JAX package has no kernel here)."""
    rest = dict(compute_metrics=compute_metrics, device=device)
    return {
        "sphere192x96x96": build("sphere", **rest),
        "sphere_stretched192x96x96_ghost_dynamic_les": build(
            "sphere_stretched", Re=3900.0, ibm_scheme="ghost", use_les=True,
            les_model="dynamic", perturb=0.02, **rest),
        "heated_sphere_stretched192x96x96_ghost": build(
            "heated_sphere_stretched", ibm_scheme="ghost", **rest),
        "cavity3d_stretched128": build("cavity3d_stretched", n=128, **rest),
        "moving_sphere192x96x96_ghost": moving_sphere(**rest),
    }


def compressible_paths(compute_metrics=False, device="cuda") -> dict:
    """The compressible cells at the reference's sizes: the 400×200 wedge
    (v1_shock.py:41-42) in its three modes (lab frame with the
    zero-momentum solid, first order as the reference; lab frame with the
    slip-wall ghost cells and the wedge-aligned frame, HLLC + MUSCL), the
    600×180 supersonic cavity with 2 ghost layers (BASELINE.md:13), pinned
    and with the real plate, and the 256³ blast (HLLC + MUSCL);
    plain torch: the JAX package has no kernel here."""
    rest = dict(compute_metrics=compute_metrics, device=device)
    muscl = dict(flux="hllc", reconstruction="muscl")
    return {
        "wedge400x200_zero_momentum": build("wedge", **rest),
        "wedge400x200_ghost_muscl": build("wedge", wall_treatment="ghost", **muscl, **rest),
        "wedge400x200_aligned_muscl": build("wedge", frame="wedge_aligned", **muscl, **rest),
        "cavity_supersonic600x180_pinned": build("cavity_supersonic", **rest),
        "cavity_supersonic600x180_real": build("cavity_supersonic", real_geometry=True, **rest),
        "blast3d256_hllc_muscl": build("blast3d", n=256, **rest),
    }


def spectral_paths(compute_metrics=False, device="cuda") -> dict:
    """The spectral cells: stable fluids at the reference's 640×360
    (BASELINE.md:20, dt = 0.01) with the semi-Lagrangian and the BFECC
    trace, and the pseudo-spectral step at 512² (its default) and 1024²
    (cuFFT and plain torch)."""
    rest = dict(compute_metrics=compute_metrics, device=device)
    return {
        "kolmogorov640x360_sl": build("kolmogorov", **rest),
        "kolmogorov640x360_bfecc": build("kolmogorov", advection="bfecc", **rest),
        "kolmogorov_ps512": build("kolmogorov_ps", ny=512, noise=0.1, **rest),
        "kolmogorov_ps1024": build("kolmogorov_ps", ny=1024, noise=0.1, **rest),
    }


def fem_paths(device="cuda") -> dict:
    """The FEM bench cells (``bench.py:164-182``): ``cylinder_fem(re=100,
    wake_refine=True)`` through the monolithic step (the reference-parity
    scheme) and the projection step (the production scheme)."""
    return {f"fem_cylinder_{scheme}": build("cylinder_fem", re=100.0, wake_refine=True,
                                            scheme=scheme, device=device)
            for scheme in ("monolithic", "projection")}


def run_fem(short=5, long=30, device="cuda"):
    """Steps/s of the two :func:`fem_paths` cells, marginal between a short
    and a long chunk from the initial state (the JAX bench's 5 and 30), with
    the triangles and, over the long chunk's runs, the matvecs,
    preconditioner applications and host reads per step (the Krylov exits
    are read on the host, so the chunk is the loop of step calls)."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    metrics = {"fem_cylinder_monolithic": "fem_cylinder_steps_per_sec",
               "fem_cylinder_projection": "fem_cylinder_projection_steps_per_sec"}
    for path, case in fem_paths(device).items():
        t_short, _, _ = _timed_chunk(case, case.state, short)
        before = dict(case.step.counts)
        t_long, state, chunk = _timed_chunk(case, case.state, long)
        steps = 4 * long  # the warm-up and three timed runs
        per_step = {f"{k}_per_step": (v - before.get(k, 0)) / steps
                    for k, v in case.step.counts.items()}
        if not all(bool(torch.isfinite(x).all()) for x in leaves(state)):
            raise RuntimeError(f"non-finite state after the long chunk of {path}")
        yield {"metric": metrics[path], "value": (long - short) / (t_long - t_short),
               "unit": "steps/s", "path": path, "n_tris": case.extras["mesh"].n_tris,
               "n_u": case.extras["ops"].n_u, "n_p": case.extras["ops"].n_p,
               "ms_per_step": (t_long - t_short) / (long - short) * 1e3, "steps": [short, long],
               "t_short_s": t_short, "t_long_s": t_long, **per_step, **_chunk_facts(chunk),
               "card": card}


def cells_per_sec(case, n_cells: int, short=100, long=600) -> dict:
    """Cells/s of ``case`` through the captured chunk, marginal between a
    short and a long chunk from the initial state (the JAX bench's
    ``_timed_chunk`` pair), with both wall times: a cost that slows only
    one of them moves the marginal."""
    t_short, _, _ = _timed_chunk(case, case.state, short)
    t_long, state, chunk = _timed_chunk(case, case.state, long)
    if not all(bool(torch.isfinite(x).all()) for x in leaves(state)):
        raise RuntimeError("non-finite state after the long chunk")
    return {"value": n_cells * (long - short) / (t_long - t_short), "unit": "cells/s",
            "ms_per_step": (t_long - t_short) / (long - short) * 1e3, "steps": [short, long],
            "t_short_s": t_short, "t_long_s": t_long, **_chunk_facts(chunk)}


def run_paths(n=1024, short=10, long=30, device="cuda", paths=None):
    """ms per step of each of ``paths`` (default :func:`new_paths`),
    marginal between a short and a long chunk from the initial state,
    through the captured chunk and through the eager loop, in turns chunk,
    loop, loop, chunk."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    for path, case in (paths or new_paths(n, device=device)).items():
        row = {"metric": "ms_per_step", "path": path, "steps": [short, long], "card": card}
        for route, name in ((None, "chunk"), ("loop", "eager"), ("loop", "eager"),
                            (None, "chunk")):
            t_short, _, _ = _timed_chunk(case, case.state, short, route)
            t_long, state, chunk = _timed_chunk(case, case.state, long, route)
            if not all(bool(torch.isfinite(x).all()) for x in leaves(state)):
                raise RuntimeError(f"non-finite state after the long chunk of {path}")
            row.setdefault(f"{name}_ms_per_step", []).append(
                (t_long - t_short) / (long - short) * 1e3)
            if route is None:
                row.update(_chunk_facts(chunk))
        yield row


def step_device_ms(n=1024, fused_predictor=True, reps=20, device="cuda") -> float:
    """Device ms of one main-path step (compute_metrics off) from rest."""
    case = _cavity(n, fused_predictor, _require_cuda(device))
    state = case.state
    cfl = torch.ones((), dtype=torch.float32, device=state.u.device)
    return device_ms(lambda: case.step(state, cfl), reps)


def run_sweep(device="cuda"):
    """One row per grid size from 256² to 4096² (a generator, so a caller
    can print each row as it lands)."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    for n in (256, 512, 1024, 2048, 4096):
        row = {"n": n, "card": card}
        pred = predictor_ms(n, reps=100, device=device)
        dct = dct_solve_ms(n, reps=20, device=device)
        row.update({k: v for k, v in pred.items() if k.endswith("_ms")})
        row.update({k: v for k, v in dct.items() if k.endswith("_ms")})
        row["ring"] = {"predictor": pred["ring"], "dct": dct["ring"]}
        for fused, tag in ((True, "F"), (False, "U")):
            row[f"step_device_ms_{tag}"] = step_device_ms(n, fused, reps=10, device=device)
        long = 600 if n <= 2048 else 300
        for fused, tag in ((True, "F"), (False, "U"), (False, "U"), (True, "F")):
            for route, name in ((None, "chunk"), ("loop", "eager")):
                r = run_bench(n=n, short=100, long=long, device=device, fused_predictor=fused,
                              route=route)
                row.setdefault(f"{name}_cells_per_s_{tag}", []).append(r["value"])
        row["steps"] = [100, long]
        torch.cuda.empty_cache()
        yield row


def profile_chunk(case, steps, device, card, route=None, **labels):
    """Device events and busy time per step of ``steps`` steps of ``case``
    under ``torch.profiler``, against the wall time of the same chunk run
    without the profiler; plus the ten ops with the most device time. The
    chunk is the captured program, or with ``route="loop"`` the eager loop."""
    from torch.profiler import ProfilerActivity, profile

    chunk = make_chunk(case.cfg, case.step, steps, route=route, keep_graph=True)
    state, _ = chunk(case.state, 1.0)  # warm-up: cuFFT plans, kernel build, the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the wall time without the profiler's cost
    chunk(state, 1.0)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chunk(state, 1.0)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    top = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                  if e.self_device_time_total > 0), reverse=True)[:10]
    return {
        **labels,
        **_chunk_facts(chunk),
        "steps": steps,
        "device_events_per_step": len(events) / steps,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "top_self_device_us": [[us, key, count] for us, key, count in top],
        "card": card,
    }


def run_profile(n=1024, steps=50, device="cuda"):
    """Per step, with compute_metrics off, each through the captured chunk
    and through the eager loop: the main path fused and unfused, then the
    reference-parity cylinder through kernel A (600×180), the n² cavity
    with ``poisson="mg:2"`` (kernels A and B), :func:`new_paths` (the
    implicit cavity, the LES cylinder, the transport cavity),
    :func:`mac_paths` (the staggered and stretched tiers, the ghost-IBM
    cylinders), :func:`boussinesq_paths`, and :func:`threed_paths` and
    :func:`sphere_paths` (10-step chunks), :func:`compressible_paths` and
    :func:`spectral_paths` (10-step chunks, the blast 5); then the
    :func:`fem_paths` (10 steps, on the loop: their steps read the host)."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    for route in (None, "loop"):
        for fused in (True, False):
            yield profile_chunk(_cavity(n, fused, device), steps, device, card, route,
                                path=f"cavity{n}_dct", n=n, fused_predictor=fused)
        yield profile_chunk(
            cylinder(ref_parity=True, scheme="supg", poisson=CYLINDER_KERNEL_POISSON,
                     compute_metrics=False, device=device),
            20, device, card, route, path="cylinder600x180_rbsor_pallas")
        yield profile_chunk(
            lid_cavity(n=n, Re=1000.0, poisson="mg:2", compute_metrics=False, device=device),
            steps, device, card, route, path=f"cavity{n}_mg2", n=n)
        for path, case in {**new_paths(n, device=device), **mac_paths(n, device=device),
                           **boussinesq_paths(n, device=device)}.items():
            yield profile_chunk(case, 20 if path.startswith("cylinder") else steps, device,
                                card, route, path=path)
        for path, case in {**threed_paths(device=device), **sphere_paths(device=device)}.items():
            yield profile_chunk(case, 10, device, card, route, path=path)
        torch.cuda.empty_cache()
        for path, case in {**compressible_paths(device=device),
                           **spectral_paths(device=device)}.items():
            yield profile_chunk(case, 5 if "3d" in path else 10, device, card, route,
                                path=path)
        torch.cuda.empty_cache()
    for path, case in fem_paths(device).items():  # the loop route only: they read the host
        yield profile_chunk(case, 10, device, card, path=path)


def _marginal(body, x, r1=20, r2=200):
    """Seconds per call of ``x = body(x)``, marginal between ``r1`` and
    ``r2`` calls from the same ``x`` (best of three each), each run ending in
    a synchronize: the per-run constant cancels, the host dispatch of every
    call stays in."""

    def run(reps):
        best = float("inf")
        for _ in range(3):
            y = x
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                y = body(y)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    run(r1)  # warm-up: kernel build, cuFFT plans
    return (run(r2) - run(r1)) / (r2 - r1)


def run_all(n=1024, device="cuda", steps=(10, 30), steps_3d=(3, 9)):
    """The secondary metrics at n² (the twin of ``bench.py::run_secondary``),
    one row each: marginal streaming rbsor sweeps/s, RB-SOR kernel sweeps/s
    (``rbsor_pallas``: the blocked kernel above 512²), multigrid V-cycles/s
    with kernel and with plain smoothing, and DCT solves/s; then the device
    ms of one Helmholtz (DST) solve beside the DCT solve's, the MAC and
    stretched cells/s, and ms per step of the implicit, LES and transport
    paths and the heated cavities (:func:`run_paths`, marginal between the
    two chunk lengths of ``steps``, 10 and 30 by default), the 3D cavities
    and the 3D bodies (``steps_3d``, 3 and 9); the sphere's cells/s at its
    default 192×96×96, marginal between 50 and 250 steps
    (``bench.py:151-162``); then ms per step of the compressible and
    spectral cells (:func:`compressible_paths`, :func:`spectral_paths`;
    the blast at ``steps_3d``); then the FEM cylinder's monolithic and
    projection steps/s (:func:`run_fem`, ``bench.py:164-182``)."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    h = 1.0 / (n - 1)
    rng = np.random.default_rng(0)
    rhs = _field(rng, n, device)
    rows = [
        ("poisson_rbsor_sweeps_per_sec", "sweeps/s", PoissonConfig(method="rbsor", iters=1)),
        ("poisson_rbsor_kernel_sweeps_per_sec", "sweeps/s",
         PoissonConfig(method="rbsor_pallas", iters=1)),
        ("poisson_mg_vcycles_per_sec", "vcycles/s", PoissonConfig(method="mg", iters=1)),
        ("poisson_mg_plain_smoothing_vcycles_per_sec", "vcycles/s",
         PoissonConfig(method="mg", iters=1, mg_pallas_smooth=False)),
        ("poisson_dct_solves_per_sec", "solves/s", PoissonConfig(method="dct")),
    ]
    for metric, unit, cfg in rows:
        solver = PoissonSolver((n, n), h, h, cfg, device=device)
        seconds = _marginal(lambda p, s=solver: s(p, rhs), torch.zeros_like(rhs))
        phi0 = torch.zeros_like(rhs)
        yield {"metric": f"{metric}_{n}", "value": 1.0 / seconds, "unit": unit,
               "seconds_per_call": seconds, "eager": True,
               # the same call replayed from a CUDA graph: no host dispatch
               "device_ms_per_call": device_ms(lambda s=solver: s(phi0, rhs), 10),
               "device": torch.cuda.get_device_name(device), "card": card}
    yield {"metric": f"helmholtz_solve_device_ms_{n}", **helmholtz_solve_ms(n, device=device),
           "card": card}
    # the solver tiers' rates (bench.py:130-149): the staggered tier and the
    # stretched tier, through the captured chunk
    case = lid_cavity_mac(n=n, Re=1000.0, poisson=MAC_POISSON, compute_metrics=False,
                          device=device)
    yield {"metric": f"cell_updates_per_sec_cavity_mac{n}", **cells_per_sec(case, n * n),
           "dct_variant": case.step.cfg.poisson.dct_variant, "card": card}
    ns = n // 2
    case = cavity_stretched(n=ns, Re=1000.0, beta=1.5, compute_metrics=False, device=device)
    yield {"metric": f"cell_updates_per_sec_cavity_stretched{ns}",
           **cells_per_sec(case, ns * ns), "card": card}
    short, long = steps
    short_3d, long_3d = steps_3d
    yield from run_paths(n, short, long, device=device)
    yield from run_paths(n, short, long, device=device, paths=boussinesq_paths(n, device=device))
    yield from run_paths(n, short_3d, long_3d, device=device, paths=threed_paths(device=device))
    case = build("sphere", compute_metrics=False, device=device)
    yield {"metric": "cell_updates_per_sec_sphere3d",
           **cells_per_sec(case, case.grid.n_cells, short=50, long=250), "card": card}
    yield from run_paths(n, short_3d, long_3d, device=device, paths=sphere_paths(device=device))
    paths = compressible_paths(device=device)
    blast = {k: paths.pop(k) for k in list(paths) if k.startswith("blast3d")}
    yield from run_paths(n, short, long, device=device,
                         paths={**paths, **spectral_paths(device=device)})
    yield from run_paths(n, short_3d, long_3d, device=device, paths=blast)
    yield from run_fem(device=device)


def run_roofline(n=1024, device="cuda"):
    """Roofline rows per tier, the twin of ``bench.py::run_roofline``: the
    card's measured peaks, then for the n² collocated cavity ("auto"
    DCT, fused predictor from 2048² on, as there), the n² MAC cavity and
    the (n/2)² stretched cavity the flops and bytes per cell of one eager
    step (``utils/roofline.py``: pre-fusion counts per aten op), the
    bound, the ceilings and the measured cells/s through the captured
    chunk; then the sphere at its default 192×96×96 (``sphere3d``, rates
    marginal between 50 and 250 steps, as ``bench.py:218-220``)."""
    from cfdsim_tpu_torch.utils.roofline import measure_peaks, roofline

    device = _require_cuda(device)
    card = card_name_and_power_limit()
    peaks = measure_peaks(device)
    yield {"metric": "machine_peaks", "peak_flops": peaks["peak_flops"],
           "peak_bw_bytes_per_sec": peaks["peak_bw"], "card": card}
    ns = n // 2
    sphere = build("sphere", compute_metrics=False, device=device)
    tiers = {
        f"collocated{n}": (lid_cavity(n=n, Re=1000.0, poisson=POISSON, compute_metrics=False,
                                      fused_predictor=n >= 2048, device=device), n * n),
        f"mac{n}": (lid_cavity_mac(n=n, Re=1000.0, poisson=MAC_POISSON, compute_metrics=False,
                                   device=device), n * n),
        f"stretched{ns}": (cavity_stretched(n=ns, Re=1000.0, beta=1.5, compute_metrics=False,
                                            device=device), ns * ns),
        "sphere3d": (sphere, sphere.grid.n_cells),
    }
    for name, (case, n_cells) in tiers.items():
        chunks = (50, 250) if name == "sphere3d" else (100, 600)
        timed = cells_per_sec(case, n_cells, *chunks)
        cfl = torch.ones((), dtype=torch.float32, device=device)
        row = roofline(case.step, case.state, n_cells, timed["value"], peaks, cfl)
        yield {"metric": f"roofline_{name}", **row, "t_short_s": timed["t_short_s"],
               "t_long_s": timed["t_long_s"], "card": card}


def run_cylinder(nx=600, ny=180, short=10, long=40, device="cuda"):
    """Steps/s of the reference-parity cylinder (``ref_parity=True,
    scheme="supg"``) at nx×ny, marginal between a short and a long chunk
    from the initial state, with the pressure solve through kernel A
    (``rbsor_pallas``), as the captured chunk and as the eager loop, and
    through streaming ``rbsor`` (the case's default; it reads its residual
    on the host, so its chunk is the loop), in turns chunk, loop, streaming,
    streaming, loop, chunk. Each kernel row also gives the early-exit
    chunks run per step (counted on the device)."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    kernel, streaming = ("rbsor_pallas", CYLINDER_KERNEL_POISSON), ("rbsor", None)
    turns = ((*kernel, None), (*kernel, "loop"), (*streaming, None), (*streaming, None),
             (*kernel, "loop"), (*kernel, None))
    for method, pois, route in turns:
        case = cylinder(nx=nx, ny=ny, ref_parity=True, scheme="supg", poisson=pois,
                        compute_metrics=False, device=device)
        # the streaming solve reads its residual on the host per 50 sweeps:
        # ~100× slower, so it gets shorter chunks
        n1, n2 = (short, long) if method == "rbsor_pallas" else (1, 3)
        t_short, _, _ = _timed_chunk(case, case.state, n1, route)
        chunks = case.step.poisson.chunks_run
        chunks.zero_()
        t_long, state, chunk = _timed_chunk(case, case.state, n2, route)
        if not bool(torch.isfinite(state.u).all()):
            raise RuntimeError("non-finite state after the long chunk")
        row = {"metric": f"cylinder_ref_parity_steps_per_sec_{nx}x{ny}", "poisson": method,
               "value": (n2 - n1) / (t_long - t_short), "unit": "steps/s",
               **_chunk_facts(chunk),
               "t_short_s": t_short, "t_long_s": t_long, "steps": [n1, n2],
               "device": torch.cuda.get_device_name(device), "card": card}
        if method == "rbsor_pallas":  # the long chunk ran 4 times (warm-up + best of 3)
            row["kernel_chunks_per_step"] = int(chunks) / (4 * n2)
            # one step replayed from a CUDA graph
            cfl = torch.ones((), dtype=torch.float32, device=device)
            row["step_device_ms"] = device_ms(lambda c=case, s=state: c.step(s, cfl), 5)
        yield row


def rbsor_ms(shape=(180, 600), sweeps=50, reps=20, masked=True, plan=None,
             device="cuda") -> dict:
    """Device ms of one kernel-A call of ``sweeps`` sweeps at ``shape``
    (the cylinder's 50-sweep masked chunk by default), against its plain
    version, in turns plain, kernel, kernel, plain, with the route
    :func:`poisson_rb.plan_rbsor` takes for the call, or ``plan`` where one
    is given (to
    set two routes side by side at one size). ``masked`` uses the cylinder
    case's solid mask on its domain at this resolution. The inputs stay the
    same between calls: in the cylinder's solve φ and rhs (0.86 MB) are in
    L2 as well."""
    device = _require_cuda(device)
    ny, nx = shape
    rng = np.random.default_rng(0)
    rhs = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)
    phi = torch.zeros_like(rhs)
    grid = Grid(nx=nx, ny=ny, x_max=20.0, y_max=4.0)  # the cylinder case's domain
    solid = np.zeros(shape, dtype=bool)
    if masked:
        solid, _ = cylinder_masks(grid, (4.0, 2.0), 0.5)
    mask = torch.as_tensor(solid, dtype=torch.float32, device=device) if masked else None
    args = (phi, rhs, grid.dx, grid.dy, sweeps, 1.7, "neumann", mask)
    fns = {"kernel": lambda: poisson_rb.rbsor(*args), "plain": lambda: poisson_rb.rbsor_ref(*args)}
    if plan is None:
        plan = poisson_rb.plan_rbsor(shape, poisson_rb.max_cluster(device), sweeps=sweeps,
                                     sms=poisson_rb.card_sms(device))
    else:
        work = torch.empty_like(phi)

        def forced():
            work.copy_(phi)
            poisson_rb.solve_a(work, rhs, mask, plan, grid.dx, grid.dy, sweeps, 1.7)

        fns["kernel"] = forced
    out = {"shape": list(shape), "sweeps": sweeps, "masked": masked,
           "route": plan.route, "cluster": plan.cluster, "tiles": plan.tiles,
           "fluid_cells": int(ny * nx - int(solid.sum()))}
    for which in ("plain", "kernel", "kernel", "plain"):
        n = reps if which == "kernel" else max(1, reps // 10)
        out.setdefault(f"{which}_device_ms", []).append(device_ms(fns[which], n))
    return out


ROUTE_SHAPES = ((64, 64), (128, 128), (256, 256), (512, 512), (180, 600), (240, 720),
                (360, 1200))
ROUTE_SWEEPS = (1, 2, 4, 8, 16, 32, 64, 1500)
CYLINDER_ROUTE_SHAPES = ((180, 600), (240, 720), (360, 1200))  # masked: the cylinder's solid
# early exits checked every few sweeps: 400 sweeps in chunks of each of
# these at tol 1e-8 (never reached), on the cylinders' grids
ROUTE_CHECKS = (1, 2, 4, 8, 16)
CHECKED_SWEEPS = 400
CHECKED_ROUTE_SHAPES = ((180, 600), (240, 720))


def run_routes(shapes=ROUTE_SHAPES, sweeps=ROUTE_SWEEPS, reps=10, device="cuda"):
    """Kernel A's routes side by side, one row per shape and sweep count:
    the device ms of one call of ``sweeps`` Neumann sweeps on the cluster
    the size plan gives the shape (where it fits one), on the cooperative
    kernel and on the tiled route (where the card holds its tiles), in
    turns cluster, cooperative, tiled, tiled, cooperative, cluster (the
    cylinder's grids with its solid mask). A 1500-sweep call is the
    cylinder's solve: 30 chunks of 50 with the early exit at tol 1e-8,
    which float32 never reaches. Then, on :data:`CHECKED_ROUTE_SHAPES`,
    :data:`CHECKED_SWEEPS` sweeps with that early exit checked every
    :data:`ROUTE_CHECKS` sweeps (the row's ``check_every``). Each call
    first copies φ0 into a work buffer, as :func:`poisson_rb.rbsor` clones
    it. These rows set :data:`poisson_rb.CLUSTER_MIN_SWEEPS` and
    :data:`poisson_rb.TILED_MIN_CELLS`, and show that the tiled route's
    rule may read the solve's sweeps, not a chunk's."""
    device = _require_cuda(device)
    card = card_name_and_power_limit()
    most = poisson_rb.max_cluster(device)
    sms = poisson_rb.card_sms(device)
    count = torch.zeros((), dtype=torch.int32, device=device)
    for shape in shapes:
        ny, nx = shape
        grid = Grid(nx=nx, ny=ny, x_max=20.0, y_max=4.0)
        mask = None
        if shape in CYLINDER_ROUTE_SHAPES:
            solid, _ = cylinder_masks(grid, (4.0, 2.0), 0.5)
            mask = torch.as_tensor(solid, dtype=torch.float32, device=device)
        rhs = torch.tensor(np.random.default_rng(0).standard_normal(shape), dtype=torch.float32,
                           device=device)
        phi0, work = torch.zeros_like(rhs), torch.empty_like(rhs)
        plans = {"cluster": poisson_rb.plan_rbsor(shape, most),  # by size alone
                 "cooperative": poisson_rb.RbsorPlan("cooperative"),
                 "tiled": poisson_rb.tile_plan(shape, sms)}
        plans = {k: p for k, p in plans.items() if p is not None and p.route == k}
        solves = [(n, 1e-8, 50) if n == 1500 else (n, 0.0, 8) for n in sweeps]
        if shape in CHECKED_ROUTE_SHAPES:
            solves += [(CHECKED_SWEEPS, 1e-8, c) for c in ROUTE_CHECKS]
        for n, tol, check in solves:

            def call(plan, n=n, tol=tol, check=check):
                work.copy_(phi0)
                poisson_rb.solve_a(work, rhs, mask, plan, grid.dx, grid.dy, n, 1.7, "neumann",
                                   tol, check, count)

            row = {"shape": list(shape), "masked": mask is not None, "sweeps": n,
                   "check_every": check if tol > 0.0 else 0,
                   "cluster": plans["cluster"].cluster if "cluster" in plans else 0,
                   "tiles": plans["tiled"].tiles if "tiled" in plans else 0,
                   "routed": poisson_rb.plan_rbsor(shape, most, sweeps=n, sms=sms).route,
                   "card": card}
            order = list(plans) + list(reversed(plans))
            for route in order:
                row.setdefault(f"{route}_device_ms", []).append(
                    device_ms(lambda p=plans[route]: call(p), reps if n < 400 else 2))
            yield row


def rbsor_sync_us(cluster: int, reps=10, device="cuda") -> float:
    """Device µs that kernel A's cluster route spends per half-sweep on its
    synchronisation (one CTA barrier, and across CTAs the halo exchange
    through distributed shared memory): the marginal time per half-sweep
    between 50 and 250 sweeps of a (4·cluster, 64) grid on ``cluster`` CTAs,
    one row per thread, where the sweeps themselves are a few instructions."""
    device = _require_cuda(device)
    shape = (4 * cluster, 64)
    plan = poisson_rb.RbsorPlan(
        "cluster", cluster, *poisson_rb.band_plan(shape, cluster, poisson_rb.SMEM_LIMIT))
    phi = torch.zeros(shape, device=device)
    rhs = torch.randn(shape, device=device)
    t = {n: device_ms(lambda n=n: poisson_rb.solve_a(phi, rhs, None, plan, 0.1, 0.1, n, 1.0),
                      reps)
         for n in (50, 250)}
    return (t[250] - t[50]) / (2 * 200) * 1e3


def rbsor_blocked_ms(shape=(1024, 1024), sweeps=2, reps=50, device="cuda") -> dict:
    """Device ms of one kernel-B call of ``sweeps`` Neumann sweeps at
    ``shape`` (2 is the multigrid fine level's smoothing call), against its
    plain version, in turns plain, kernel, kernel, plain, with the load
    route :func:`poisson_rb.plan_blocked` takes; φ and rhs rotate through a
    ring of buffers twice the L2 (:func:`_ring_len`)."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    ny, nx = shape
    h = 1.0 / (nx - 1)
    ring = _ring_len(device, 3 * 4 * ny * nx)  # φ, rhs in; φ out

    def field():
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    args = [(field(), field(), h, h, sweeps, 1.0) for _ in range(ring)]
    fns = {"kernel": _ring(poisson_rb.rbsor_blocked, args),
           "plain": _ring(poisson_rb.rbsor_blocked_ref, args)}
    plan = poisson_rb.plan_blocked(shape, sweeps)
    out = {"shape": list(shape), "sweeps": sweeps, "ring": ring, "route": plan.route,
           "tile": [plan.tile_rows, plan.tile_cols]}
    for which in ("plain", "kernel", "kernel", "plain"):
        n_reps = reps if which == "kernel" else max(1, reps // 10)
        out.setdefault(f"{which}_device_ms", []).append(device_ms(fns[which], n_reps))
    return out
