"""Benchmarks of the port on one CUDA card.

The headline number is cell-updates/sec on the 1024² lid-driven cavity,
Re=1000 (the step ``bench.py::run_bench`` of the JAX package times). The
full step runs: adaptive CFL dt, central convection and diffusion (the
fused predictor kernel when ``fused_predictor``), BCs, the exact DCT
pressure projection. Throughput is measured marginally between a short and
a long chunk of steps from the same initial state, so the per-chunk
constant (first-launch and synchronisation cost) cancels. Each chunk ends
in ``torch.cuda.synchronize()``.

``--sweep`` adds, per grid size, the device times of the predictor (kernel
and plain torch), of one DCT solve (rfft and rfft2) and of one step (fused
and unfused), next to the eager cells/s. ``--profile`` counts the device
events of a chunk of steps under ``torch.profiler`` and sets the device's
busy time against the wall time. Every function here refuses to run without
a CUDA device: a CPU number is not a device metric.

    python -m cfdsim_tpu_torch bench [--n 1024]
    python -m cfdsim_tpu_torch bench --sweep
    python -m cfdsim_tpu_torch bench --profile [--n 1024]
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from cfdsim_tpu_torch.cases import lid_cavity
from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.ops.kernels.predictor import (
    fused_predictor_central,
    fused_predictor_central_ref,
)
from cfdsim_tpu_torch.solvers.poisson import NeumannDCT, PoissonConfig
from cfdsim_tpu_torch.utils.profiling import card_name_and_power_limit, device_ms, eager_ms

# the JAX package's autotuner is not ported: the bench names its variant
POISSON = PoissonConfig(method="dct", dct_variant="rfft2")


def _require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the benchmark measures a CUDA device; got {device}")
    return device


def _cavity(n, fused_predictor, device):
    return lid_cavity(n=n, Re=1000.0, poisson=POISSON, compute_metrics=False,
                      fused_predictor=fused_predictor, device=device)


def _timed_chunk(case, state, n_steps: int):
    """(best seconds of 3 runs, final state) for ``n_steps`` steps from ``state``."""
    chunk = make_chunk(case.cfg, case.step, n_steps)
    cfl = torch.ones((), dtype=torch.float32, device=state.u.device)
    out, _ = chunk(state, cfl)  # warm-up: cuFFT plans, kernel build and load
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = chunk(state, cfl)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def run_bench(n=1024, short=100, long=600, device="cuda", fused_predictor=True):
    case = _cavity(n, fused_predictor, _require_cuda(device))
    t_short, _ = _timed_chunk(case, case.state, short)
    t_long, state_l = _timed_chunk(case, case.state, long)

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
        "dct_variant": POISSON.dct_variant,
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


def predictor_ms(n=1024, reps=200, device="cuda") -> dict:
    """Device and eager ms of one predictor call at n², the kernel against
    plain torch, in turns plain, kernel, kernel, plain. u and v rotate
    through a ring of buffers (:func:`_ring_len`), so no call finds its
    inputs in L2."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    h = 1.0 / (n - 1)
    dt = torch.tensor(1e-4, dtype=torch.float32, device=device)
    ring = _ring_len(device, 4 * 4 * n * n)  # u, v in; u*, v* out
    args = [(_field(rng, n, device, 0.1), _field(rng, n, device, 0.1), dt, 1e-3, h, h)
            for _ in range(ring)]
    fns = {"kernel": _ring(fused_predictor_central, args),
           "plain": _ring(fused_predictor_central_ref, args)}
    out = {"n": n, "ring": ring}
    for which in ("plain", "kernel", "kernel", "plain"):
        out.setdefault(f"{which}_device_ms", []).append(device_ms(fns[which], reps))
        out.setdefault(f"{which}_eager_ms", []).append(eager_ms(fns[which], reps))
    return out


def dct_solve_ms(n=1024, reps=50, device="cuda") -> dict:
    """Device ms of one DCT solve at n², rfft against rfft2, in turns
    rfft, rfft2, rfft2, rfft; the right-hand side rotates through a ring."""
    device = _require_cuda(device)
    rng = np.random.default_rng(0)
    h = 1.0 / (n - 1)
    ring = _ring_len(device, 2 * 4 * n * n)  # rhs in, φ out
    args = [(_field(rng, n, device),) for _ in range(ring)]
    fns = {var: _ring(NeumannDCT((n, n), h, h, var, device=device), args)
           for var in ("rfft", "rfft2")}
    out = {"n": n, "ring": ring}
    for var in ("rfft", "rfft2", "rfft2", "rfft"):
        out.setdefault(f"{var}_device_ms", []).append(device_ms(fns[var], reps))
    return out


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
            r = run_bench(n=n, short=100, long=long, device=device, fused_predictor=fused)
            row.setdefault(f"eager_cells_per_s_{tag}", []).append(r["value"])
        row["eager_steps"] = [100, long]
        torch.cuda.empty_cache()
        yield row


def run_profile(n=1024, steps=50, device="cuda"):
    """Per step of the main path (compute_metrics off), fused and unfused:
    device events and device busy time under ``torch.profiler``, against
    the wall time of the same chunk run without the profiler; plus the ten
    ops with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    device = _require_cuda(device)
    card = card_name_and_power_limit()
    for fused in (True, False):
        case = _cavity(n, fused, device)
        chunk = make_chunk(case.cfg, case.step, steps)
        cfl = torch.ones((), dtype=torch.float32, device=device)
        state, _ = chunk(case.state, cfl)  # warm-up: cuFFT plans, kernel build
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the wall time without the profiler's cost
        chunk(state, cfl)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chunk(state, cfl)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in events)
        top = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                      if e.self_device_time_total > 0), reverse=True)[:10]
        yield {
            "n": n,
            "fused_predictor": fused,
            "steps": steps,
            "device_events_per_step": len(events) / steps,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "wall_ms_per_step": wall_us / steps / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "top_self_device_us": [[us, key, count] for us, key, count in top],
            "card": card,
        }
