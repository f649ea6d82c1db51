"""First-build autotuned choice of the exact Neumann DCT solve
(``cfdsim_tpu.solvers.autotune``).

Every DCT variant solves the same problem exactly (the same mean-free
convention); which is fastest depends on the device and the shape. So
``dct_variant="auto"`` times the variants on the device once per (device,
shape), keeps the winner in process and on disk, and builds that one. The
cache file is ``build/cfdsim_tpu_torch/autotune.json`` at the repository
root (``CFDSIM_AUTOTUNE_CACHE`` names another directory);
``CFDSIM_DCT_VARIANT`` forces a variant.

Timing: on a CUDA device each variant's ``reps`` solves, on a ring of
right-hand sides larger than the card's L2, are one captured CUDA graph
(as a step's chunk runs them), replayed between two CUDA events; the
variants are interleaved turn by turn, and a variant's time is the median
of its turns. On the CPU the same solves run eagerly, timed with
``time.perf_counter``. Nothing is timed
inside a CUDA graph capture: there a cache miss raises, so a step resolves
"auto" when it is built (:func:`resolve_poisson_config`), before any
capture.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from cfdsim_tpu_torch.utils.profiling import AUTOTUNE, RECORDER

_MEM: dict[str, str] = {}
_VARIANTS = ("rfft", "rfft2", "rfft_split", "packed", "matmul")
# the deeper radix-2 peels (internal FFT length n/4, n/8) are candidates
# from 4096 on
_DEEP_VARIANTS = ("rfft_split4", "rfft_split8")
DEFAULT_CACHE = Path(__file__).resolve().parents[2] / "build" / "cfdsim_tpu_torch"


def _variants_for(shape) -> tuple[str, ...]:
    if min(shape) >= 4096:
        return _VARIANTS + _DEEP_VARIANTS
    return _VARIANTS


def _cache_path() -> Path:
    base = os.environ.get("CFDSIM_AUTOTUNE_CACHE")
    return (Path(base) if base else DEFAULT_CACHE) / "autotune.json"


def _load_disk() -> dict:
    try:
        return json.loads(_cache_path().read_text())
    except (OSError, ValueError):
        return {}


def _store_disk(key: str, value: str, timings: dict) -> None:
    path = _cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        data = _load_disk()
        data[key] = {"variant": value, "ms": timings}
        path.write_text(json.dumps(data, indent=1, sort_keys=True))
    except OSError:
        pass  # a read-only tree: the in-process cache still applies


def _device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _key(shape, device) -> str:
    return f"{_device_name(device)}|dct2d|{shape[0]}x{shape[1]}"


def matmul_dct_solver(m: int, n: int, dx: float, dy: float, *, device):
    """The uniform-spacing fast-diagonalization solver: the clamped-edge
    operator in the analytic DCT-II eigenbasis as four dense matmuls (the
    uniform case of ``solvers/fdm.py::make_fdm_solver``; the same mean-free
    convention as the FFT variants)."""
    from cfdsim_tpu_torch.solvers.fdm import make_fdm_solver, uniform_neumann_eigs

    return make_fdm_solver(np.full(n, dx), np.full(m, dy),
                           eigs=(uniform_neumann_eigs(n, dx), uniform_neumann_eigs(m, dy)),
                           device=device)


def _ring_length(device, shape) -> int:
    """Right-hand sides enough that a turn streams twice the card's L2."""
    if torch.device(device).type != "cuda":
        return 1
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    return max(1, math.ceil(2 * l2 / (8 * shape[0] * shape[1])))  # rhs in, φ out


def measure_dct_variants(shape, dx: float, dy: float, *, device, turns: int = 5,
                         reps: int = 10) -> dict:
    """Milliseconds per solve of every exact variant the shape admits, on
    ``device``: the median over ``turns`` timings of ``reps`` solves. On a
    card the ``reps`` solves of a variant are one captured CUDA graph,
    replayed between two CUDA events, which is how a step's chunk runs them
    (timed eagerly, a variant of many small kernels would be charged its
    host dispatch); on the CPU they are eager calls timed with
    ``perf_counter``. The variants are timed one after the other, each
    program released before the next is captured, which keeps one
    program's memory pool alive at a time. (Several live programs replay
    correctly: the crash once met here was a cuFFT plan destroyed under a
    live graph, which ``utils/graphs.py::CapturedProgram`` now prevents.)
    Recorded as a ``cfd.autotune`` span (``utils/profiling.py``)."""
    from cfdsim_tpu_torch.solvers.poisson import NeumannDCT
    from cfdsim_tpu_torch.utils.graphs import CapturedProgram

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("measure_dct_variants cannot time inside a CUDA graph capture")
    with RECORDER.span(AUTOTUNE):
        rng = np.random.default_rng(0)
        ring = []
        for _ in range(_ring_length(device, shape)):
            r = rng.standard_normal(shape).astype(np.float32)
            ring.append(torch.tensor(r - r.mean(), device=device))
        times = {}
        for v in _variants_for(shape):
            try:
                solver = NeumannDCT(shape, dx, dy, v, device=device)
            except ValueError:  # the shape's sides do not divide as the variant needs
                continue

            def run(solver=solver):
                for i in range(reps):
                    solver(ring[i % len(ring)])

            program = CapturedProgram(run) if cuda else None
            run = program.replay if cuda else run
            run()  # warm-up: cuFFT plans, the allocator, the graph's upload
            times[v] = []
            for _ in range(turns):
                if cuda:
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    run()
                    stop.record()
                    stop.synchronize()
                    times[v].append(start.elapsed_time(stop) / reps)
                else:
                    t0 = time.perf_counter()
                    run()
                    times[v].append((time.perf_counter() - t0) * 1e3 / reps)
            del run, program, solver
        return {v: statistics.median(t) for v, t in times.items()}


def cached_dct_variant(shape, *, device) -> str | None:
    """The forced (``CFDSIM_DCT_VARIANT``), in-process or on-disk winner for
    (device, shape), in that order; None on a miss. Never times anything."""
    from cfdsim_tpu_torch.solvers.poisson import DCT_VARIANTS

    forced = os.environ.get("CFDSIM_DCT_VARIANT")
    if forced:
        return forced
    key = _key(shape, device)
    if key in _MEM:
        return _MEM[key]
    disk = _load_disk().get(key)
    if isinstance(disk, dict) and disk.get("variant") in DCT_VARIANTS[:-1]:
        _MEM[key] = disk["variant"]
        return _MEM[key]
    return None


def best_dct_variant(shape, dx: float, dy: float, *, device) -> str:
    """The fastest exact DCT variant for (device, shape): cached in process
    and on disk, measured once on a miss. Under a CUDA graph capture a miss
    raises: timing there would record the candidates into the graph."""
    shape = tuple(shape)
    hit = cached_dct_variant(shape, device=device)
    if hit:
        return hit
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"dct_variant='auto' for {shape} on {_device_name(device)} is not cached and "
            "cannot be measured inside a CUDA graph capture: resolve it when the step is "
            "built (resolve_poisson_config)")
    timings = measure_dct_variants(shape, dx, dy, device=device)
    winner = min(timings, key=timings.get)
    _MEM[_key(shape, device)] = winner
    _store_disk(_key(shape, device), winner, timings)
    return winner


def resolve_poisson_config(pois, shape, dx: float, dy: float, *, device):
    """``pois`` with ``dct_variant="auto"`` pinned to the measured winner,
    at step build time (before any capture); ``pois`` itself when there is
    nothing to resolve."""
    if pois is not None and pois.method == "dct" and pois.dct_variant == "auto":
        return dataclasses.replace(
            pois, dct_variant=best_dct_variant(shape, dx, dy, device=device))
    return pois
