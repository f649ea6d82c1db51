"""Smoke test of the PyTorch port on one CUDA card (run from the repo root):

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the exit code is non-zero
and the final ``{"ok": true, ...}`` line is not printed:

1. card: name and power limit (nvidia-smi); CUDA must be available
2. build: compile the hand-written kernels with nvcc (sm_90a)
3. kernel vs plain: the fused predictor against its plain torch version
   at (48, 64), (1024, 1024), (1000, 1030), (37, 129); max |Δ| ≤ 1e-6 and
   the boundary frame bit-equal to the input
4. golden: the 48² Re=100 cavity, 300 steps + one metrics step, fused
   predictor off and on, against tests/goldens.json (RTOL 2e-5)
5. main path: the 1024² Re=1000 cavity through runner.Simulation, 600
   steps in chunks of 100, health check on; finite, max |u| ≤ 1.5, kernel
   launches = steps; then 5 fused vs 5 unfused steps (atol 1e-5)
6. timings, each beside the card's name and power limit: marginal
   cells/s of the main path fused and unfused (eager, host dispatch
   included) and the device time of one step; the predictor kernel vs
   plain torch at 1024²; one DCT solve at 1024² with rfft and rfft2
   (``cfdsim_tpu_torch/bench.py``). "Device" times replay the calls from a
   CUDA graph, so they exclude the host's dispatch; "eager" times include
   it. The predictor's and the solve's inputs rotate through buffers twice
   the card's L2, so those calls stream from device memory as in a step

It imports nothing of JAX: the machine with the card need not have it.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cfdsim_tpu_torch.bench import dct_solve_ms, predictor_ms, run_bench, step_device_ms
from cfdsim_tpu_torch.cases import build, lid_cavity
from cfdsim_tpu_torch.ops.kernels import predictor as pred
from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig
from cfdsim_tpu_torch.utils.profiling import card_name_and_power_limit

ROOT = Path(__file__).resolve().parent
KERNEL_ATOL = 1e-6  # tests/test_pallas.py:127-128; see csrc/predictor.cu on FMA
STEP_ATOL = 1e-5  # tests/test_pallas.py:144-145
GOLDEN_RTOL = 2e-5  # tests/test_goldens.py:28
PREDICTOR_SHAPES = [(48, 64), (1024, 1024), (1000, 1030), (37, 129)]


def say(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def phase_kernel_vs_plain():
    worst = 0.0
    for ny, nx in PREDICTOR_SHAPES:
        rng = np.random.default_rng(ny * 10007 + nx)
        u = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float32, device="cuda")
        v = torch.tensor(rng.standard_normal((ny, nx)), dtype=torch.float32, device="cuda")
        dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
        nu, dx, dy = 0.01, 0.02, 0.03
        us, vs = pred.fused_predictor_central(u, v, dt, nu, dx, dy)
        ur, vr = pred.fused_predictor_central_ref(u, v, dt, nu, dx, dy)
        torch.cuda.synchronize()
        err = max(float((us - ur).abs().max()), float((vs - vr).abs().max()))
        frame = torch.ones_like(u, dtype=torch.bool)
        frame[1:-1, 1:-1] = False
        frame_equal = bool(torch.equal(us[frame], u[frame]) and torch.equal(vs[frame], v[frame]))
        say("kernel_vs_plain", shape=[ny, nx], max_abs_err=err, atol=KERNEL_ATOL,
            frame_bit_equal=frame_equal)
        if not (err <= KERNEL_ATOL and frame_equal):
            raise AssertionError(f"fused predictor disagrees at {(ny, nx)}: {err}, frame {frame_equal}")
        worst = max(worst, err)
    return worst


def golden_signature(case, steps: int) -> dict:
    """Field L2/max checksums after ``steps`` steps and the metrics of one
    more step (the signature of tests/test_goldens.py)."""
    s = case.state
    cfl = torch.ones((), dtype=torch.float32, device="cuda")
    for _ in range(steps):
        s, _ = case.step(s, cfl)
    _, m = case.step(s, cfl)
    sig = {}
    for name in ("u", "v", "p"):
        f = getattr(s, name)
        sig[f"l2_{name}"] = float(torch.sqrt(torch.mean(f * f)))
        sig[f"max_{name}"] = float(f.abs().max())
    for name in ("energy", "max_vel", "fx", "fy", "vort_max"):
        sig[name] = float(getattr(m, name))
    return sig


def phase_golden():
    ref = json.loads((ROOT / "tests" / "goldens.json").read_text())["cavity_collocated_48"]
    scale = max(abs(v) for v in ref.values())
    atol = 1e-6 * scale  # the noise floor of tests/test_goldens.py:119-124
    for fused in (False, True):
        sig = golden_signature(build("cavity", n=48, Re=100.0, fused_predictor=fused,
                                     device="cuda"), 300)
        worst = 0.0
        for key, want in ref.items():
            tol = GOLDEN_RTOL * abs(want) if abs(want) > atol else atol
            diff = abs(sig[key] - want)
            if not diff <= tol:
                raise AssertionError(f"golden {key} (fused={fused}): {sig[key]} vs {want}")
            worst = max(worst, diff / max(abs(want), atol))
        say("golden", fused_predictor=fused, keys=len(ref), worst_rel_err=worst,
            rtol=GOLDEN_RTOL)


def phase_main_path():
    pois = PoissonConfig(method="dct", dct_variant="rfft2")
    case = lid_cavity(n=1024, Re=1000.0, poisson=pois, compute_metrics=True,
                      fused_predictor=True, device="cuda")
    cfg = RunnerConfig(t_final=1e9, max_steps=600, chunk_steps=100, health_check=True,
                       div_threshold=50.0, max_velocity=case.cfg.max_velocity,
                       log_every_chunks=0)
    pred.KERNEL.launches = 0
    t0 = time.perf_counter()
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    state, report = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pred.KERNEL.launches
    steps = int(state.step)
    finite = bool(torch.isfinite(state.u).all() and torch.isfinite(state.v).all()
                  and torch.isfinite(state.p).all())
    max_u = float(state.u.abs().max())
    say("main_path", n=1024, Re=1000.0, steps=steps, launches=launches, finite=finite,
        max_abs_u=max_u, t=report["final_time"], stopped_reason=report["stopped_reason"],
        last_chunk=sim.metrics_history[-1], wall_s=wall,
        device_peak_bytes=report.get("device_peak_bytes"))
    if report["stopped_reason"] or steps != 600:
        raise AssertionError(f"main path stopped early: {report['stopped_reason']!r} at {steps}")
    if not finite or not max_u <= 1.5:
        raise AssertionError(f"main path unhealthy: finite={finite} max|u|={max_u}")
    if launches != steps:
        raise AssertionError(f"fused predictor launched {launches} times in {steps} steps")

    # fused vs unfused from the same state (these launches are not counted)
    other = lid_cavity(n=1024, Re=1000.0, poisson=pois, compute_metrics=True,
                       fused_predictor=False, device="cuda")
    cfl = torch.ones((), dtype=torch.float32, device="cuda")
    sa = sb = state
    for _ in range(5):
        sa, _ = case.step(sa, cfl)
        sb, _ = other.step(sb, cfl)
    err = max(float((getattr(sa, k) - getattr(sb, k)).abs().max()) for k in ("u", "v"))
    say("fused_vs_unfused", steps=5, max_abs_err=err, atol=STEP_ATOL)
    if not err <= STEP_ATOL:
        raise AssertionError(f"fused and unfused steps differ by {err}")
    return launches


def phase_timings(card):
    # main path, in turns on the same card: fused, unfused, unfused, fused
    for fused in (True, False, False, True):
        r = run_bench(n=1024, fused_predictor=fused)
        say("time_main_path", fused_predictor=fused, cells_per_s=r["value"],
            t_short_s=r["t_short_s"], t_long_s=r["t_long_s"], card=card)
    # the device time of one main-path step (no host dispatch in it)
    step_ms = {fused: step_device_ms(1024, fused) for fused in (True, False)}
    say("time_step_device", n=1024, fused_ms=step_ms[True], unfused_ms=step_ms[False],
        fused_cells_per_s=1024 * 1024 / (step_ms[True] * 1e-3),
        unfused_cells_per_s=1024 * 1024 / (step_ms[False] * 1e-3), card=card)
    # the predictor alone at the main path's shape, inputs streamed from
    # device memory: plain, kernel, kernel, plain
    pred_t = predictor_ms(1024, reps=200)
    say("time_predictor", shape=[1024, 1024], **pred_t, card=card)
    # one DCT solve at 1024²: rfft, rfft2, rfft2, rfft
    say("time_dct_solve", shape=[1024, 1024], **dct_solve_ms(1024, reps=50), card=card)
    return min(pred_t["kernel_device_ms"]), min(pred_t["plain_device_ms"])


def main() -> int:
    card = card_name_and_power_limit()
    print(card, flush=True)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    say("card", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], count=torch.cuda.device_count())

    say("build", kernel=pred.KERNEL.symbol, seconds=pred.KERNEL.build())
    max_err = phase_kernel_vs_plain()
    phase_golden()
    launches = phase_main_path()
    kernel_ms, plain_ms = phase_timings(card)

    for x in (max_err, kernel_ms, plain_ms):
        if not math.isfinite(x):
            raise AssertionError("non-finite measurement")
    print(json.dumps({"kernels": [{
        "name": "fused_predictor_central",
        "route": "cuda",
        "source": "cfdsim_tpu_torch/csrc/predictor.cu",
        "replaces": "cfdsim_tpu/ops/pallas/predictor.py:77",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
