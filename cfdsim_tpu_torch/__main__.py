"""Command-line interface of the PyTorch port:

    python -m cfdsim_tpu_torch list
    python -m cfdsim_tpu_torch run cavity --n 1024 --Re 1000 \\
        --fused-predictor true --t-final 0.5 --device cuda
    python -m cfdsim_tpu_torch run cylinder --device cuda --ref-parity true \\
        --scheme supg --max-steps 200
    python -m cfdsim_tpu_torch run cavity --n 1024 --Re 1000 --poisson mg:2
    python -m cfdsim_tpu_torch bench [--n 1024] [--sweep | --profile | --all | --cylinder
                                      | --routes]

On a CUDA device ``run`` steps through captured chunks (one CUDA graph per
chunk of ``--chunk-steps`` steps, replayed; see
``models/incompressible.py::make_chunk``) unless the step reads the host;
the route and its reason are logged and the route is in the report.
``bench`` times the captured chunk and the eager loop side by side.

Unknown ``--key value`` pairs on ``run`` are forwarded to the case builder
(ints/floats/bools auto-parsed; ``--poisson`` takes
"method[:iters[:omega]]", e.g. "mg:2" or "rbsor:100:1.7"). ``--device``
defaults to ``cuda`` and is never swapped for another device: without a
card, pass ``--device cpu``.
Snapshots, ``--resume``, ``--render`` and ``--io`` are not ported yet and
are refused.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

UNPORTED_RUN_FLAGS = ("snapshot_interval", "resume", "render", "io")


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def _extra_kwargs(unknown: list[str]) -> dict:
    kwargs = {}
    i = 0
    while i < len(unknown):
        key = unknown[i]
        if not key.startswith("--"):
            raise SystemExit(f"unexpected argument {key!r}")
        name = key[2:].replace("-", "_")
        if i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
            kwargs[name] = _parse_value(unknown[i + 1])
            i += 2
        else:
            kwargs[name] = True
            i += 1
    return kwargs


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: CUDA is not available here (pass --device cpu to "
            "run on the CPU)"
        )
    return device


def cmd_list(_args, _extra):
    from cfdsim_tpu_torch.cases import CASES

    for name, builder in sorted(CASES.items()):
        doc = (builder.__doc__ or "").strip().splitlines()[0]
        print(f"{name:20s} {doc}")


def cmd_run(args, extra):
    refused = [k for k in UNPORTED_RUN_FLAGS if k in extra]
    if refused:
        raise SystemExit(
            f"not ported yet: {', '.join('--' + k.replace('_', '-') for k in refused)} "
            "(snapshot I/O and resume are ROADMAP.md queue 1)"
        )
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
    from cfdsim_tpu_torch.utils.logging import setup_logging

    device = _device(args.device)
    out = Path(args.out or f"out/{args.case}")
    out.mkdir(parents=True, exist_ok=True)
    log = setup_logging("cfdsim_tpu_torch", log_dir=out / "logs")
    case = build(args.case, device=device, **extra)
    cfg = RunnerConfig(
        t_final=args.t_final,
        max_steps=args.max_steps,
        chunk_steps=args.chunk_steps,
        on_unhealthy=args.on_unhealthy,
        wall_clock_limit_s=args.wall_clock_limit,
        div_threshold=args.div_threshold,
        max_velocity=case.cfg.max_velocity,
    )
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells, logger=log)
    _, report = sim.run()
    print(json.dumps(report))
    return report


def cmd_bench(args, _extra):
    from cfdsim_tpu_torch import bench

    device = _device(args.device)
    if device.type != "cuda":
        raise SystemExit(f"--device {args.device}: the benchmark measures a CUDA device")
    if args.sweep:
        rows = bench.run_sweep(device=device)
    elif args.profile:
        rows = bench.run_profile(n=args.n, device=device)
    elif args.all:
        rows = bench.run_all(n=args.n, device=device)
    elif args.cylinder:
        rows = bench.run_cylinder(device=device)
    elif args.routes:
        rows = bench.run_routes(device=device)
    else:  # the captured chunk (the path's metric), then the eager loop beside it
        rows = (bench.run_bench(n=args.n, device=device, route=route)
                for route in (None, "loop"))
    for row in rows:
        print(json.dumps(row), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="cfdsim_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list named cases")

    pr = sub.add_parser("run", help="run a named case")
    pr.add_argument("case")
    pr.add_argument("--device", default="cuda")
    pr.add_argument("--t-final", type=float, default=1.0)
    pr.add_argument("--max-steps", type=int, default=10_000_000)
    pr.add_argument("--chunk-steps", type=int, default=100)
    pr.add_argument("--out", default=None)
    pr.add_argument("--on-unhealthy", choices=["stop", "backoff"], default="stop")
    pr.add_argument("--wall-clock-limit", type=float, default=0.0)
    pr.add_argument("--div-threshold", type=float, default=50.0)

    pb = sub.add_parser("bench", help="run the headline benchmark on the card")
    pb.add_argument("--n", type=int, default=1024)
    pb.add_argument("--device", default="cuda")
    mode = pb.add_mutually_exclusive_group()
    mode.add_argument("--sweep", action="store_true",
                      help="per-size device times and eager cells/s, 256² to 4096²")
    mode.add_argument("--profile", action="store_true",
                      help="device events, busy time and idle share per step: the --n "
                           "cavity (DCT, MG) and the ref-parity cylinder")
    mode.add_argument("--all", action="store_true",
                      help="marginal rbsor sweeps/s, MG V-cycles/s, DCT solves/s at --n")
    mode.add_argument("--cylinder", action="store_true",
                      help="ref-parity cylinder steps/s, kernel A vs streaming rbsor")
    mode.add_argument("--routes", action="store_true",
                      help="kernel A's cluster and cooperative routes per shape and sweeps")

    args, unknown = p.parse_known_args(argv)
    extra = _extra_kwargs(unknown)
    if extra and args.cmd != "run":
        raise SystemExit(f"unexpected arguments for {args.cmd}: {unknown}")
    return {"list": cmd_list, "run": cmd_run, "bench": cmd_bench}[args.cmd](args, extra)


if __name__ == "__main__":
    main()
