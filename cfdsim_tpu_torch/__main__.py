"""Command-line interface of the PyTorch port:

    python -m cfdsim_tpu_torch list
    python -m cfdsim_tpu_torch run cavity --n 1024 --Re 1000 \\
        --fused-predictor true --t-final 0.5 --device cuda
    python -m cfdsim_tpu_torch run cylinder --device cuda --ref-parity true \\
        --scheme supg --max-steps 200
    python -m cfdsim_tpu_torch run cavity --n 1024 --Re 1000 --poisson mg:2
    python -m cfdsim_tpu_torch run transport --n 1024 --Re 1000 --Pe 1000 \
        --io native --snapshot-interval 100 --max-steps 200
    python -m cfdsim_tpu_torch run transport --n 1024 --Re 1000 --Pe 1000 \
        --io native --snapshot-interval 100 --max-steps 400 --resume
    python -m cfdsim_tpu_torch render out/cavity/snapshots.h5 out/cavity/frames
    python -m cfdsim_tpu_torch video out/cavity/frames/velocity_frames movie.gif
    python -m cfdsim_tpu_torch thin out/cavity/frames/velocity_frames --keep-every 3
    python -m cfdsim_tpu_torch run cavity_mac --n 1024 --Re 1000 --device cuda
    python -m cfdsim_tpu_torch run cylinder_oscillating --stretched true --device cuda
    python -m cfdsim_tpu_torch run cylinder_mac --ibm-scheme ghost --device cuda
    python -m cfdsim_tpu_torch run heated_cavity --n 1024 --Ra 1e4 --poisson mg:2
    python -m cfdsim_tpu_torch run cavity3d_mac --n 256 --io native --device cuda
    python -m cfdsim_tpu_torch run sphere --nx 192 --ibm-scheme ghost --device cuda
    python -m cfdsim_tpu_torch run sphere_stretched --ibm-scheme ghost --use-les true \
        --les-model dynamic --Re 3900 --device cuda
    python -m cfdsim_tpu_torch run heated_cube --n 48 --io native --device cuda
    python -m cfdsim_tpu_torch run wedge --frame wedge_aligned --reconstruction muscl \
        --t-final 2.5 --io native --device cuda
    python -m cfdsim_tpu_torch run cavity_supersonic --real-geometry true --device cuda
    python -m cfdsim_tpu_torch run blast3d --n 128 --t-final 0.1 --device cuda
    python -m cfdsim_tpu_torch run kolmogorov --advection bfecc --t-final 7.5 --device cuda
    python -m cfdsim_tpu_torch run kolmogorov_ps --ny 1024 --noise 0.1 --io native --device cuda
    python -m cfdsim_tpu_torch run schafer_turek_fem --scheme projection --theta 0.5 \
        --h-near 0.0035 --h-far 0.015 --wake-refine true --dt 0.002 --t-final 12 \
        --io native --device cuda
    python -m cfdsim_tpu_torch bench [--n 1024] [--sweep | --profile | --all | --roofline
                                      | --cylinder | --routes | --fem]

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

``run`` writes a snapshot every ``--snapshot-interval`` steps (default 200;
0 turns them off) to ``<out>/snapshots.h5`` (``--io hdf5``, needs h5py) or
``<out>/snapshots.csnap`` (``--io native``, needs g++ and zlib: the writer
is compiled at first use). ``--resume [SNAPSHOTS]`` restores fields, step
and t from the latest snapshot (bare: the case's own file under ``--out``;
a ``.csnap`` file is read directly) and continues bit-exactly. An
unstructured FEM case (``cylinder_fem``, ``cavity_fem``,
``schafer_turek_fem``) snapshots its fields sampled onto the case's grid
(u, v, p, vorticity) and its nodal state (``fem_u``, ``fem_p``,
``fem_phi``), which ``--resume`` reads. ``--render``
and the ``render``, ``video`` and ``thin`` sub-commands need matplotlib and
Pillow, and h5py for the snapshots they read.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if v and v[0] in "([":
        # tuple/list literals, e.g. --center "(4.0,2.0)"
        import ast

        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
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


def _snapshot_fields(state) -> dict:
    """The (≥2-D) fields of a state, nested states (transport's
    ``CoupledState.flow``) included, by field name."""
    fields = {}
    for name in state._fields:
        value = getattr(state, name)
        if hasattr(value, "_fields"):
            fields.update(_snapshot_fields(value))
        elif hasattr(value, "ndim") and value.ndim >= 2:
            fields[name] = value
    return fields


def cmd_run(args, extra):
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
    from cfdsim_tpu_torch.utils.logging import setup_logging

    device = _device(args.device)
    out = Path(args.out or f"out/{args.case}")
    out.mkdir(parents=True, exist_ok=True)
    log = setup_logging("cfdsim_tpu_torch", log_dir=out / "logs")
    case = build(args.case, device=device, **extra)

    snapshot_fn = None
    snap_path = out / ("snapshots.csnap" if args.io == "native" else "snapshots.h5")

    state = case.state
    if args.resume is not None:
        # checkpoint-restart: fields, step and t from the latest snapshot;
        # the HDF5 writer skips steps already present and a reader of the
        # native container keeps one record per step and field, so numbering
        # in the same file simply continues
        from cfdsim_tpu_torch.io_ import restore

        src = Path(args.resume) if args.resume != "latest" else snap_path
        if not src.is_file():
            raise SystemExit(f"--resume: no snapshot file {src}")
        state = restore(case.state, src)
        log.info("resumed %s from %s at t=%g step=%d", args.case, src, float(state.t),
                 int(state.step))

    writer = None
    if args.snapshot_interval > 0:
        if args.io == "native":
            from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter

            writer = NativeSnapshotWriter(snap_path)
        else:
            from cfdsim_tpu_torch.io_ import SnapshotWriter

            writer = SnapshotWriter(snap_path)

        from cfdsim_tpu_torch.fem.sample import snapshot_fields

        fem_sampler = case.extras.get("sampler")

        def snapshot_fn(state, step, t):
            if fem_sampler is not None:
                writer.save(step, t, **snapshot_fields(fem_sampler, state))
            else:
                writer.save(step, t, **_snapshot_fields(state))

    health_fn = None
    if args.case in ("wedge", "cavity_supersonic"):
        from cfdsim_tpu_torch.monitor import check_compressible

        def health_fn(m, step):
            return check_compressible(m)

    cfg = RunnerConfig(
        t_final=args.t_final,
        max_steps=args.max_steps,
        chunk_steps=args.chunk_steps,
        snapshot_interval=args.snapshot_interval,
        on_unhealthy=args.on_unhealthy,
        wall_clock_limit_s=args.wall_clock_limit,
        div_threshold=args.div_threshold,
        max_velocity=getattr(case.cfg, "max_velocity", 1e3)
        if not isinstance(case.cfg, tuple)
        else 1e3,
    )
    sim = Simulation(case.step, state, cfg, case.grid.n_cells, snapshot_fn=snapshot_fn,
                     logger=log, health_fn=health_fn)
    try:
        _, report = sim.run()
    finally:
        if writer is not None and hasattr(writer, "close"):
            writer.close()  # the native writer drains its queue here
    print(json.dumps(report))
    if args.render and args.snapshot_interval > 0:
        h5 = snap_path
        if args.io == "native":
            from cfdsim_tpu_torch.io_.native import csnap_to_hdf5

            h5 = csnap_to_hdf5(snap_path, out / "snapshots.h5")
        from cfdsim_tpu_torch.viz import render_frames_from_hdf5

        fields = ("velocity", "vorticity")
        if hasattr(case.state, "theta"):  # scalar-coupled states
            fields = ("velocity", "vorticity", "temperature")
        cyl = None
        if "center" in case.extras and "radius" in case.extras:
            cyl = (case.extras["center"], case.extras["radius"])
        geometry = getattr(case.extras.get("mesh"), "geometry", {})
        if "cylinder_center" in geometry:  # an FEM mesh around a cylinder
            cyl = (geometry["cylinder_center"], geometry["cylinder_radius"])
        render_frames_from_hdf5(h5, out / "frames", grid=case.grid, fields=fields,
                                cylinder=cyl)
        print(f"frames in {out / 'frames'}")
    return report


def cmd_render(args, _extra):
    from cfdsim_tpu_torch.viz import render_frames_from_hdf5

    if not Path(args.snapshots).is_file():
        raise SystemExit(f"render: no snapshot file {args.snapshots}")
    paths = render_frames_from_hdf5(args.snapshots, args.out)
    print(json.dumps({k: len(v) for k, v in paths.items()}))


def cmd_video(args, _extra):
    from cfdsim_tpu_torch.viz import make_video

    out = make_video(args.frames, args.out, duration_s=args.duration)
    print(out)


def cmd_thin(args, _extra):
    from cfdsim_tpu_torch.viz import thin_frames

    r = thin_frames(args.frames, keep_every=args.keep_every, dry_run=args.dry_run,
                    confirm=not (args.yes or args.dry_run))
    print(json.dumps({"kept": r["kept"], "deleted": r["deleted"],
                      "aborted": r.get("aborted", False)}))


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
    elif args.roofline:
        rows = bench.run_roofline(n=args.n, device=device)
    elif args.cylinder:
        rows = bench.run_cylinder(device=device)
    elif args.routes:
        rows = bench.run_routes(device=device)
    elif args.fem:
        rows = bench.run_fem(device=device)
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
    pr.add_argument("--snapshot-interval", type=int, default=200)
    pr.add_argument("--io", choices=["hdf5", "native"], default="hdf5")
    pr.add_argument("--out", default=None)
    pr.add_argument("--on-unhealthy", choices=["stop", "backoff"], default="stop")
    pr.add_argument("--wall-clock-limit", type=float, default=0.0)
    pr.add_argument("--div-threshold", type=float, default=50.0)
    pr.add_argument("--render", action="store_true")
    pr.add_argument(
        "--resume", nargs="?", const="latest", default=None, metavar="SNAPSHOTS",
        help="resume from a snapshot file (bare --resume: the case's own "
             "snapshots file under --out)",
    )

    pv = sub.add_parser("render", help="render frames from snapshots")
    pv.add_argument("snapshots")
    pv.add_argument("out")

    pm = sub.add_parser("video", help="frames -> mp4/gif")
    pm.add_argument("frames")
    pm.add_argument("out")
    pm.add_argument("--duration", type=float, default=10.0)

    pt = sub.add_parser("thin", help="thin a frame directory")
    pt.add_argument("frames")
    pt.add_argument("--keep-every", type=int, default=2)
    pt.add_argument("--dry-run", action="store_true")
    pt.add_argument("--yes", "-y", action="store_true",
                    help="skip the interactive delete confirmation")

    pb = sub.add_parser("bench", help="run the headline benchmark on the card")
    pb.add_argument("--n", type=int, default=1024)
    pb.add_argument("--device", default="cuda")
    mode = pb.add_mutually_exclusive_group()
    mode.add_argument("--sweep", action="store_true",
                      help="per-size device times and eager cells/s, 256² to 4096²")
    mode.add_argument("--profile", action="store_true",
                      help="device events, busy time and idle share per step: the --n "
                           "cavity (DCT, MG, implicit), the ref-parity cylinder (also with "
                           "LES), the transport cavity, the MAC and stretched cells, the "
                           "heated and 3D cavities, the 3D bodies and the compressible "
                           "and spectral cells")
    mode.add_argument("--all", action="store_true",
                      help="marginal rbsor sweeps/s, MG V-cycles/s, DCT solves/s, ms per "
                           "Helmholtz solve, MAC, stretched and sphere cells/s and ms per "
                           "step of the implicit, LES, transport, heated, 3D, 3D-body, "
                           "compressible and spectral paths at --n")
    mode.add_argument("--roofline", action="store_true",
                      help="the card's peaks and, per tier (collocated, MAC, stretched, "
                           "sphere), flops and bytes per cell, the bound and the share of the "
                           "roof reached")
    mode.add_argument("--cylinder", action="store_true",
                      help="ref-parity cylinder steps/s, kernel A vs streaming rbsor")
    mode.add_argument("--routes", action="store_true",
                      help="kernel A's cluster and cooperative routes per shape and sweeps")
    mode.add_argument("--fem", action="store_true",
                      help="the FEM cylinder's monolithic and projection steps/s, with its "
                           "matvecs and host reads per step")

    args, unknown = p.parse_known_args(argv)
    extra = _extra_kwargs(unknown)
    if extra and args.cmd != "run":
        raise SystemExit(f"unexpected arguments for {args.cmd}: {unknown}")
    commands = {"list": cmd_list, "run": cmd_run, "render": cmd_render, "video": cmd_video,
                "thin": cmd_thin, "bench": cmd_bench}
    return commands[args.cmd](args, extra)


if __name__ == "__main__":
    main()
