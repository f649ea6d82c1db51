"""The reference's flagship v5 workflow, end to end
(``examples/cylinder_reference_v5.py`` of the JAX package).

Reproduces `python/flow_over_cylinder (Fischer)/v5.py main()` (reference
v5.py:615-698): Re=600 flow over a cylinder on a 600×180 grid with
artificial viscosity, IBM force ramp, fixed-dt warm-up, adaptive dt,
periodic health checks and snapshots every 200 steps; with ``--render``,
deferred frame rendering, an energy-history plot and video assembly.

The chunks of 200 steps run through the runner's ``make_chunk`` (one
captured CUDA graph on the card). The pressure solve is the exact DCT
projection by default; ``--ref-parity`` takes the reference's masked
1500-sweep red-black SOR (ω 1.7, early exit at residual 1e-8 checked every
50 sweeps, v5.py:202), which the port runs through the hand-written
cluster kernel (``rbsor_pallas``, kernel A; the JAX driver's default there
is the streaming XLA solve, which the JAX package measured faster on its
chip). Beyond the JAX driver's arguments: ``--device``, ``--io`` (native
``.csnap`` by default), ``--render`` (the JAX driver always renders),
``--max-steps``, ``--chunk-steps``, ``--nx`` and ``--ny``.

Run: ``python -m cfdsim_tpu_torch.examples.cylinder_reference_v5
[--t-final 2.0] [--ref-parity] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    as_hdf5,
    close_writer,
    device_of,
    snapshot_writer,
    write_report,
)
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

# the reference's pressure budget (v5.py:64-65) through kernel A
REF_PARITY_POISSON = PoissonConfig(method="rbsor_pallas", iters=1500, tol=1e-8,
                                   check_every=50, omega=1.7)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t-final", type=float, default=2.0,
                    help="simulated time (reference runs 30.0)")
    ap.add_argument("--ref-parity", action="store_true")
    ap.add_argument("--snapshot-interval", type=int, default=200)
    ap.add_argument("--max-steps", type=int, default=10_000_000)
    ap.add_argument("--chunk-steps", type=int, default=200)
    ap.add_argument("--nx", type=int, default=600)
    ap.add_argument("--ny", type=int, default=180)
    add_common_args(ap, "out/cylinder_v5")
    return ap.parse_args(argv)


def run(args):
    """The run: {"state", "report", "sim", "case", "snapshots"}."""
    from pathlib import Path

    from cfdsim_tpu_torch.cases import cylinder
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation
    from cfdsim_tpu_torch.utils.logging import setup_logging

    device = device_of(args.device)
    out = Path(args.out)
    log = setup_logging("cylinder_v5", log_dir=out / "logs")
    # reference v5.py:616-634 configuration
    case = cylinder(nx=args.nx, ny=args.ny, Re=600.0, ref_parity=args.ref_parity,
                    use_les=False, artificial_viscosity=1e-3,
                    poisson=REF_PARITY_POISSON if args.ref_parity else None, device=device)
    writer, path = snapshot_writer(out, args.io)

    def snapshot(state, step, t):
        writer.save(step, t, u=state.u, v=state.v, p=state.p)

    sim = Simulation(
        case.step, case.state,
        RunnerConfig(
            t_final=args.t_final,
            max_steps=args.max_steps,
            chunk_steps=args.chunk_steps,
            snapshot_interval=args.snapshot_interval,
            max_velocity=5.0,  # v5.py:66
            warmup_steps=1000,  # divergence threshold switch v5.py:611
            on_unhealthy="stop",  # v5 behavior (v5.py:657-660)
        ),
        case.grid.n_cells,
        snapshot_fn=snapshot,
        logger=log,
    )
    try:
        state, report = sim.run()
    finally:
        close_writer(writer)
    return {"state": state, "report": report, "sim": sim, "case": case, "snapshots": path}


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args)
    report, out = res["report"], res["snapshots"].parent
    print("run report:", report, flush=True)
    write_report(out, {"run_report": report, "snapshots": res["snapshots"],
                       "history": res["sim"].metrics_history})
    if args.render:
        from cfdsim_tpu_torch.viz import make_video, plot_energy_history, render_frames_from_hdf5

        case = res["case"]
        render_frames_from_hdf5(as_hdf5(res["snapshots"]), out / "frames", grid=case.grid,
                                cylinder=(case.extras["center"], case.extras["radius"]))
        plot_energy_history(res["sim"].metrics_history, out / "energy_history.png")
        video = make_video(out / "frames" / "velocity_frames", out / "cylinder.mp4",
                           duration_s=10.0)
        print(f"artifacts: {out}/{res['snapshots'].name}, frames/, energy_history.png, {video}")
    return 0 if not report["stopped_reason"] else 1


if __name__ == "__main__":
    sys.exit(main())
