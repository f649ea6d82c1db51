"""Mach-2 flow over a 10° wedge with θ-β-M validation and rendering
(``examples/wedge_shock.py`` of the JAX package).

Reproduces the reference's shockwave workflow (v1_shock.py main(),
:454-503): run the compressible FV solver, snapshot the conserved state,
and report the measured oblique-shock angle and jump ratios against the
analytic θ-β-M relation (β ≈ 39.3°, p₂/p₁ ≈ 1.707, ρ₂/ρ₁ ≈ 1.458 on the
weak branch); with ``--render``, density and velocity frames.

Beyond the JAX driver's arguments: ``--device``, ``--io`` (native ``.csnap``
by default) and ``--render`` (the JAX driver always renders).

Run: ``python -m cfdsim_tpu_torch.examples.wedge_shock [--flux hllc|roe|rusanov]
[--t-final 1.5] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    as_hdf5,
    close_writer,
    device_of,
    snapshot_writer,
    write_report,
)


def shock_report(U, grid) -> dict:
    """β from a line fit of the shock front (the highest ρ > 1.2 cell of
    each column for 1 ≤ x ≤ 1.8), and p₂/p₁, ρ₂/ρ₁ at x = 1.5 just above
    the wedge surface (the JAX driver's readout)."""
    from cfdsim_tpu_torch.solvers.riemann import cons_to_prim

    U = U.detach()
    rho = U[0].cpu().numpy()
    X = grid.x_coords()
    Y = grid.y_coords()
    xs, ys = [], []
    for j in range(len(X)):
        if 1.0 <= X[j] <= 1.8:
            idx = np.where(rho[:, j] > 1.2)[0]
            if len(idx):
                xs.append(X[j])
                ys.append(Y[idx.max()])
    beta = float(np.degrees(np.arctan(np.polyfit(xs, ys, 1)[0]))) if len(xs) > 1 else float("nan")
    jj = int(np.argmin(np.abs(X - 1.5)))
    ii = int(np.argmin(np.abs(Y - (np.tan(np.deg2rad(10)) * 1.0 + 0.08))))
    r, _, _, p = (a.cpu().numpy() for a in cons_to_prim(U, 1.4))
    return {"beta_deg": beta, "p2_p1": float(p[ii, jj]), "rho2_rho1": float(r[ii, jj])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flux", default="hllc", choices=["hllc", "roe", "rusanov"])
    ap.add_argument("--t-final", type=float, default=1.5)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=200)
    add_common_args(ap, "out/wedge")
    args = ap.parse_args(argv)

    from pathlib import Path

    from cfdsim_tpu_torch.cases import wedge
    from cfdsim_tpu_torch.monitor import check_compressible
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation

    device = device_of(args.device)
    out = Path(args.out)
    case = wedge(nx=args.nx, ny=args.ny, flux=args.flux, reconstruction="muscl", device=device)
    writer, path = snapshot_writer(out, args.io)
    sim = Simulation(
        case.step, case.state,
        RunnerConfig(t_final=args.t_final, chunk_steps=200, snapshot_interval=400),
        case.grid.n_cells,
        snapshot_fn=lambda s, st, t: writer.save(st, t, U=s.U),
        health_fn=lambda m, step: check_compressible(m),
    )
    try:
        state, report = sim.run()
    finally:
        close_writer(writer)
    print("run report:", report)

    shock = shock_report(state.U, case.grid)
    print(f"shock angle β = {shock['beta_deg']:.1f}° (analytic 39.3°)")
    print(f"p2/p1 = {shock['p2_p1']:.3f} (analytic 1.707);  "
          f"rho2/rho1 = {shock['rho2_rho1']:.3f} (analytic 1.458)")
    write_report(out, {"run_report": report, **shock, "snapshots": path})

    if args.render:
        from cfdsim_tpu_torch.viz import render_frames_from_hdf5

        render_frames_from_hdf5(as_hdf5(path), out / "frames", grid=case.grid,
                                fields=("density", "velocity"))
        print(f"frames in {out / 'frames'}")
    return 0 if not report["stopped_reason"] else 1


if __name__ == "__main__":
    sys.exit(main())
