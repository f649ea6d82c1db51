"""The cylinder across the three solver tiers
(``examples/cylinder_accuracy_tiers.py`` of the JAX package): collocated
(reference parity), uniform MAC (exact projection + TVD), and stretched
MAC (body/wake-refined grid + fast-diagonalization Poisson).

Runs each tier at a comparable cost budget, measures the Strouhal number
from a wake probe and the drag/lift coefficients from the IBM
penalization force, and prints a comparison table against the empirical
values (St ≈ 0.183 at Re=150; mean C_D ≈ 1.33 unconfined).

Each tier runs chunks of 1000 steps through ``make_chunk`` (one captured
CUDA graph on the card) with dt, the probe and the force stacked per step.
Beyond the JAX driver's positional ``[Re] [t_final]``: ``--device``,
``--io`` (each tier's final state, native ``.csnap`` by default, under
``<out>/<tier>``), ``--out``, ``--grid-scale`` (multiplies every tier's
grid; 1 by default) and ``--chunk-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.cylinder_accuracy_tiers [Re]
[t_final] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    device_of,
    run_probed,
    save_final_state,
    write_report,
)


class _Probe(NamedTuple):
    dt: torch.Tensor
    v: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor


def run_case(case, probe_xy, t_final, label, chunk_steps=1000, out=None, io="native"):
    """(St, mean C_D) of one tier from its probe's v and its body force over
    the second half of the run; prints the row. With ``out``, the final
    state is written there."""
    from cfdsim_tpu_torch.validation import strouhal_number

    xg = case.extras.get("x_faces")
    if xg is not None:
        yf = case.extras["y_faces"]
        xc = 0.5 * (xg[:-1] + xg[1:])
        ix = int(np.argmin(np.abs(xc - probe_xy[0])))
        iy = int(np.argmin(np.abs(yf - probe_xy[1])))
    else:
        g = case.grid
        ix = int(round(probe_xy[0] / g.dx - 0.5))
        iy = int(round(probe_xy[1] / g.dy))

    state, h = run_probed(case, lambda s, m: _Probe(m.dt, s.v[iy, ix], m.fx, m.fy),
                          chunk_steps, t_final)
    dts, probes, fxs, fys = h["dt"], h["v"], h["fx"], h["fy"]
    tg = np.cumsum(dts)
    sel = tg > 0.5 * tg[-1]
    tu = np.linspace(tg[sel][0], tg[-1], int(sel.sum()))
    pu = np.interp(tu, tg[sel], probes[sel])
    st = strouhal_number(pu, tu[1] - tu[0], 1.0, 1.0)
    cd = 2.0 * np.average(fxs[sel], weights=dts[sel])
    cl = 2.0 * 0.5 * (fys[sel].max() - fys[sel].min())
    print(f"{label:34s} cells={case.grid.n_cells/1e3:6.0f}k  "
          f"St={st:.3f}  mean C_D={cd:.3f}  C_L amp={cl:.3f}")
    if out is not None:
        save_final_state(out, io, state)
    return st, cd


def _scaled(n: int, scale: float, multiple: int = 2) -> int:
    return max(multiple, int(round(n * scale / multiple)) * multiple)


def main(argv=None) -> dict:
    from cfdsim_tpu_torch.cases import cylinder, cylinder_mac, cylinder_stretched

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("Re", nargs="?", type=float, default=150.0)
    ap.add_argument("t_final", nargs="?", type=float, default=150.0)
    ap.add_argument("--grid-scale", type=float, default=1.0)
    ap.add_argument("--chunk-steps", type=int, default=1000)
    add_common_args(ap, "out/cylinder_accuracy_tiers", render=False)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    Re, t_final, s = args.Re, args.t_final, args.grid_scale
    out = Path(args.out)

    probe = (8.0, 4.0)
    print(f"Re={Re}: empirical St≈0.183 (Re=150) / 0.196 (Re=200); "
          f"mean C_D≈1.33 unconfined\n")
    tiers = {}

    def tier(name, case, probe_xy, label):
        st, cd = run_case(case, probe_xy, t_final, label, args.chunk_steps, out / name,
                          args.io)
        tiers[name] = {"label": label, "cells": case.grid.n_cells, "St": st, "mean_CD": cd}

    nx, ny = _scaled(720, s), _scaled(240, s)
    tier("uniform_mac", cylinder_mac(nx=nx, ny=ny, Re=Re, device=device), probe,
         f"uniform MAC {nx}x{ny} (tvd)")
    nx, ny = _scaled(384, s), _scaled(192, s)
    tier("stretched_mac", cylinder_stretched(nx=nx, ny=ny, Re=Re, device=device), probe,
         f"stretched MAC {nx}x{ny} (tvd)")
    # collocated reference-style tier (its own geometry/probe)
    nx, ny = _scaled(300, s), _scaled(90, s)
    case = cylinder(nx=nx, ny=ny, Re=Re, domain=(15.0, 4.0), center=(3.0, 2.0), dt_max=2e-3,
                    warmup_steps=200, warmup_dt=5e-4, ibm_ramp_steps=200, device=device)
    tier("collocated", case, (5.0, 2.0), f"collocated {nx}x{ny} (upwind, 25% blk)")
    report = {"Re": Re, "t_final": t_final, "tiers": tiers}
    write_report(out, report)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
