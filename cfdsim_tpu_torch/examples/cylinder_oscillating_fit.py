"""Dütsch et al. (1998) KC=5, Re=100 in-line oscillating cylinder
(``examples/cylinder_oscillating_fit.py`` of the JAX package): run
`cylinder_oscillating` and least-squares fit the in-line body force to the
Morison decomposition

    F(t) = C_D · (D/2) · u_b|u_b|  +  C_m · (πD²/4) · a_b      (ρ = 1)

Published: C_D ≈ 2.09; the inertia coefficient carries the
penalization's fluid-in-body acceleration ρV·a ≡ +1 exactly, so the
added mass is C_m − 1 ≈ 1.45. The JAX package's moving-geometry notes
have the penalization ladder (uniform 20 c/D: C_D +22%; stretched 70 c/D:
+3.1%); `--ibm ghost` runs the moving sharp-interface ghost forcing
(``ibm_ghost.moving_ghost_forcing_2d``) on the uniform grid.

The steps run in chunks of ``chunk_steps`` through ``make_chunk`` (one
captured CUDA graph on the card; the moving body's stencils are rebuilt on
the device) with the force and t stacked per step. Beyond the JAX
driver's arguments: ``--device``, ``--io`` (the final state, native
``.csnap`` by default), ``--out`` and ``--chunk-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.cylinder_oscillating_fit --ibm ghost
--periods 4 [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
import time
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


class _Force(NamedTuple):
    fx: torch.Tensor
    t: torch.Tensor


def run(ibm="ghost", nx=480, ny=240, periods=4.0, chunk_steps=200, verbose=True, *,
        device="cuda", history=False):
    """{"cd", "cm", "rel_res"}: the Morison fit of the in-line force after the
    first period; with ``history``, also the per-step "t", "fx" and the
    final "state"."""
    from cfdsim_tpu_torch.cases import build

    device = device_of(device)
    case = build("cylinder_oscillating", nx=nx, ny=ny, ibm_scheme=ibm, device=device)
    T = case.extras["period"]
    A = case.extras["amplitude"]
    D = 2 * case.extras["radius"]
    om = 2 * np.pi / T
    t0 = time.perf_counter()

    def progress(state, h):
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):6.2f}/{periods * T:.0f}  "
                  f"fx={h['fx'][-1]:+7.3f}  "
                  f"[{float(state.step) / el:6.1f} steps/s]", flush=True)

    state, h = run_probed(case, lambda s, m: _Force(m.fx, s.t), chunk_steps, periods * T,
                          progress)
    t, fx = h["t"], h["fx"]
    tail = t > T  # drop the first period (startup transient)
    tt = t[tail]
    # body kinematics: x_c = x0 + A sin(ωt) → u_b = Aω cos, a_b = -Aω² sin
    ub = A * om * np.cos(om * tt)
    ab = -A * om * om * np.sin(om * tt)
    basis = np.stack([0.5 * D * ub * np.abs(ub),
                      0.25 * np.pi * D * D * ab], axis=1)
    coef, res, *_ = np.linalg.lstsq(basis, fx[tail], rcond=None)
    fit = basis @ coef
    rel_res = float(np.linalg.norm(fx[tail] - fit)
                    / np.linalg.norm(fx[tail]))
    cd, cm = float(abs(coef[0])), float(abs(coef[1]))
    print(f"\nRESULT ibm={ibm} {nx}x{ny} ({D / (24.0 / nx):.0f} cells/D): "
          f"C_D={cd:.3f} (pub 2.09, {100 * (cd / 2.09 - 1):+.1f}%)  "
          f"C_m-1={cm - 1:.3f} (pub ~1.45, "
          f"{100 * ((cm - 1) / 1.45 - 1):+.1f}%)  fit residual {rel_res:.1%}")
    out = {"cd": cd, "cm": cm, "rel_res": rel_res}
    if history:
        out.update(t=t, fx=fx, state=state)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ibm", default="ghost", choices=["ghost", "penalize"])
    p.add_argument("--nx", type=int, default=480)
    p.add_argument("--ny", type=int, default=240)
    p.add_argument("--periods", type=float, default=4.0)
    p.add_argument("--chunk-steps", type=int, default=200)
    add_common_args(p, "out/cylinder_oscillating_fit", render=False)
    a = p.parse_args(argv)
    res = run(ibm=a.ibm, nx=a.nx, ny=a.ny, periods=a.periods, chunk_steps=a.chunk_steps,
              device=a.device, history=True)
    path = save_final_state(a.out, a.io, res.pop("state"))
    write_report(a.out, {"ibm": a.ibm, "nx": a.nx, "ny": a.ny, **res, "snapshots": path})
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
