"""Static-cylinder force validation: sharp-mask penalization vs the
ghost-cell direct-forcing IBM (``examples/cylinder_ghost_forces.py`` of
the JAX package).

The JAX package's static sharp-profile cylinder sweep (720×240, 30
cells/D, 12.5% blockage, t=150) measured Cd 1.557 at Re=100 against the
unconfined ~1.35: the O(dx/2) sharp-mask effective-diameter bias plus
blockage. The ghost scheme places no-slip exactly on r = R, so the
residual offset should be mostly the blockage. Drag/lift from the
momentum-exchange force, Strouhal from the tail FFT of the lift.

The steps run in chunks of ``chunk_steps`` through ``make_chunk`` (one
captured CUDA graph on the card) with the force and t stacked per step.
Beyond the JAX driver's arguments: ``--device``, ``--io`` (the final state,
native ``.csnap`` by default), ``--out``, ``--t-tail`` and
``--chunk-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.cylinder_ghost_forces --re 100
--ibm ghost --t 150 [--device cuda]``.
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


class _Forces(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    t: torch.Tensor


def run(re=100.0, ibm="ghost", nx=720, ny=240, t_final=150.0, t_tail=75.0, chunk_steps=200,
        domain=(24.0, 8.0), center=(6.0, None), verbose=True, *, device="cuda",
        history=False):
    """{"st", "cd", "cl_amp"} from the lift's tail spectrum and the force
    history after ``t_tail``; with ``history``, also the per-step "t",
    "cd_series", "cl_series" and the final "state"."""
    from cfdsim_tpu_torch.cases import build

    device = device_of(device)
    kw = (dict(ibm_scheme="ghost") if ibm == "ghost"
          else dict(ibm_profile="sharp"))
    cy = domain[1] / 2 if center[1] is None else center[1]
    case = build("cylinder_mac", nx=nx, ny=ny, Re=re, domain=domain,
                 center=(center[0], cy), device=device, **kw)
    radius = case.extras["radius"]
    v_inf = case.extras["v_inf"]
    coeff = 2.0 / (v_inf**2 * 2 * radius)  # force per unit density -> C
    t0 = time.perf_counter()

    def progress(state, h):
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):7.2f}  Cd={h['fx'][-1] * coeff:6.3f}  "
                  f"Cl={h['fy'][-1] * coeff:+6.3f}  "
                  f"[{float(state.step) / el:6.1f} steps/s]", flush=True)

    state, h = run_probed(case, lambda s, m: _Forces(m.fx, m.fy, s.t), chunk_steps, t_final,
                          progress)
    t, cd, cl = h["t"], h["fx"] * coeff, h["fy"] * coeff
    tail = t > t_tail
    # uniform-in-time resample for the FFT (adaptive dt)
    tu = np.linspace(t[tail][0], t[tail][-1], tail.sum())
    clu = np.interp(tu, t[tail], cl[tail])
    spec = np.abs(np.fft.rfft(clu - clu.mean()))
    freqs = np.fft.rfftfreq(len(clu), tu[1] - tu[0])
    f_shed = freqs[1:][np.argmax(spec[1:])]
    st = f_shed * 2 * radius / v_inf
    cd_mean = float(cd[tail].mean())
    cl_amp = float(np.sqrt(2.0) * cl[tail].std())
    print(f"\nRESULT ibm={ibm} Re={re:g}: St={st:.3f}  "
          f"mean Cd={cd_mean:.3f}  Cl_amp={cl_amp:.3f}  "
          f"(unconfined lit Re=100: St 0.165 / Cd ~1.35 / Cl ~0.33; "
          f"Re=150: St 0.185 / Cd ~1.33 / Cl ~0.5)")
    out = {"st": float(st), "cd": cd_mean, "cl_amp": cl_amp}
    if history:
        out.update(t=t, cd_series=cd, cl_series=cl, state=state)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--ibm", default="ghost", choices=["ghost", "sharp"])
    p.add_argument("--t", type=float, default=150.0)
    p.add_argument("--t-tail", type=float, default=75.0,
                   help="start of the analysed tail (the JAX driver's fixed 75)")
    p.add_argument("--nx", type=int, default=720)
    p.add_argument("--ny", type=int, default=240)
    p.add_argument("--ly", type=float, default=8.0,
                   help="domain height (8 -> 12.5%% blockage at D=1; "
                        "16 with --ny 480 halves the blockage at the "
                        "same resolution)")
    p.add_argument("--chunk-steps", type=int, default=200)
    add_common_args(p, "out/cylinder_ghost_forces", render=False)
    a = p.parse_args(argv)
    res = run(re=a.re, ibm=a.ibm, nx=a.nx, ny=a.ny, t_final=a.t, t_tail=a.t_tail,
              chunk_steps=a.chunk_steps, domain=(24.0, a.ly), device=a.device, history=True)
    path = save_final_state(a.out, a.io, res.pop("state"))
    write_report(a.out, {"re": a.re, "ibm": a.ibm, **res, "snapshots": path})
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
