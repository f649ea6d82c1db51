"""Natural-convection showcase: the three Boussinesq benchmarks
(``examples/natural_convection.py`` of the JAX package).

1. Differentially heated square cavity (de Vahl Davis 1983): runs to
   steady state and prints the average hot-wall Nusselt number against
   the benchmark value for the chosen Ra.
2. Rayleigh–Bénard onset: two short runs bracketing the critical
   Rayleigh number Ra_c = 1708 (subcritical decay vs supercritical roll
   growth).
3. Optionally (--cube) the 3D heated cube against the Tric et al. (2000)
   spectral benchmark.

Each run is chunks of 1000 steps through ``make_chunk`` (one captured CUDA
graph on the card). Beyond the JAX driver's ``[Ra] [--cube]``: ``--device``,
``--io`` (the final heated-cavity state, native ``.csnap`` by default),
``--out``, ``--n`` (the heated cavity's grid: 64, or 128 from Ra = 1e5 on),
``--rb-ny``, ``--cube-n``, ``--chunk`` and ``--t-scale`` (multiplies every
end time; 1 by default).

Run: ``python -m cfdsim_tpu_torch.examples.natural_convection [Ra] [--cube]
[--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    device_of,
    save_final_state,
    write_report,
)

BENCH_2D = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519, 1e6: 8.800}
BENCH_CUBE = {1e4: 2.054, 1e5: 4.337, 1e6: 8.640}


def drive(case, t_end, chunk=1000):
    """Chunks of ``chunk`` steps until t ≥ ``t_end``: (state, the last
    chunk's metrics stacked, as numpy)."""
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.utils.tree import tree_map

    run = make_chunk(case.cfg, case.step, chunk)
    s, ms = case.state, None
    while float(s.t) < t_end:
        s, ms = run(s, 1.0)
    return s, (None if ms is None else tree_map(lambda x: x.cpu().numpy(), ms))


def main(argv=None) -> dict:
    from cfdsim_tpu_torch.cases import heated_cavity, heated_cube, rayleigh_benard

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("Ra", nargs="?", type=float, default=1e4)
    ap.add_argument("--cube", action="store_true")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--rb-ny", type=int, default=32)
    ap.add_argument("--cube-n", type=int, default=48)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--t-scale", type=float, default=1.0)
    add_common_args(ap, "out/natural_convection", render=False)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    Ra, ts = args.Ra, args.t_scale
    report = {"Ra": Ra}

    n = args.n or (64 if Ra < 1e5 else 128)
    case = heated_cavity(n=n, Ra=Ra, device=device)
    s, ms = drive(case, (0.6 if Ra < 1e5 else 0.4) * ts, args.chunk)
    nu = float(np.asarray(ms.nu_hot_wall)[-1])
    ref = BENCH_2D.get(Ra)
    ref_s = f"(de Vahl Davis: {ref})" if ref else ""
    max_v = float(np.asarray(ms.max_vel)[-1])
    print(f"heated cavity Ra={Ra:g}: Nu = {nu:.4f} {ref_s}  max|V| = {max_v:.2f}")
    report["heated_cavity"] = {"n": n, "nu_hot_wall": nu, "benchmark": ref, "max_vel": max_v,
                               "t": float(s.t)}
    report["snapshots"] = save_final_state(args.out, args.io, s)

    report["rayleigh_benard"] = []
    for ra, t_end in ((1200.0, 1.0), (3000.0, 5.0)):
        case = rayleigh_benard(ny=args.rb_ny, aspect=2.0, Ra=ra, device=device)
        s, ms = drive(case, t_end * ts, args.chunk)
        vel = float(np.asarray(ms.max_vel)[-1])
        nu_rb = float(np.asarray(ms.nu_hot_wall)[-1])
        regime = "conducting (perturbation decayed)" if vel < 1e-2 else \
                 f"convecting (Nu = {nu_rb:.3f})"
        print(f"Rayleigh-Benard Ra={ra:g} (Ra_c = 1708): {regime}")
        report["rayleigh_benard"].append({"Ra": ra, "max_vel": vel, "nu_hot_wall": nu_rb,
                                          "convecting": vel >= 1e-2})

    if args.cube:
        case = heated_cube(n=args.cube_n, Ra=1e4, device=device)
        s, ms = drive(case, 0.45 * ts, args.chunk)
        nu_c = float(np.asarray(ms.nu_hot_wall)[-1])
        print(f"heated cube Ra=1e4: Nu = {nu_c:.4f} (Tric et al.: {BENCH_CUBE[1e4]})")
        report["heated_cube"] = {"n": args.cube_n, "nu_hot_wall": nu_c,
                                 "benchmark": BENCH_CUBE[1e4]}
    write_report(args.out, report)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
