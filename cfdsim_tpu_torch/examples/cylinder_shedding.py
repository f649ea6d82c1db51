"""Kármán vortex street behind a cylinder with Strouhal validation
(``examples/cylinder_shedding.py`` of the JAX package).

The reference's flagship demo (v3-v5: Re=100-600 cylinder producing a
vortex street, validated only visually). Here the wake probe's oscillation
frequency is checked against the empirical Strouhal band St ≈ 0.15-0.20
for Re = 100-200.

The probe (v 2.5 diameters behind the centre) is read after every
``sample_every`` steps: each sample ends a chunk of ``make_chunk`` (one
captured CUDA graph on the card), and the forty samples of a call reach the
host in one read, as the JAX driver's scan returns them. Beyond the JAX
driver's positional ``[Re] [n_periods]`` (the second is read and unused
there too): ``--device``, ``--io`` (the final state, native ``.csnap`` by
default), ``--out``, ``--t-final``, ``--nx``, ``--ny``.

Run: ``python -m cfdsim_tpu_torch.examples.cylinder_shedding [Re] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    device_of,
    save_final_state,
    write_report,
)


def run_shedding(Re=150.0, t_final=80.0, nx=300, ny=90, sample_every=25, verbose=True, *,
                 device="cuda"):
    """(times, probe, case, state): the probe's v every ``sample_every``
    steps until ``t_final`` (in calls of 40 samples), as the JAX function of
    the name returns (times, probe, case)."""
    from cfdsim_tpu_torch.cases import cylinder
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    device = device_of(device)
    # faster-than-parity settings: shorter domain, dt_max opened up to the
    # CFL limit (the reference caps dt at 1e-4 for robustness, v5.py:57)
    case = cylinder(
        nx=nx, ny=ny, Re=Re,
        domain=(15.0, 4.0), center=(3.0, 2.0),
        dt_max=2e-3, warmup_steps=200, warmup_dt=5e-4,
        ibm_ramp_steps=200, cfl_target=0.35, artificial_viscosity=0.0,
        scheme="upwind", device=device,
    )
    # probe: v-velocity 2.5 diameters downstream of the cylinder center
    X, Y = case.grid.meshgrid()
    cx, cy = case.extras["center"]
    j = int(np.argmin(np.abs(X[0] - (cx + 2.5))))
    i = int(np.argmin(np.abs(Y[:, 0] - cy)))

    chunk = make_chunk(case.cfg, case.step, sample_every, device=device)
    state = case.state
    times, probe = [], []
    while float(state.t) < t_final:
        t0 = float(state.t)
        samples = []
        for _ in range(40):
            state, _ = chunk(state, 1.0)
            samples.append(state.v[i, j].clone())
        v_last = torch.stack(samples).cpu().numpy()  # one sample per `sample_every` steps
        t1 = float(state.t)
        probe.extend(v_last.tolist())
        times.extend(np.linspace(t0, t1, len(v_last), endpoint=False).tolist())
        if verbose:
            print(f"t={t1:7.2f}  probe v={v_last[-1]:+.3f}", flush=True)
    return np.asarray(times), np.asarray(probe), case, state


def main(argv=None):
    from cfdsim_tpu_torch.validation import strouhal_number

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("Re", nargs="?", type=float, default=150.0)
    ap.add_argument("n_periods", nargs="?", type=float, default=None,
                    help="accepted and unused, as in the JAX driver")
    ap.add_argument("--t-final", type=float, default=80.0)
    ap.add_argument("--nx", type=int, default=300)
    ap.add_argument("--ny", type=int, default=90)
    ap.add_argument("--sample-every", type=int, default=25)
    add_common_args(ap, "out/cylinder_shedding", render=False)
    args = ap.parse_args(argv)

    times, probe, case, state = run_shedding(Re=args.Re, t_final=args.t_final, nx=args.nx,
                                             ny=args.ny, sample_every=args.sample_every,
                                             device=args.device)
    # analyze the established-shedding tail (last 60% of the signal)
    n0 = int(0.4 * len(probe))
    sample_dt = float(np.mean(np.diff(times[n0:])))
    St = strouhal_number(probe[n0:], sample_dt, 2 * case.extras["radius"], 1.0)
    amp = float(np.std(probe[n0:]))
    print(f"Re={args.Re:.0f}: St={St:.3f} (empirical ~0.16-0.19), "
          f"probe amplitude={amp:.3f}")
    path = save_final_state(args.out, args.io, state)
    write_report(args.out, {"Re": args.Re, "St": St, "probe_amplitude": amp,
                            "times": times, "probe": probe, "snapshots": path})
    return St, amp


if __name__ == "__main__":
    main()
    sys.exit(0)
