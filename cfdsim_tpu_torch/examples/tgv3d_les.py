"""3D Taylor–Green vortex at Re = 1600: the classic LES validation
(``examples/tgv3d_les.py`` of the JAX package).

The TGV (u = sin x cos y cos z, v = −cos x sin y cos z, w = 0, E₀ = 0.125)
transitions to turbulence and its dissipation rate ε(t) = −dE/dt peaks near
t ≈ 9 (Brachet et al. 1983 DNS: ε_max ≈ 0.0117 at t ≈ 9.0 for Re = 1600).
The [0, π]³ free-slip box keeps the TGV's symmetry planes, so the full
2π-periodic solution is recovered at 1/8 of the cells
(``mac3d.free_slip_bcs3d``). At 64³ the flow is under-resolved past t ≈ 7;
the Smagorinsky (or dynamic) LES supplies the missing subgrid dissipation.
The driver reports the ε(t) peak against the DNS and the slope of the
mirrored 3D spectrum at the end.

The steps run in chunks of ``chunk`` steps through ``make_chunk`` (one
captured CUDA graph on the card) with E and dt stacked per step. Beyond the
JAX driver's arguments: ``--device``, ``--io`` (the final state, native
``.csnap`` by default), ``--out``, ``--chunk`` and ``--max-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.tgv3d_les [--n 64] [--re 1600]
[--t-final 14] [--model smagorinsky|dynamic] [--no-les] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
import time
from types import SimpleNamespace
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


class _EnergyProbe(NamedTuple):
    energy: torch.Tensor
    dt: torch.Tensor


def tgv_velocity(n: int):
    """The TGV's u on x faces and v on y faces of the [0, π]³ box of n³
    cells, float32 numpy arrays (nz, ny, nx+1) and (nz, ny+1, nx)."""
    h = np.pi / n
    xf = np.arange(n + 1) * h  # face coordinates
    xc = (np.arange(n) + 0.5) * h  # centre coordinates
    u0 = (np.sin(xf)[None, None, :] * np.cos(xc)[None, :, None]
          * np.cos(xc)[:, None, None]).astype(np.float32)
    v0 = (-np.cos(xc)[None, None, :] * np.sin(xf)[None, :, None]
          * np.cos(xc)[:, None, None]).astype(np.float32)
    return u0, v0


def dissipation_rate(ts, es) -> dict:
    """ε(t) = −dE/dt at the midpoints, smoothed by a box window of ~0.25
    time units (it removes the dt-level noise without moving the peak), and
    its peak: {"t_eps", "eps", "t_peak", "eps_peak"}."""
    ts = np.asarray(ts)
    es = np.asarray(es)
    t_mid = 0.5 * (ts[1:] + ts[:-1])
    eps = -np.diff(es) / np.diff(ts)
    n_w = max(1, int(0.25 / np.mean(np.diff(ts))))
    kern = np.ones(n_w) / n_w
    eps_s = np.convolve(eps, kern, mode="same")
    k = int(np.argmax(eps_s))
    return {"t_eps": t_mid, "eps": eps_s, "t_peak": float(t_mid[k]),
            "eps_peak": float(eps_s[k])}


def inertial_slope(kk, ek, n: int) -> float:
    """The log-log slope of E(k) over shells [4, max(6, n/4))."""
    band = slice(4, max(6, n // 4))
    return float(np.polyfit(np.log(kk[band]), np.log(ek[band] + 1e-30), 1)[0])


def run_tgv(n=64, re=1600.0, t_final=14.0, use_les=True, chunk=200, les_model="smagorinsky",
            verbose=True, *, device="cuda", max_steps=None):
    """{"t", "E", "t_eps", "eps", "t_peak", "eps_peak", "k", "E_k", "slope"},
    as the JAX function returns, and the per-step "dt"
    and the final "state"."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.utils.spectra import energy_spectrum_3d

    device = device_of(device)
    u0, v0 = tgv_velocity(n)
    cfg = mac3d.MAC3DConfig(
        grid=Grid3D(nx=n, ny=n, nz=n, x_max=np.pi, y_max=np.pi, z_max=np.pi,
                    centering="cell"),
        nu=1.0 / re,
        # energy-conserving: dissipation comes from ν and the subgrid model only
        scheme="central",
        use_les=use_les,
        les_model=les_model,
        cfl_target=0.3,
    )
    step = mac3d.make_step(cfg, mac3d.free_slip_bcs3d(), device=device)
    state = mac3d.init_state(cfg, u0=u0, v0=v0, device=device)
    case = SimpleNamespace(cfg=cfg, step=step, state=state)

    ts, es = [0.0], [0.125]
    t0 = time.perf_counter()

    def on_chunk(state, h):
        # chunk-resolved energy series (times from the dt sequence)
        tt = float(ts[-1]) + np.cumsum(np.asarray(h["dt"], np.float64))
        ts.extend(tt.tolist())
        es.extend(np.asarray(h["energy"], np.float64).tolist())
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={ts[-1]:6.2f}  E={es[-1]:.5f}  [{len(ts) / el:6.0f} steps/s]",
                  flush=True)
        if not np.isfinite(es[-1]):
            raise RuntimeError("blow-up")

    state, h = run_probed(case, lambda s, m: _EnergyProbe(m.energy, m.dt), chunk, t_final,
                          on_chunk, max_steps=max_steps)
    # shell-averaged spectrum of the final state (the free-slip octant,
    # parity-mirrored) and its inertial-range slope
    uc, vc, wc = mac3d.center_velocities_3d(state.u, state.v, state.w)
    kk, ek = energy_spectrum_3d(uc, vc, wc, mirror=True)
    slope = inertial_slope(kk, ek, n)
    out = {"t": np.asarray(ts), "E": np.asarray(es), **dissipation_rate(ts, es), "k": kk,
           "E_k": ek, "slope": slope}
    out.update(dt=h.get("dt", np.zeros(0)), state=state)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--re", type=float, default=1600.0)
    ap.add_argument("--t-final", type=float, default=14.0)
    ap.add_argument("--no-les", action="store_true")
    ap.add_argument("--model", default="smagorinsky", choices=["smagorinsky", "dynamic"],
                    help="subgrid model: static C_s or dynamic Germano–Lilly")
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after the chunk that reaches this step")
    add_common_args(ap, "out/tgv3d_les", render=False)
    args = ap.parse_args(argv)
    r = run_tgv(n=args.n, re=args.re, t_final=args.t_final, use_les=not args.no_les,
                chunk=args.chunk, les_model=args.model, device=args.device,
                max_steps=args.max_steps)
    tag = "no-model" if args.no_les else f"LES/{args.model}"
    print(f"TGV {args.n}³ Re={args.re:g} [{tag}]: "
          f"eps peak {r['eps_peak']:.4f} at t={r['t_peak']:.2f} "
          f"(Brachet DNS: ~0.0117 at t~9.0); "
          f"E(k) slope at t={r['t'][-1]:g}: {r['slope']:.2f} (inertial range: -5/3)")
    state = r.pop("state")
    path = save_final_state(args.out, args.io, state)
    write_report(args.out, {"n": args.n, "re": args.re, "model": tag, **r,
                            "steps": int(state.step), "snapshots": path})
    return r


if __name__ == "__main__":
    main()
    sys.exit(0)
