"""Uniform flow past a sphere: the 3D IBM validation run
(``examples/sphere_wake.py`` of the JAX package).

The 3D habitat of the reference's flagship immersed-boundary capability
(cylinder IBM, v5.py:275-283): sharp-mask penalization (or the ghost-cell
wall) on the staggered mac3d tier, exact 3D DCT projection (FDM on the
stretched grid), TVD convection. Validates the drag against the
Schiller–Naumann correlation and the rear recirculation length against
Johnson & Patel (1999) (L_r/D ≈ 0.87 at Re = 100; steady axisymmetric wake
below Re ≈ 210); with ``--heated``, the Nusselt number against Ranz–Marshall.

The steps run in chunks of ``chunk_steps`` through ``make_chunk`` (one
captured CUDA graph on the card) with fx, fy, fz, dt and Nu stacked per step.
Beyond the JAX driver's arguments: ``--device``, ``--io`` (the final state,
native ``.csnap`` by default), ``--out``, ``--chunk-steps`` and
``--max-steps`` (stop after the chunk that reaches it).

Run: ``python -m cfdsim_tpu_torch.examples.sphere_wake [--re 100] [--n 12] [--t 40]
[--device cuda]``; ``--n`` is cells per diameter (12 → 192×96×96).
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


class _SphereProbe(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor
    dt: torch.Tensor
    nusselt: torch.Tensor


def face_x(case, stretched: bool) -> np.ndarray:
    """The x faces in float32, as the JAX driver builds them: the stretched
    grid's table, or x_min + i·dx."""
    if stretched:
        return np.asarray(case.extras["x_faces"], np.float32)
    g = case.grid
    return np.float32(g.x_min) + np.arange(g.nx + 1, dtype=np.float32) * np.float32(g.dx)


def recirculation_length(u, xf, center_x: float, radius: float) -> float:
    """L_r/D: from the rear stagnation point (x = center_x + R) to the last
    x face behind the body where the centreline u (the mean of the four
    faces around y = z = mid) is negative; 0 without reverse flow. In
    float32, as the JAX driver computes it."""
    u = np.asarray(u, np.float32)
    nz, ny = u.shape[0], u.shape[1]
    k, j = nz // 2, ny // 2
    u_line = np.float32(0.25) * (u[k - 1, j - 1] + u[k - 1, j] + u[k, j - 1] + u[k, j])
    xf = np.asarray(xf, np.float32)
    rear = np.float32(center_x + radius)
    neg = (u_line < 0.0) & (xf > rear)
    l_r = np.max(np.where(neg, xf, -np.inf)).astype(np.float32) - rear if neg.any() else 0.0
    return float(l_r) / (2 * radius)


def run_sphere(re: float = 100.0, cells_per_d: int = 12, t_final: float = 40.0,
               chunk_steps: int = 100, verbose: bool = True, stretched: bool = False,
               heated: bool = False, ibm_scheme: str = "penalize",
               theta_scheme: str | None = None, *, device="cuda", max_steps=None):
    """{"cd", "cd_sn", "l_r_d"} (with ``heated`` also "nu", "nu_rm"), as the
    JAX function returns, and the per-step "fx", "fy",
    "fz", "dt", "nusselt", the "coeff_scale" and the final "state"."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.validation import (
        sphere_drag_schiller_naumann,
        sphere_nusselt_ranz_marshall,
    )

    device = device_of(device)
    n = cells_per_d
    if heated:
        name = "heated_sphere_stretched" if stretched else "heated_sphere"
    else:
        name = "sphere_stretched" if stretched else "sphere"
    kw = {}
    if ibm_scheme != "penalize":
        kw["ibm_scheme"] = ibm_scheme
    if theta_scheme is not None:
        kw["theta_scheme"] = theta_scheme
    case = build(name, nx=16 * n, ny=8 * n, nz=8 * n, Re=re, domain=(16.0, 8.0, 8.0),
                 center=(4.0, 4.0, 4.0), ibm_ramp_steps=100, compute_metrics=True,
                 device=device, **kw)
    if stretched and verbose:
        print(f"  stretched grid: h_min={case.extras['h_min']:.4f} "
              f"({1 / case.extras['h_min']:.0f} cells/D near the body)")

    def probe(s, m):
        return _SphereProbe(m.fx, m.fy, m.fz, m.dt,
                            m.nusselt if heated else torch.zeros_like(m.dt))

    cs = case.extras["coeff_scale"]
    t0 = time.perf_counter()

    def progress(state, h):
        if verbose:
            el = time.perf_counter() - t0
            extra = f"  Nu={h['nusselt'][-1]:6.3f}" if heated else ""
            print(f"  t={float(state.t):6.2f}  Cd={h['fx'][-1] * cs:6.3f}  "
                  f"Cl_y={h['fy'][-1] * cs:+7.4f}  Cl_z={h['fz'][-1] * cs:+7.4f}{extra}  "
                  f"[{float(state.step) / el:6.1f} steps/s]", flush=True)

    state, h = run_probed(case, probe, chunk_steps, t_final, progress, max_steps=max_steps)
    cd = float(h["fx"][-1]) * cs if h else float("nan")
    nu_meas = float(h["nusselt"][-1]) if h else float("nan")

    cx, r = case.extras["center"][0], case.extras["radius"]
    l_r_d = recirculation_length(state.u.cpu().numpy(), face_x(case, stretched), cx, r)
    cd_sn = sphere_drag_schiller_naumann(re)
    if verbose:
        print(f"sphere Re={re:g} at {n} cells/D: Cd={cd:.3f} "
              f"(Schiller-Naumann {cd_sn:.3f}, {(cd / cd_sn - 1) * 100:+.1f}%)"
              f"  L_r/D={l_r_d:.2f} (J&P Re=100: 0.87)")
    out = {"cd": cd, "cd_sn": cd_sn, "l_r_d": l_r_d}
    if heated:
        nu_rm = sphere_nusselt_ranz_marshall(re)
        if verbose:
            print(f"  Nu={nu_meas:.3f} (Ranz-Marshall {nu_rm:.3f}, "
                  f"{(nu_meas / nu_rm - 1) * 100:+.1f}%)")
        out.update({"nu": nu_meas, "nu_rm": nu_rm})
    out.update(h, coeff_scale=cs, state=state)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--n", type=int, default=12,
                    help="cells per diameter (nominal for --stretched)")
    ap.add_argument("--t", type=float, default=40.0)
    ap.add_argument("--stretched", action="store_true",
                    help="body+wake-refined stretched grid "
                         "(~2.5x the near-body resolution per cell)")
    ap.add_argument("--heated", action="store_true",
                    help="isothermal sphere: forced-convection Nusselt "
                         "vs Ranz-Marshall (heated_sphere case)")
    ap.add_argument("--ibm", default="penalize", choices=["penalize", "ghost"],
                    help="IBM scheme (ghost = sharp-interface ghost-cell direct forcing)")
    ap.add_argument("--theta-scheme", default=None, choices=["upwind", "central", "tvd"],
                    help="θ face scheme for --heated (tvd = van Leer MUSCL)")
    ap.add_argument("--chunk-steps", type=int, default=100)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after the chunk that reaches this step")
    add_common_args(ap, "out/sphere_wake", render=False)
    a = ap.parse_args(argv)
    res = run_sphere(re=a.re, cells_per_d=a.n, t_final=a.t, chunk_steps=a.chunk_steps,
                     stretched=a.stretched, heated=a.heated, ibm_scheme=a.ibm,
                     theta_scheme=a.theta_scheme, device=a.device, max_steps=a.max_steps)
    state = res.pop("state")
    path = save_final_state(a.out, a.io, state)
    write_report(a.out, {"re": a.re, "cells_per_d": a.n, **res, "steps": int(state.step),
                         "t": float(state.t), "snapshots": path})
    return res


if __name__ == "__main__":
    main()
    sys.exit(0)
