"""Schäfer–Turek 2D-2 transient benchmark on the FEM tier
(``examples/schafer_turek_2d2.py`` of the JAX package).

Runs the ``schafer_turek_fem`` case (channel [0, 2.2]×[0, 0.41], D = 0.1
cylinder at (0.2, 0.2), Re = 100) to ``t_final`` and reports the published
quantities: the tail-mean Cd, the Strouhal number from the lift FFT and
from the lift's zero crossings, and the Cl amplitude. Published bands: Cd
3.22–3.24, St 0.295–0.305, Cl amplitude ≈ 1.0.

The FEM steps read each Krylov exit on the host, so a chunk is the loop of
``make_chunk``; fx, fy and the Poisson residual are stacked per step. Beyond
the JAX driver's arguments: ``--device``, ``--io`` (the final state's
sampled and nodal fields, native ``.csnap`` by default), ``--out`` and
``--chunk-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.schafer_turek_2d2 --scheme projection
--t 12 [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from cfdsim_tpu_torch.examples._common import add_common_args, device_of, write_report
from cfdsim_tpu_torch.examples.cylinder_fem import save_fem_state


def lift_statistics(cd, cl, dt: float, t_tail: float, diameter: float, u_mean: float) -> dict:
    """Over t > ``t_tail`` (t = dt·(1..n)): St from the dominant bin of the
    lift FFT and from the lift's zero crossings (NaN with fewer than three),
    the mean Cd and half the lift's range."""
    t = dt * np.arange(1, len(cd) + 1)
    tail = t > t_tail
    clt = cl[tail] - cl[tail].mean()
    spec = np.abs(np.fft.rfft(clt))
    freqs = np.fft.rfftfreq(len(clt), dt)
    f_fft = freqs[1:][np.argmax(spec[1:])]
    zc = np.where(np.diff(np.signbit(clt)))[0]
    f_zc = (0.5 * (len(zc) - 1) / (dt * (zc[-1] - zc[0])) if len(zc) > 2 else float("nan"))
    return {"cd": float(cd[tail].mean()), "st": float(f_fft * diameter / u_mean),
            "st_zc": float(f_zc * diameter / u_mean),
            "cl_amp": float(0.5 * (cl[tail].max() - cl[tail].min()))}


def run(scheme="projection", stab="bp", space="p1p1", h_near=0.0035, h_far=0.015,
        wake_refine=True, dt=0.002, t_final=12.0, t_tail=None, supg=0.0, chunk_steps=50,
        verbose=True, *, device="cuda"):
    """{"cd", "cd_inst", "st", "st_zc", "cl_amp", "n_tris"}, as the JAX
    function returns (None on a non-finite force), and the per-step
    "cd_series", "cl_series", "poisson_res", the final "state" and the
    "case"."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    device = device_of(device)
    case = build("schafer_turek_fem", re=100.0, space=space, scheme=scheme, stab=stab,
                 supg=supg, h_near=h_near, h_far=h_far, wake_refine=wake_refine, dt=dt,
                 theta=0.5, device=device)
    coeff = case.extras["coeff_scale"]
    n_tris = case.extras["mesh"].n_tris
    if verbose:
        print(f"mesh {n_tris} tris, scheme={scheme} stab={stab} space={space} dt={dt}")
    chunk = make_chunk(case.cfg, case.step, chunk_steps)
    state = case.state
    n_chunks = int(round(t_final / dt / chunk_steps))
    cd_h, cl_h, res_h = [], [], []
    t0 = time.perf_counter()
    for c in range(n_chunks):
        state, m = chunk(state, 1.0)
        cd_h.append(m.fx.cpu().numpy() * coeff)
        cl_h.append(m.fy.cpu().numpy() * coeff)
        res_h.append(m.poisson_res.cpu().numpy())
        if verbose and (c % 10 == 9 or c == n_chunks - 1):
            el = time.perf_counter() - t0
            print(f"  t={(c + 1) * chunk_steps * dt:6.2f}  Cd={cd_h[-1][-1]:6.3f}  "
                  f"Cl={cl_h[-1][-1]:+6.3f}  relres={float(res_h[-1][-1]):.1e}  "
                  f"[{(c + 1) * chunk_steps / el:5.2f} steps/s]", flush=True)
        if not np.isfinite(cd_h[-1][-1]):
            print("NON-FINITE force — aborting")
            return None

    cd = np.concatenate(cd_h)
    cl = np.concatenate(cl_h)
    if t_tail is None:
        t_tail = 0.5 * t_final
    s = lift_statistics(cd, cl, dt, t_tail, case.extras["diameter"], case.extras["u_mean"])
    print(f"\nRESULT {scheme}/{stab}/{space} {n_tris} tris t={t_final:g}: "
          f"Cd={s['cd']:.3f} (inst {cd[-1]:.3f})  "
          f"St={s['st']:.3f} (FFT) / {s['st_zc']:.3f} (ZC)  Cl_amp={s['cl_amp']:.3f}"
          f"  [bands: Cd 3.22-3.24, St 0.295-0.305, Cl ~1.0]")
    out = {"cd": s["cd"], "cd_inst": float(cd[-1]), "st": s["st"], "st_zc": s["st_zc"],
           "cl_amp": s["cl_amp"], "n_tris": n_tris}
    out.update(cd_series=cd, cl_series=cl, poisson_res=np.concatenate(res_h), state=state,
               case=case)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scheme", default="projection", choices=["projection", "monolithic"])
    p.add_argument("--stab", default="bp", choices=["bp", "pspg"])
    p.add_argument("--space", default="p1p1", choices=["p1p1", "p2p1"])
    p.add_argument("--h-near", type=float, default=0.0035)
    p.add_argument("--h-far", type=float, default=0.015)
    p.add_argument("--no-wake", action="store_true")
    p.add_argument("--dt", type=float, default=0.002)
    p.add_argument("--t", type=float, default=12.0)
    p.add_argument("--tail", type=float, default=None)
    p.add_argument("--supg", type=float, default=0.0)
    p.add_argument("--chunk-steps", type=int, default=50)
    add_common_args(p, "out/schafer_turek_2d2", render=False)
    a = p.parse_args(argv)
    res = run(scheme=a.scheme, stab=a.stab, space=a.space, h_near=a.h_near, h_far=a.h_far,
              wake_refine=not a.no_wake, dt=a.dt, t_final=a.t, t_tail=a.tail, supg=a.supg,
              chunk_steps=a.chunk_steps, device=a.device)
    if res is None:
        return None
    state, case = res.pop("state"), res.pop("case")
    path = save_fem_state(a.out, a.io, case, state)
    write_report(a.out, {"scheme": a.scheme, "stab": a.stab, "space": a.space, **res,
                         "steps": int(state.step), "t": float(state.t), "snapshots": path})
    return res


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
