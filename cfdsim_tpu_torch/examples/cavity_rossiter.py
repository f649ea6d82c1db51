"""Rossiter feedback modes of the Mach-2.5 open cavity, L/D = 2
(``examples/cavity_rossiter.py`` of the JAX package).

The reference's supersonic-cavity flagship (cavity_flow_v1.py:38-87:
600×180, NG = 2, M = 2.5, CFL 0.3) validated quantitatively: pressure
probes in and around the cavity, a Hann-windowed tail PSD, and the tone
frequencies against the semi-empirical Rossiter formula

    St_m = f_m L / U_inf = (m − γ_r) / (M + 1/κ),   κ ≈ 0.57, γ_r ≈ 0.25,

and its Heller–Bliss correction (M → M / sqrt(1 + (γ−1)/2 M²)). At M = 2.5:
Rossiter St_1..3 = 0.176, 0.411, 0.646; Heller 0.219, 0.512, 0.804.

Probes (cavity x in [0.5, 1.0], depth 0.25): 0, the aft wall at mid-depth
(0.98, 0.12); 1, the floor (0.95, 0.02); 2, above the trailing lip (1.00,
0.30), the one that means something in the pin-state geometry too.

The steps run in chunks of ``chunk_steps`` through ``make_chunk`` (one
captured CUDA graph on the card): t, dt, the three probes' p (from the
conservative state, at fixed cells), min ρ and min p are stacked per step; a
non-finite probe or a non-positive density aborts the run. Beyond the JAX
driver's arguments: ``--device``, ``--io`` (the final state, native
``.csnap`` by default), ``--out``, ``--chunk-steps`` and ``--max-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.cavity_rossiter --t 60
[--geometry real|pin] [--flux rusanov|hllc|roe] [--save series.npz] [--device cuda]``.
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
    atomic_savez,
    device_of,
    run_probed,
    save_final_state,
    write_report,
)

KAPPA = 0.57
GAMMA_R = 0.25
PROBES = [(0.98, 0.12), (0.95, 0.02), (1.00, 0.30)]


class _CavityProbe(NamedTuple):
    t: torch.Tensor
    dt: torch.Tensor
    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    min_rho: torch.Tensor
    min_p: torch.Tensor


def rossiter_modes(mach, gamma=1.4, n_modes=3, heller=False):
    """Predicted Strouhal numbers St_m = f_m L/U for modes m = 1..n."""
    m_eff = mach / np.sqrt(1 + 0.5 * (gamma - 1) * mach**2) if heller else mach
    return np.array([(m - GAMMA_R) / (m_eff + 1.0 / KAPPA) for m in range(1, n_modes + 1)])


def tail_psd(t, p, t_tail: float, L: float, U_inf: float, mach: float,
             real_geometry: bool) -> dict:
    """The Hann-windowed PSD of each probe over t > ``t_tail`` (uniform
    resample) on the St_L axis; the mode table (per Rossiter mode, the
    tallest peak within ±25% of the two predictions, a band of fewer than 3
    bins skipped: rows (m, St, Rossiter, Heller, error % to each)) and the
    five tallest local maxima with 0.05 < St < 1.5, of probe 0 (probe 2 in
    the pin geometry)."""
    tail = t > t_tail
    tu = np.linspace(t[tail][0], t[tail][-1], int(tail.sum()))
    n = len(tu)
    win = np.hanning(n)
    freqs = np.fft.rfftfreq(n, tu[1] - tu[0])
    st_axis = freqs * L / U_inf
    psd = np.zeros((p.shape[1], len(freqs)))
    for k in range(p.shape[1]):
        sig = np.interp(tu, t[tail], p[tail, k])
        psd[k] = np.abs(np.fft.rfft((sig - sig.mean()) * win)) ** 2

    ross = rossiter_modes(mach)
    hell = rossiter_modes(mach, heller=True)
    probe_for_mode = 2 if not real_geometry else 0
    rows = []
    for m, (sr, sh) in enumerate(zip(ross, hell), start=1):
        lo, hi = 0.75 * min(sr, sh), 1.25 * max(sr, sh)
        band = (st_axis >= lo) & (st_axis <= hi)
        if band.sum() < 3:
            continue
        st_meas = float(st_axis[band][np.argmax(psd[probe_for_mode][band])])
        rows.append((m, st_meas, sr, sh, 100 * (st_meas / sr - 1), 100 * (st_meas / sh - 1)))

    s = psd[probe_for_mode]
    interior = (st_axis > 0.05) & (st_axis < 1.5)
    locmax = np.r_[False, (s[1:-1] > s[:-2]) & (s[1:-1] > s[2:]), False]
    cand = np.where(locmax & interior)[0]
    top = cand[np.argsort(s[cand])[::-1][:5]]
    peaks = sorted(float(st_axis[i]) for i in top)
    return {"st_axis": st_axis, "psd": psd, "rows": rows, "peaks": peaks,
            "probe_for_mode": probe_for_mode, "rossiter": ross, "heller": hell}


def run(nx=600, ny=180, mach=2.5, t_final=60.0, t_tail=10.0, chunk_steps=2000,
        real_geometry=True, save=None, verbose=True, *, device="cuda", max_steps=None,
        **case_kw):
    """{"t", "p", "st_axis", "psd", "rows", "peaks"}, as the JAX function
    returns (None on a non-finite state), and "dt",
    "min_rho", "min_p" per step and the final "state"."""
    from cfdsim_tpu_torch.cases import build

    device = device_of(device)
    case = build("cavity_supersonic", nx=nx, ny=ny, mach=mach, real_geometry=real_geometry,
                 device=device, **case_kw)
    cfg, grid = case.cfg, case.grid
    L = 0.5  # cavity length (case default)
    U_inf = float(case.extras["U_inf"][1] / case.extras["U_inf"][0])
    xs, ys = grid.x_coords(), grid.y_coords()
    idx = [(int(np.abs(ys - y).argmin()), int(np.abs(xs - x).argmin())) for x, y in PROBES]
    jj, ii = (torch.tensor(c, dtype=torch.int64, device=device) for c in zip(*idx))

    def probe(s, m):
        U = s.U[:, jj, ii]  # the four conservative variables at the probe cells
        g = cfg.gamma
        p = (g - 1.0) * (U[3] - 0.5 * (U[1] ** 2 + U[2] ** 2) / torch.clamp(U[0], min=cfg.eps))
        return _CavityProbe(s.t, m.dt, *p.unbind(), m.min_rho, m.min_p)

    hist_t, hist_p = [], []
    t0 = time.perf_counter()

    def on_chunk(state, h):
        hist_t.append(h["t"])
        hist_p.append(np.stack([h["p0"], h["p1"], h["p2"]], axis=1))
        if not (np.isfinite(hist_p[-1][-1]).all() and float(h["min_rho"][-1]) > 0):
            raise FloatingPointError
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):7.2f}  p_aft={hist_p[-1][-1][0]:7.3f}"
                  f"  p_lip={hist_p[-1][-1][2]:7.3f}"
                  f"  [{float(state.step) / el:7.0f} steps/s]", flush=True)
        if save:
            atomic_savez(save, t=np.concatenate(hist_t), p=np.concatenate(hist_p),
                         probe_pts=np.asarray(PROBES))

    try:
        state, h = run_probed(case, probe, chunk_steps, t_final, on_chunk, max_steps=max_steps)
    except FloatingPointError:
        print("NON-FINITE state — aborting")
        return None
    t = np.concatenate(hist_t)
    p = np.concatenate(hist_p)  # (n_steps, 3)
    a = tail_psd(t, p, t_tail, L, U_inf, mach, real_geometry)
    geom = "real" if real_geometry else "pin"
    k = a["probe_for_mode"]
    print(f"\nRESULT cavity_rossiter M={mach:g} L/D=2 {nx}x{ny} geometry={geom} "
          f"t={t_final:g} (tail t>{t_tail:g}, probe {k} at {PROBES[k]})")
    print(f"  dominant PSD peaks (St_L): {', '.join(f'{q:.3f}' for q in a['peaks'])}")
    print("  mode |  measured | Rossiter (err) | Heller (err)")
    for m, st_meas, sr, sh, er, eh in a["rows"]:
        print(f"   {m}   |   {st_meas:.3f}   |  {sr:.3f} ({er:+5.1f}%) |"
              f"  {sh:.3f} ({eh:+5.1f}%)")
    if save:
        atomic_savez(save, t=t, p=p, probe_pts=np.asarray(PROBES), st_axis=a["st_axis"],
                     psd=a["psd"], rossiter=a["rossiter"], heller=a["heller"])
        print(f"series saved to {save}")
    out = {"t": t, "p": p, "st_axis": a["st_axis"], "psd": a["psd"], "rows": a["rows"],
           "peaks": a["peaks"]}
    out.update(dt=h["dt"], min_rho=h["min_rho"], min_p=h["min_p"], state=state)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=600)
    ap.add_argument("--ny", type=int, default=180)
    ap.add_argument("--mach", type=float, default=2.5)
    ap.add_argument("--t", type=float, default=60.0)
    ap.add_argument("--tail", type=float, default=10.0)
    ap.add_argument("--geometry", default="real", choices=["real", "pin"])
    ap.add_argument("--save", default=None)
    ap.add_argument("--flux", default="rusanov", choices=["rusanov", "hllc", "roe"],
                    help="rusanov = reference parity; hllc resolves the cavity shear layer")
    ap.add_argument("--av", type=float, default=1e-3,
                    help="artificial viscosity (reference default 1e-3)")
    ap.add_argument("--chunk-steps", type=int, default=2000)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after the chunk that reaches this step")
    add_common_args(ap, "out/cavity_rossiter", render=False)
    a = ap.parse_args(argv)
    res = run(nx=a.nx, ny=a.ny, mach=a.mach, t_final=a.t, t_tail=a.tail,
              chunk_steps=a.chunk_steps, real_geometry=(a.geometry == "real"), save=a.save,
              device=a.device, max_steps=a.max_steps, flux=a.flux,
              artificial_viscosity=a.av)
    if res is None:
        return None
    state = res.pop("state")
    path = save_final_state(a.out, a.io, state)
    write_report(a.out, {"mach": a.mach, "geometry": a.geometry, **res,
                         "steps": int(state.step), "final_t": float(state.t),
                         "snapshots": path})
    return res


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
