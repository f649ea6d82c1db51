"""Re = 3900 sphere LES: the stretched-3D Smagorinsky production study
(``examples/sphere_les_re3900.py`` of the JAX package).

The subcritical-sphere benchmark (DNS: Rodriguez et al. 2011 Cd 0.394; LES:
Yun et al. 2006 Cd 0.355; experiments ~0.39-0.5) on the body- and
wake-refined stretched MAC tier with the local-Δ Smagorinsky model (or the
dynamic one), sharp-mask penalization (or the ghost-cell wall), TVD
convection and an inlet perturbation that trips the wake. It reports the
tail-mean Cd and three Strouhal numbers: from the lateral force, and from
the v spectrum of four wake probes (x = centre + ``probe_x``, offset
±``probe_r`` along y and z), summed and per probe.

The steps run in chunks of ``chunk_steps`` through ``make_chunk`` (one
captured CUDA graph on the card): the forces, dt, t and the four probes'
v (one gather at fixed cell indices) are stacked per step. With ``--save``
the series is written to ``<save>`` after every chunk and the state to
``<save>.state.npz`` every ``ckpt_every`` chunks, each atomically (a
temporary file, then ``os.replace``), in the JAX driver's keys (series: t,
cd, cly, clz, probe_v, probe_pts; state: u, v, w, p, t, step), so that a
checkpoint of either package resumes in the other. Unlike the JAX driver,
``--resume`` refuses a checkpoint whose series file is missing or whose
fields do not fit the grid, and a tail too short for the spectra gives NaN
frequencies instead of an error. Beyond the JAX driver's arguments:
``--device``, ``--io`` (the final state, native ``.csnap`` by default),
``--out``, ``--chunk-steps``, ``--ckpt-every`` and ``--max-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.sphere_les_re3900 --strength 12
--width 0.7 --t 400 [--save series.npz [--resume]] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import os
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

SERIES_KEYS = ("t", "cd", "cly", "clz", "probe_v")
STATE_KEYS = ("u", "v", "w", "p")


class _WakeProbe(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    fz: torch.Tensor
    dt: torch.Tensor
    t: torch.Tensor
    pv0: torch.Tensor
    pv1: torch.Tensor
    pv2: torch.Tensor
    pv3: torch.Tensor


def probe_cells(case, probe_x: float, probe_r: float):
    """The four probe points and the nearest (k, j, i) cell of each on the
    stretched grid (state arrays are (nz, ny, nx[+1]))."""
    xf, yf, zf = (case.extras[k] for k in ("x_faces", "y_faces", "z_faces"))
    xc_ = 0.5 * (xf[:-1] + xf[1:])
    yc_ = 0.5 * (yf[:-1] + yf[1:])
    zc_ = 0.5 * (zf[:-1] + zf[1:])
    cx, cy, cz = case.extras["center"]
    px = float(cx + probe_x)
    pts = [(px, cy + probe_r, cz), (px, cy - probe_r, cz),
           (px, cy, cz + probe_r), (px, cy, cz - probe_r)]
    idx = [(int(np.abs(zc_ - z).argmin()), int(np.abs(yc_ - y).argmin()),
            int(np.abs(xc_ - x).argmin())) for x, y, z in pts]
    return pts, idx


def load_checkpoint(save, state):
    """The state of ``<save>.state.npz`` and the series rows of ``<save>``
    up to its time. Raises where the series file is missing or a field's
    shape is not the grid's (the JAX driver loads both unchecked)."""
    ckpt_path = f"{save}.state.npz"
    if not os.path.exists(save):
        raise FileNotFoundError(f"checkpoint {ckpt_path} has no series file {save}: the "
                                "series would restart at t = 0 beside a resumed state")
    d = np.load(ckpt_path)
    for k in STATE_KEYS:
        want = tuple(getattr(state, k).shape)
        if d[k].shape != want:
            raise ValueError(f"checkpoint {ckpt_path}: {k} has shape {d[k].shape}, the grid's "
                             f"is {want}")
    dev = state.t.device
    state = state._replace(
        **{k: torch.as_tensor(d[k], dtype=torch.float32, device=dev) for k in STATE_KEYS},
        t=torch.tensor(float(d["t"]), dtype=torch.float32, device=dev),
        step=torch.tensor(int(d["step"]), dtype=torch.int32, device=dev))
    ser = np.load(save)
    keep = ser["t"] <= float(d["t"]) + 1e-6
    return state, {k: ser[k][keep] for k in SERIES_KEYS}


def wake_frequencies(t, cd, cly, clz, pv, t_tail: float) -> dict:
    """Tail statistics: the mean Cd after ``t_tail``; St of the lateral force
    (the dominant bin of |FFT(Cl_y)| + |FFT(Cl_z)| on a uniform resample);
    St of the four probes' summed v spectrum and of each probe, in the band
    0.05 < f < 1 (slow meandering excluded). A frequency whose tail has too
    few samples or no bin in the band is NaN."""
    tail = t > t_tail
    n = int(tail.sum())
    nan = float("nan")
    cd_mean = float(cd[tail].mean()) if n else nan
    if n < 3:
        return {"cd_mean": cd_mean, "st": nan, "st_wake": nan, "st_probe": [nan] * pv.shape[1]}
    tu = np.linspace(t[tail][0], t[tail][-1], n)
    sy = np.abs(np.fft.rfft(np.interp(tu, t[tail], cly[tail]) - cly[tail].mean()))
    sz = np.abs(np.fft.rfft(np.interp(tu, t[tail], clz[tail]) - clz[tail].mean()))
    freqs = np.fft.rfftfreq(len(tu), tu[1] - tu[0])
    st = float(freqs[1:][np.argmax((sy + sz)[1:])])  # D = U = 1
    band = (freqs > 0.05) & (freqs < 1.0)
    if not band.any():
        return {"cd_mean": cd_mean, "st": st, "st_wake": nan, "st_probe": [nan] * pv.shape[1]}
    spec_sum = np.zeros(band.sum())
    st_probe = []
    for p in range(pv.shape[1]):
        s_ = np.abs(np.fft.rfft(np.interp(tu, t[tail], pv[tail, p]) - pv[tail, p].mean()))
        st_probe.append(float(freqs[band][np.argmax(s_[band])]))
        spec_sum += s_[band]
    return {"cd_mean": cd_mean, "st": st, "st_wake": float(freqs[band][np.argmax(spec_sum)]),
            "st_probe": st_probe}


def run(nx=320, ny=160, nz=160, strength=12.0, width=0.7, t_final=400.0, t_tail=160.0,
        chunk_steps=200, perturb=0.02, cs=0.17, ibm_scheme="penalize", re=3900.0,
        use_les=True, verbose=True, probe_x=2.0, probe_r=0.6, save=None,
        les_model="smagorinsky", resume=False, ckpt_every=5, *, device="cuda",
        max_steps=None):
    """{"cells_per_d", "cd_mean", "st", "st_wake", "st_probe", "t", "cd",
    "probe_v"}, as the JAX function returns (None on a non-finite force),
    and "cly", "clz", "dt" and the final "state"."""
    from cfdsim_tpu_torch.cases import build

    device = device_of(device)
    case = build(
        "sphere_stretched", nx=nx, ny=ny, nz=nz, Re=re,
        domain=(16.0, 8.0, 8.0), center=(4.0, 4.0, 4.0),
        refine_strength=strength, refine_width=width,
        scheme="tvd", ibm_profile="sharp", ibm_scheme=ibm_scheme, perturb=perturb,
        ibm_ramp_steps=200, use_les=use_les, smagorinsky_constant=cs, les_model=les_model,
        compute_metrics=True, device=device,
    )
    h_min = case.extras["h_min"]
    if verbose:
        print(f"grid {nx}x{ny}x{nz} ({nx * ny * nz / 1e6:.1f}M cells), "
              f"h_min={h_min:.5f} -> {1 / h_min:.0f} cells/D near-body")
    pts, idx = probe_cells(case, probe_x, probe_r)
    kk, jj, ii = (torch.tensor(c, dtype=torch.int64, device=device) for c in zip(*idx))

    def probe(s, m):
        # v at the probe cells (the lateral velocity carries the shedding)
        return _WakeProbe(m.fx, m.fy, m.fz, m.dt, s.t, *s.v[kk, jj, ii].unbind())

    coeff = case.extras["coeff_scale"]
    state = case.state
    hist = {k: [] for k in SERIES_KEYS}
    ckpt_path = f"{save}.state.npz" if save else None
    if resume and ckpt_path and os.path.exists(ckpt_path):
        state, kept = load_checkpoint(save, state)
        for k in SERIES_KEYS:
            hist[k].append(kept[k])
        print(f"resumed from {ckpt_path} at t={float(state.t):.2f} "
              f"({len(kept['t'])} series rows kept)", flush=True)
    step0 = int(state.step)
    chunks_done = 0
    t0 = time.perf_counter()
    dts = []

    def on_chunk(s, h):
        nonlocal chunks_done
        hist["t"].append(h["t"])
        hist["cd"].append(h["fx"] * coeff)
        hist["cly"].append(h["fy"] * coeff)
        hist["clz"].append(h["fz"] * coeff)
        hist["probe_v"].append(np.stack([h[f"pv{p}"] for p in range(4)], axis=1))
        dts.append(h["dt"])
        if verbose:
            el = time.perf_counter() - t0
            print(f"  t={float(s.t):7.2f}  Cd={hist['cd'][-1][-1]:6.3f}  "
                  f"Cl=({hist['cly'][-1][-1]:+6.3f},{hist['clz'][-1][-1]:+6.3f})  "
                  f"[{(float(s.step) - step0) / el:6.1f} steps/s, {el / 60:5.1f} min]",
                  flush=True)
        if not np.isfinite(hist["cd"][-1][-1]):
            raise FloatingPointError
        if save:
            atomic_savez(save, **{k: np.concatenate(v) for k, v in hist.items()},
                         probe_pts=np.asarray(pts))
            chunks_done += 1
            if ckpt_every and chunks_done % ckpt_every == 0:
                atomic_savez(ckpt_path, **{k: getattr(s, k).cpu().numpy() for k in STATE_KEYS},
                             t=float(s.t), step=int(s.step))

    try:
        state, _ = run_probed(case, probe, chunk_steps, t_final, on_chunk, state=state,
                              max_steps=max_steps)
    except FloatingPointError:
        print("NON-FINITE force — aborting")
        return None

    series = {k: (np.concatenate(v) if v else np.zeros((0, 4) if k == "probe_v" else 0))
              for k, v in hist.items()}
    t, cd, cly, clz, pv = (series[k] for k in SERIES_KEYS)
    freq = wake_frequencies(t, cd, cly, clz, pv, t_tail)
    if save:
        atomic_savez(save, **series, probe_pts=np.asarray(pts))
        print(f"series saved to {save}")
    tail = t > t_tail
    rms = ((float(cly[tail].std()), float(clz[tail].std())) if tail.any()
           else (float("nan"), float("nan")))
    print(f"\nRESULT Re={re:g} cells/D={1 / h_min:.0f}  "
          f"Cd_mean(t>{t_tail:.0f})={freq['cd_mean']:.4f}"
          + (f"  (DNS 0.394: {100 * (freq['cd_mean'] / 0.394 - 1):+.1f}%)"
             if re == 3900.0 else "")
          + f"  St_lat={freq['st']:.4f}  St_wake={freq['st_wake']:.4f} "
          f"(per-probe {', '.join(f'{s_:.3f}' for s_ in freq['st_probe'])})  "
          f"Cl_rms=({rms[0]:.4f},{rms[1]:.4f})")
    out = {"cells_per_d": 1 / h_min, **freq, "t": t, "cd": cd, "probe_v": pv}
    out.update(cly=cly, clz=clz, dt=np.concatenate(dts) if dts else np.zeros(0), state=state)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=320)
    p.add_argument("--ny", type=int, default=160)
    p.add_argument("--nz", type=int, default=160)
    p.add_argument("--strength", type=float, default=12.0)
    p.add_argument("--width", type=float, default=0.7)
    p.add_argument("--t", type=float, default=400.0)
    p.add_argument("--tail", type=float, default=160.0)
    p.add_argument("--perturb", type=float, default=0.02)
    p.add_argument("--cs", type=float, default=0.17)
    p.add_argument("--ibm", default="penalize", choices=["penalize", "ghost"],
                   help="ghost = sharp-interface ghost-cell direct forcing")
    p.add_argument("--re", type=float, default=3900.0)
    p.add_argument("--no-les", action="store_true",
                   help="laminar/DNS mode (e.g. the Re=300 hairpin rows)")
    p.add_argument("--probe-x", type=float, default=2.0,
                   help="probe plane distance downstream of the centre (x/D)")
    p.add_argument("--probe-r", type=float, default=0.6,
                   help="probe lateral offset from the wake axis (r/D)")
    p.add_argument("--save", default=None,
                   help="write the force + probe time series to this .npz")
    p.add_argument("--les-model", default="smagorinsky", choices=["smagorinsky", "dynamic"])
    p.add_argument("--resume", action="store_true",
                   help="continue from <save>.state.npz if present")
    p.add_argument("--chunk-steps", type=int, default=200)
    p.add_argument("--ckpt-every", type=int, default=5,
                   help="chunks between state checkpoints (with --save)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after the chunk that reaches this step")
    add_common_args(p, "out/sphere_les_re3900", render=False)
    a = p.parse_args(argv)
    if a.resume and not a.save:
        p.error("--resume needs --save")
    res = run(nx=a.nx, ny=a.ny, nz=a.nz, strength=a.strength, width=a.width, t_final=a.t,
              t_tail=a.tail, chunk_steps=a.chunk_steps, perturb=a.perturb, cs=a.cs,
              ibm_scheme=a.ibm, re=a.re, use_les=not a.no_les, probe_x=a.probe_x,
              probe_r=a.probe_r, save=a.save, les_model=a.les_model, resume=a.resume,
              ckpt_every=a.ckpt_every, device=a.device, max_steps=a.max_steps)
    if res is None:
        return None
    state = res.pop("state")
    path = save_final_state(a.out, a.io, state)
    write_report(a.out, {**res, "steps": int(state.step), "final_t": float(state.t),
                         "snapshots": path})
    return res


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
