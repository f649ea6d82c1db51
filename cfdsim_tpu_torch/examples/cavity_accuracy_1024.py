"""1024² Re = 1000 MAC cavity against Botella & Peyret: the accuracy north
star (``examples/cavity_accuracy_1024.py`` of the JAX package).

Runs the staggered cavity and reports the three centreline-extremum errors
(u_min, v_max, v_min against the spectral values) every 25 time units, so
that the temporal-convergence error can be told from the float32 floor
(the JAX package measured 1.246e-4 at t = 500 with the incremental
projection; at clean 2nd order from 4.3e-4 at 512², the discretization
error at 1024² is ~1.1e-4).

The steps run in chunks of 5000 through ``make_chunk`` (one CUDA graph of
10 steps replayed on the card). At the end the state goes to ``out.npz``
(keys u, v, p, t, step, the JAX driver's) and ``--resume`` reads such a
file back, from either package. Only float32 storage is ported; the JAX
driver's compilation cache has no counterpart. Beyond the JAX driver's
positional ``[n] [t_end] [out.npz] [projection] [resume] [storage]``:
``--device``, ``--io`` (the final state, native ``.csnap`` by default),
``--out`` (the report's and snapshot's directory), ``--chunk-steps``,
``--report-every`` and ``--max-steps``.

Run: ``python -m cfdsim_tpu_torch.examples.cavity_accuracy_1024 1024 500
out/cavity_acc_1024.npz incremental [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    device_of,
    save_final_state,
    write_report,
)

STATE_KEYS = ("u", "v", "p")


def extrema_errors(s, n):
    """The Botella–Peyret errors of the state's centreline extrema: u on
    the vertical centreline (x faces at i = n/2), v on the horizontal one."""
    from cfdsim_tpu_torch.validation import botella_peyret_errors

    u, v = (np.asarray(f.cpu() if torch.is_tensor(f) else f, np.float32) for f in (s.u, s.v))
    u_c = u[:, n // 2]
    y_u = (np.arange(n) + 0.5) / n
    v_c = v[n // 2, :]
    x_v = (np.arange(n) + 0.5) / n
    return botella_peyret_errors(u_c, y_u, v_c, x_v)


def load_npz(path, state):
    """``state`` with u, v, p, t, step from the npz at ``path`` (either
    package's); a field whose shape is not the grid's raises."""
    d = np.load(path)
    for k in STATE_KEYS:
        if d[k].shape != tuple(getattr(state, k).shape):
            raise ValueError(f"{path}: {k} has shape {d[k].shape}, the grid's is "
                             f"{tuple(getattr(state, k).shape)}")
    dev = state.t.device
    return state._replace(
        **{k: torch.as_tensor(d[k], dtype=torch.float32, device=dev) for k in STATE_KEYS},
        t=torch.tensor(float(d["t"]), dtype=torch.float32, device=dev),
        step=torch.tensor(int(d["step"]), dtype=torch.int32, device=dev))


def save_npz(path, s) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: getattr(s, k).cpu().numpy() for k in STATE_KEYS}, t=float(s.t),
             step=int(s.step))
    return path


def run(n=1024, t_end=400.0, out=None, projection="chorin", resume=None, storage="fp32", *,
        device="cuda", chunk_steps=5000, report_every=25.0, max_steps=None):
    """(state, final errors, the rows reported on the way {t, wall_s, errors},
    the npz path)."""
    from cfdsim_tpu_torch.cases import lid_cavity_mac
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    if storage != "fp32":
        raise NotImplementedError(f"storage={storage!r}: only 'fp32' is ported (the JAX "
                                  "package measured bf16 storage and rejected it)")
    device = device_of(device)
    out = Path(out if out is not None else f"out/cavity_acc_{n}.npz")
    case = lid_cavity_mac(n=n, Re=1000.0, projection=projection, device=device)
    chunk = make_chunk(case.cfg, case.step, chunk_steps)
    s = case.state
    if resume:
        s = load_npz(resume, s)
        print(f"resumed from {resume} at t={float(s.t):.1f}", flush=True)
    t0 = time.time()
    next_report = float(s.t) + report_every
    rows = []
    while float(s.t) < t_end and (max_steps is None or int(s.step) < max_steps):
        s, _ = chunk(s, 1.0)
        t = float(s.t)
        if t >= next_report:
            errs = extrema_errors(s, n)
            rows.append({"t": t, "wall_s": time.time() - t0, **errs})
            print(f"t={t:8.2f}  wall={time.time() - t0:7.1f}s  "
                  f"u_min={errs['u_min']:.3e}  v_max={errs['v_max']:.3e}  "
                  f"v_min={errs['v_min']:.3e}  max={max(errs.values()):.3e}", flush=True)
            next_report += report_every
    errs = extrema_errors(s, n)
    print(f"FINAL t={float(s.t):.2f} step={int(s.step)} "
          f"max_err={max(errs.values()):.4e} {errs}", flush=True)
    path = save_npz(out, s)
    print(f"saved {path}", flush=True)
    return s, errs, rows, path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=1024)
    ap.add_argument("t_end", nargs="?", type=float, default=400.0)
    ap.add_argument("npz", nargs="?", default=None,
                    help="the final state's npz (default out/cavity_acc_<n>.npz)")
    ap.add_argument("projection", nargs="?", default="chorin", choices=["chorin", "incremental"])
    ap.add_argument("resume", nargs="?", default=None, help="an npz to resume from")
    ap.add_argument("storage", nargs="?", default="fp32", help="fp32 (the only one ported)")
    ap.add_argument("--chunk-steps", type=int, default=5000)
    ap.add_argument("--report-every", type=float, default=25.0)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after the chunk that reaches this step")
    add_common_args(ap, "out/cavity_accuracy_1024", render=False)
    a = ap.parse_args(argv)
    s, errs, rows, npz = run(a.n, a.t_end, a.npz, a.projection, a.resume or None, a.storage,
                             device=a.device, chunk_steps=a.chunk_steps,
                             report_every=a.report_every, max_steps=a.max_steps)
    path = save_final_state(a.out, a.io, s)
    rep = {"n": a.n, "projection": a.projection, "t": float(s.t), "step": int(s.step),
           "errors": errs, "max_err": max(errs.values()), "reports": rows, "npz": npz,
           "snapshots": path}
    write_report(a.out, rep)
    return rep


if __name__ == "__main__":
    main()
    sys.exit(0)
