"""Unstructured-FEM cylinder flow (``examples/cylinder_fem.py`` of the JAX
package): the reference's Julia/Gridap driver (v2.jl:373-439
``run_efficient_simulation``) on the FEM tier.

Per Re: graded mesh → steady Stokes start → semi-implicit NS steps in
chunks → sampled-field frames, plus what the reference never computed: the
reaction-force drag and lift histories and a Strouhal number from the lift
oscillation. ``--schafer-turek`` runs the 2D-2 benchmark instead.

The FEM steps read each Krylov exit on the host, so a chunk is the loop of
``make_chunk`` (each solver's iterations are CUDA graphs on the card). The
frames are the fields sampled onto the case's grid (u, v, p, speed,
vorticity, and the nodal fields that restore the state) after every
``frame_every``-th chunk, written to ``<out>/Re_<re>/snapshots.csnap`` (or
``.h5``); PNG frames and a video are rendered from them only with
``--render``, which needs matplotlib. Beyond the JAX driver's arguments:
``--device``, ``--io``, ``--render``, ``--chunk-steps``, ``--n-frames`` and
``--h-near``/``--h-far`` (the mesh; default the case's).

Run: ``python -m cfdsim_tpu_torch.examples.cylinder_fem [Re ...] [--t-final T]
[--space p1p1|p2p1] [--schafer-turek] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    close_writer,
    device_of,
    snapshot_writer,
    write_report,
)


def _frame_fields(case, state) -> dict:
    """The state sampled onto the case's grid (u, v, p, vorticity), its
    speed and its nodal fields, as a snapshot's fields."""
    from cfdsim_tpu_torch.fem.sample import snapshot_fields

    return snapshot_fields(case.extras["sampler"], state,
                           sampled=("u", "v", "p", "vorticity", "speed"))


def save_fem_state(out, io: str, case, state) -> Path:
    """Write the state's frame fields (:func:`_frame_fields`) at its step
    and time into ``<out>/snapshots.csnap`` (or ``.h5``); returns the path."""
    writer, path = snapshot_writer(out, io)
    try:
        writer.save(int(state.step), float(state.t), **_frame_fields(case, state))
    finally:
        close_writer(writer)
    return path


def run_re(re, t_final=150.0, space="p1p1", wake_refine=True, out_dir=None, n_frames=40,
           chunk_steps=50, verbose=True, *, device="cuda", io="native", render=False,
           **case_kw):
    """{"St", "Cd", "Cl_amp", "fx", "fy", "state", "case"}, as the JAX
    function returns, the per-step "poisson_res" (the solve's relative
    residual: a step above ``cfg.accept_relres`` keeps its previous state)
    and, with ``out_dir``, "snapshots": the frames' file."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    device = device_of(device)
    case = build("cylinder_fem", re=re, space=space, wake_refine=wake_refine, device=device,
                 **case_kw)
    ops = case.extras["ops"]
    if verbose:
        print(f"Re={re}: mesh {case.extras['mesh'].n_tris} tris, "
              f"{ops.n_u} velocity nodes ({space})")

    chunk = make_chunk(case.cfg, case.step, chunk_steps)
    state = case.state
    n_chunks = int(round(t_final / case.cfg.dt / chunk_steps))
    frame_every = max(1, n_chunks // max(n_frames, 1))
    writer = path = None
    if out_dir is not None:
        out_dir = Path(out_dir) / f"Re_{int(re)}"
        writer, path = snapshot_writer(out_dir, io)
    fx_hist, fy_hist, res_hist, frames = [], [], [], []
    t0 = time.perf_counter()
    try:
        for ci in range(n_chunks):
            state, m = chunk(state, 1.0)
            fx_hist.append(m.fx.cpu().numpy())
            fy_hist.append(m.fy.cpu().numpy())
            res_hist.append(m.poisson_res.cpu().numpy())
            if writer is not None and ci % frame_every == 0:
                f = _frame_fields(case, state)
                writer.save(int(state.step), float(state.t), **f)
                if render:
                    frames.append((float(state.t), {k: f[k].cpu().numpy()
                                                    for k in ("speed", "vorticity")}))
            if verbose and (ci + 1) % max(1, n_chunks // 10) == 0:
                el = time.perf_counter() - t0
                print(f"  t={float(state.t):7.2f}  Cd={2 * fx_hist[-1][-1]:6.3f} "
                      f"Cl={2 * fy_hist[-1][-1]:+6.3f}  "
                      f"[{(ci + 1) * chunk_steps / el:6.1f} steps/s]", flush=True)
    finally:
        if writer is not None:
            close_writer(writer)

    fx = np.concatenate(fx_hist) if fx_hist else np.zeros(0, np.float32)
    fy = np.concatenate(fy_hist) if fy_hist else np.zeros(0, np.float32)
    res = np.concatenate(res_hist) if res_hist else np.zeros(0, np.float32)
    st, cd_mean, cl_amp = shedding_stats(fx, fy, case.cfg.dt)
    if verbose:
        print(f"Re={re}: St={st:.3f}  mean Cd={cd_mean:.3f}  Cl amplitude={cl_amp:.3f}")
    if render and out_dir is not None:
        save_frames(frames, case, out_dir, verbose)
    return {"St": st, "Cd": cd_mean, "Cl_amp": cl_amp, "fx": fx, "fy": fy, "poisson_res": res,
            "state": state, "case": case, "snapshots": path}


def shedding_stats(fx, fy, dt, tail_frac=0.5):
    """Strouhal from the dominant lift-oscillation frequency (f·D/V∞,
    D = V∞ = 1), the mean drag coefficient and the lift amplitude, over the
    tail of the run (shedding established)."""
    n = len(fy)
    tail = slice(int(n * tail_frac), n)
    cl = 2.0 * fy[tail]
    cd = 2.0 * fx[tail]
    cl0 = cl - cl.mean()
    spec = np.abs(np.fft.rfft(cl0 * np.hanning(len(cl0))))
    freqs = np.fft.rfftfreq(len(cl0), d=dt)
    st = float(freqs[np.argmax(spec)])
    return st, float(cd.mean()), float(np.abs(cl0).max())


def save_frames(frames, case, out_dir, verbose=True):
    """Vorticity and speed PNGs of each frame, with the body drawn, and a
    video of each (matplotlib; the video through ``viz.video.make_video``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches

    from cfdsim_tpu_torch.viz.video import make_video

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    g = case.grid
    X, Y = np.meshgrid(g.x_coords(), g.y_coords())
    geo = case.extras["mesh"].geometry
    for i, (t, f) in enumerate(frames):
        for name, cmap, data, lim in (("vorticity", "plasma", f["vorticity"], 2.0),
                                      ("velocity", "viridis", f["speed"], None)):
            fig, ax = plt.subplots(figsize=(8, 5), dpi=100)
            if lim:
                scale = np.nanquantile(np.abs(data), 0.9) + 1e-9
                ax.pcolormesh(X, Y, np.clip(data / scale, -lim, lim), cmap=cmap, vmin=-lim,
                              vmax=lim)
            else:
                ax.pcolormesh(X, Y, data, cmap=cmap, vmin=0, vmax=1.5)
            ax.add_patch(patches.Circle(geo["cylinder_center"], geo["cylinder_radius"],
                                        facecolor="black", edgecolor="white"))
            ax.set_aspect("equal")
            ax.set_title(f"{name}, t={t:.1f}")
            fig.savefig(out_dir / f"{name}_{i:04d}.png", bbox_inches="tight")
            plt.close(fig)
    for name in ("vorticity", "velocity"):
        make_video(out_dir, out_dir / f"{name}.mp4", pattern=f"{name}_*.png", fps=10)
    if verbose:
        print(f"frames + video in {out_dir}")


def run_schafer_turek(t_final=8.0, space="p1p1", chunk_steps=100, verbose=True, *,
                      device="cuda", **case_kw):
    """Schäfer–Turek 2D-2 (published at Re = 100: Cd ≈ 3.22–3.24, Cl
    amplitude ≈ 1.0, St ≈ 0.295–0.305): {"St", "Cd", "Cl_amp", "fx", "fy",
    "state", "case"}, as the JAX function returns."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    device = device_of(device)
    case = build("schafer_turek_fem", space=space, device=device, **case_kw)
    scale = case.extras["coeff_scale"]
    if verbose:
        print(f"S-T 2D-2: mesh {case.extras['mesh'].n_tris} tris, "
              f"{case.extras['ops'].n_u} velocity nodes")
    chunk = make_chunk(case.cfg, case.step, chunk_steps)
    state = case.state
    n_chunks = int(round(t_final / case.cfg.dt / chunk_steps))
    fx_hist, fy_hist = [], []
    t0 = time.perf_counter()
    for ci in range(n_chunks):
        state, m = chunk(state, 1.0)
        fx_hist.append(m.fx.cpu().numpy())
        fy_hist.append(m.fy.cpu().numpy())
        if verbose and (ci + 1) % max(1, n_chunks // 16) == 0:
            el = time.perf_counter() - t0
            cl = scale * fy_hist[-1]
            # the chunk's lift range, not one sample: a shedding period that
            # divides the print interval aliases single samples into constants
            print(f"  t={float(state.t):6.3f}  Cd={scale * fx_hist[-1][-1]:6.3f} "
                  f"Cl=[{cl.min():+6.3f},{cl.max():+6.3f}]  "
                  f"[{(ci + 1) * chunk_steps / el:6.1f} steps/s]", flush=True)
    fx = np.concatenate(fx_hist) * scale / 2.0  # shedding_stats doubles them again
    fy = np.concatenate(fy_hist) * scale / 2.0
    # St = f·D/ū with D = 0.1, ū = 1
    st_raw, cd_mean, cl_amp = shedding_stats(fx, fy, case.cfg.dt)
    st = st_raw * case.extras["diameter"] / case.extras["u_mean"]
    if verbose:
        print(f"S-T 2D-2: St={st:.3f} (target 0.295-0.305)  Cd={cd_mean:.3f} (target "
              f"3.22-3.24)  Cl_amp={cl_amp:.3f} (target ~1.0)")
    return {"St": st, "Cd": cd_mean, "Cl_amp": cl_amp, "fx": fx, "fy": fy, "state": state,
            "case": case}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("re", nargs="*", type=float, default=[100.0])
    ap.add_argument("--t-final", type=float, default=150.0)
    ap.add_argument("--space", default="p1p1", choices=["p1p1", "p2p1"])
    ap.add_argument("--no-wake-refine", action="store_true")
    ap.add_argument("--schafer-turek", action="store_true",
                    help="run the 2D-2 benchmark instead")
    ap.add_argument("--scheme", default="monolithic", choices=["monolithic", "projection"],
                    help="the Schäfer–Turek run's solver (projection = the segregated one)")
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help="steps per chunk (default 50, 100 with --schafer-turek)")
    ap.add_argument("--n-frames", type=int, default=40)
    ap.add_argument("--h-near", type=float, default=None,
                    help="mesh size at the body (default: the case's)")
    ap.add_argument("--h-far", type=float, default=None,
                    help="mesh size far from it (default: the case's)")
    add_common_args(ap, "out/cylinder_fem")
    args = ap.parse_args(argv)
    device_of(args.device)
    out = Path(args.out)
    mesh = {k: v for k, v in (("h_near", args.h_near), ("h_far", args.h_far)) if v is not None}
    if args.schafer_turek:
        kw = {"scheme": args.scheme, **mesh}
        if args.space == "p2p1" and args.scheme == "projection":
            kw["supg"] = 1.0  # P2 Galerkin convection needs SU
        r = run_schafer_turek(t_final=args.t_final, space=args.space,
                              chunk_steps=args.chunk_steps or 100, device=args.device, **kw)
        r["snapshots"] = save_fem_state(out / "schafer_turek", args.io, r["case"], r["state"])
        rows = {"schafer_turek": r}
    else:
        rows = {}
        for re in args.re or [100.0]:
            rows[f"Re_{int(re)}"] = run_re(
                re, t_final=args.t_final, space=args.space,
                wake_refine=not args.no_wake_refine, out_dir=out, n_frames=args.n_frames,
                chunk_steps=args.chunk_steps or 50, device=args.device, io=args.io,
                render=args.render, **mesh)
    report = {}
    for name, r in rows.items():
        state = r.pop("state")
        r.pop("case")
        report[name] = {**r, "steps": int(state.step), "t": float(state.t)}
    write_report(out, report)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
