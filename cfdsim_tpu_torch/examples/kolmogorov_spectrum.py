"""Kolmogorov-forced 2D turbulence with energy-spectrum diagnostics
(``examples/kolmogorov_spectrum.py`` of the JAX package).

Runs the spectral stable-fluids tier (``--solver stable``, semi-Lagrangian
or BFECC advection) or the pseudo-spectral vorticity tier (``--solver ps``)
on a square unit box with sin(k_f πy) forcing and prints the ring-averaged
E(k): the forcing peak, the inverse-energy-cascade band below k_f (k^-5/3)
and the direct enstrophy-cascade band above it (k^-3 in the ideal 2D
phenomenology). With ``--alpha > 0`` (linear Ekman friction) the inverse
cascade is arrested at the friction scale; E(k) is then averaged over the
stationary tail and the k^-5/3 band fitted between the friction peak and
the injection shell.

The steps run in chunks of ``chunk`` steps through ``make_chunk`` (one
captured CUDA graph on the card); the spectrum is taken after every chunk
of the averaging window. Beyond the JAX driver's arguments: ``--device``,
``--io`` (the final state, native ``.csnap`` by default), ``--out`` and
``--chunk``.

Run: ``python -m cfdsim_tpu_torch.examples.kolmogorov_spectrum [--n 256] [--t 40]
[--alpha 0.15] [--solver stable|ps] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from cfdsim_tpu_torch.examples._common import (
    add_common_args,
    device_of,
    save_final_state,
    write_report,
)


def spectrum_slopes(k, ek, k_force: int, alpha: float, n: int) -> dict:
    """The friction-arrest peak below the injection shell k_inj = k_f/2 and
    the log-log slopes of the inverse-cascade window [lo_inv, hi_inv) and of
    the enstrophy range [k_inj + 2, min(6 k_inj, n/3)); a window of fewer
    than 3 shells gives NaN."""
    # sin(k_f·π·y) on a unit-height box: k_f/2 cycles, the shell k_inj
    k_inj = max(k_force // 2, 1)

    def slope(lo, hi):
        if hi - lo < 3:
            return float("nan")  # too few shells for a meaningful fit
        sl = slice(lo, hi)
        return float(np.polyfit(np.log(k[sl]), np.log(ek[sl] + 1e-30), 1)[0])

    # search below the injection shell (the global argmax lands on the forcing)
    k_hi = max(k_inj - 1, 2)
    k_peak = int(np.argmax(ek[1:k_hi])) + 1
    lo_inv = max(k_peak + 1, 2) if alpha > 0 else 1
    # stop short of the forcing bump (it spreads ~k_inj/8 shells down)
    hi_inv = max(lo_inv + 3, k_inj - max(2, k_inj // 8))
    return {"k_peak": k_peak, "k_inj": k_inj, "lo_inv": lo_inv, "hi_inv": hi_inv,
            "slope_inverse": slope(lo_inv, hi_inv),
            "slope_direct": slope(k_inj + 2, min(6 * k_inj, n // 3))}


def run(n=256, t_final=40.0, k_force=8, nu=1e-3, chunk=200, verbose=True, alpha=0.0,
        t_stat=None, forcing_scale=0.1, noise=0.0, seed=0, advection="sl", dt=0.01,
        solver="stable", *, device="cuda"):
    """{"k", "E_k", "slope_inverse", "slope_direct", "k_peak", "k_inj",
    "alpha"}, as the JAX function returns, and the
    per-step "energy" and the final "state"."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.utils.spectra import energy_spectrum_2d

    device = device_of(device)
    if solver == "ps":
        # the vorticity tier: forcing per unit time (the stable tier's
        # per-step impulse ≈ forcing_scale/dt in these units)
        case = build("kolmogorov_ps", ny=n, aspect=1.0, nu=nu, dt=dt,
                     forcing_wavenumber=k_force, linear_friction=alpha,
                     forcing_scale=forcing_scale, noise=noise, seed=seed, device=device)
        get_uv = case.extras["velocities"]
    else:
        case = build("kolmogorov", ny=n, aspect=1.0, nu=nu, dt=dt,
                     forcing_wavenumber=k_force, linear_friction=alpha,
                     forcing_scale=forcing_scale, advection=advection, device=device)
        get_uv = lambda s: (s.u, s.v)  # noqa: E731
    state = case.state
    if noise > 0 and solver != "ps":
        # the laminar Kolmogorov flow is an exact solution: seed the instability
        rng = np.random.default_rng(seed)

        def seeded(f):
            return f + noise * torch.as_tensor(rng.standard_normal(tuple(f.shape)),
                                               dtype=torch.float32, device=device)

        state = state._replace(u=seeded(state.u), v=seeded(state.v))
    dt = case.cfg.dt
    # with friction the flow becomes stationary: average E(k) over the tail
    if t_stat is None:
        t_stat = 0.5 * t_final if alpha > 0 else t_final

    run_chunk = make_chunk(case.cfg, case.step, chunk)
    t0 = time.perf_counter()
    n_chunks = int(round(t_final / dt / chunk))
    ek_acc, n_acc, energy = None, 0, []
    for c in range(n_chunks):
        state, m = run_chunk(state, 1.0)
        energy.append(m.energy)
        if float(state.t) >= t_stat:
            k, ek_i = energy_spectrum_2d(*get_uv(state))
            ek_acc = ek_i if ek_acc is None else ek_acc + ek_i
            n_acc += 1
        if verbose and (c % 5 == 4 or c == n_chunks - 1):
            el = time.perf_counter() - t0
            print(f"  t={float(state.t):6.1f}  E={float(m.energy[-1]):.4f}  "
                  f"[{(c + 1) * chunk / el:6.0f} steps/s]", flush=True)

    if ek_acc is not None and n_acc > 0:
        ek = ek_acc / n_acc  # the time-averaged stationary spectrum
    else:
        k, ek = energy_spectrum_2d(*get_uv(state))
    s = spectrum_slopes(k, ek, k_force, alpha, n)
    # log-spaced shell table, so that run logs carry the spectrum's shape
    shells = sorted({int(q) for q in np.geomspace(1, len(ek) - 1, 18)})
    print("  E(k): " + "  ".join(f"{q}:{ek[q]:.2e}" for q in shells))
    stat = f" [stationary avg over {n_acc} snapshots t>{t_stat:g}]" if n_acc else ""
    print(f"\nRESULT kolmogorov {n}² k_f={k_force} (injection shell "
          f"k={s['k_inj']}) t={t_final:g} alpha={alpha:g}{stat}: E(k) peak at "
          f"k={s['k_peak']}, slope k∈[{s['lo_inv']},{s['hi_inv']}) {s['slope_inverse']:.2f} "
          f"(inverse cascade: -5/3), slope above injection {s['slope_direct']:.2f} "
          f"(enstrophy cascade: -3 ideal, steeper with ν=1e-3)")
    out = {"k": k, "E_k": ek, "slope_inverse": s["slope_inverse"],
           "slope_direct": s["slope_direct"], "k_peak": s["k_peak"], "k_inj": s["k_inj"],
           "alpha": alpha}
    out.update(energy=torch.cat(energy).cpu().numpy() if energy else np.zeros(0),
               n_stat=n_acc, state=state)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--t", type=float, default=40.0)
    p.add_argument("--kf", type=int, default=8)
    p.add_argument("--nu", type=float, default=1e-3)
    p.add_argument("--alpha", type=float, default=0.0,
                   help="linear (Ekman) friction coefficient; >0 makes the inverse "
                        "cascade stationary")
    p.add_argument("--t-stat", type=float, default=None,
                   help="start of the stationary averaging window (default t/2 when alpha>0)")
    p.add_argument("--fs", type=float, default=0.1,
                   help="forcing amplitude (SpectralConfig.forcing_scale)")
    p.add_argument("--noise", type=float, default=0.0,
                   help="initial white-noise amplitude (seeds the Kolmogorov instability)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--advection", default="sl", choices=["sl", "bfecc"],
                   help="bfecc = MacCormack error compensation (2nd order)")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--solver", default="stable", choices=["stable", "ps"],
                   help="ps = pseudo-spectral vorticity tier (forcing per unit time)")
    p.add_argument("--chunk", type=int, default=200)
    add_common_args(p, "out/kolmogorov_spectrum", render=False)
    a = p.parse_args(argv)
    r = run(n=a.n, t_final=a.t, k_force=a.kf, nu=a.nu, chunk=a.chunk, alpha=a.alpha,
            t_stat=a.t_stat, forcing_scale=a.fs, noise=a.noise, seed=a.seed,
            advection=a.advection, dt=a.dt, solver=a.solver, device=a.device)
    state = r.pop("state")
    path = save_final_state(a.out, a.io, state)
    write_report(a.out, {"n": a.n, "solver": a.solver, **r, "steps": int(state.step),
                         "t": float(state.t), "snapshots": path})
    return r


if __name__ == "__main__":
    main()
    sys.exit(0)
