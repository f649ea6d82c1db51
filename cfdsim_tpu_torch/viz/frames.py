"""Deferred frame rendering from HDF5 snapshots.

The reference renders frames *after* the run from the HDF5 file rather
than in the hot loop (``generate_frames_from_hdf5`` v5.py:472-555, a v4
innovation it kept). Same here: velocity-magnitude contours with
streamlines and vorticity contours, dark theme, one PNG per snapshot per
field, written to per-field frame directories (v5.py:448-451).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.style.use("dark_background")
    return plt


def render_frames_from_hdf5(
    hdf5_path,
    out_dir,
    grid=None,
    fields=("velocity", "vorticity"),
    cylinder: tuple | None = None,  # ((cx, cy), R) overlay patch
    dpi: int = 120,
    progress: bool = True,
):
    """Render one PNG per saved step per requested field.

    Snapshots must contain ``u``/``v`` (incompressible schema) or ``U``
    (compressible, component-leading). Returns {field: [paths]}.
    """
    plt = _mpl()
    from cfdsim_tpu_torch.io_.hdf5 import list_steps, load_step

    out = Path(out_dir)
    paths: dict[str, list] = {f: [] for f in fields}
    for f in fields:
        (out / f"{f}_frames").mkdir(parents=True, exist_ok=True)

    steps = list_steps(hdf5_path)
    it = steps
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(steps, desc="Rendering frames", unit="frame")
        except ImportError:
            pass

    for step in it:
        data, t = load_step(hdf5_path, step)
        # 3D snapshots: render the mid-z plane (any 3D scalar/face field)
        data = {
            k: (np.asarray(a)[np.asarray(a).shape[0] // 2]
                if np.ndim(a) == 3
                and k in ("u", "v", "w", "p", "vorticity", "theta")
                else a)
            for k, a in data.items()
        }
        if "u" in data and "v" in data:
            u, v = data["u"], data["v"]
            if u.shape != v.shape:
                # staggered (MAC) snapshot: average faces to cell centers
                if u.shape[1] == v.shape[1] + 1:
                    u = 0.5 * (u[:, :-1] + u[:, 1:])
                if v.shape[0] == u.shape[0] + 1:
                    v = 0.5 * (v[:-1, :] + v[1:, :])
        elif "U" in data:
            U = data["U"]
            rho = np.maximum(U[0], 1e-8)
            u, v = U[1] / rho, U[2] / rho
        else:
            raise KeyError(f"snapshot {step} lacks velocity fields")
        ny, nx = u.shape
        if grid is not None and hasattr(grid, "meshgrid"):
            X, Y = grid.meshgrid()
            if X.shape != u.shape:  # e.g. 3D grid rendered as a midplane
                X, Y = np.meshgrid(np.arange(nx), np.arange(ny))
        else:
            X, Y = np.meshgrid(np.arange(nx), np.arange(ny))

        for field in fields:
            fig, ax = plt.subplots(figsize=(10, 10 * ny / nx + 1))
            if field == "velocity":
                mag = np.sqrt(u * u + v * v)
                vmax = np.nanmax(mag)
                levels = np.linspace(0.0, max(vmax * 0.9, 1e-9), 31)
                cf = ax.contourf(X, Y, mag, levels=levels, cmap="viridis",
                                 extend="max")
                fig.colorbar(cf, ax=ax, label="|V|", shrink=0.8)
                try:
                    ax.streamplot(X, Y, u, v, color="white", linewidth=0.5,
                                  density=0.8)
                except Exception:
                    pass  # degenerate fields (all-zero) break streamplot
            elif field == "vorticity":
                if "vorticity" in data:
                    w = data["vorticity"]
                else:
                    dx = X[0, 1] - X[0, 0]
                    dy = Y[1, 0] - Y[0, 0]
                    w = np.zeros_like(u)
                    w[1:-1, 1:-1] = (v[1:-1, 2:] - v[1:-1, :-2]) / (2 * dx) - (
                        u[2:, 1:-1] - u[:-2, 1:-1]
                    ) / (2 * dy)
                wmax = min(np.nanmax(np.abs(w)) + 1e-9, 15.0)
                levels = np.linspace(-wmax, wmax, 51)
                cf = ax.contourf(X, Y, w, levels=levels, cmap="inferno",
                                 extend="both")
                fig.colorbar(cf, ax=ax, label="ω", shrink=0.8)
            elif field == "temperature" and "theta" in data:
                # Boussinesq / transport scalar frames (θ ∈ [cold, hot])
                cf = ax.contourf(X, Y, data["theta"], levels=31,
                                 cmap="coolwarm")
                fig.colorbar(cf, ax=ax, label="θ", shrink=0.8)
                try:
                    ax.streamplot(X, Y, u, v, color="black", linewidth=0.4,
                                  density=0.7)
                except Exception:
                    pass
            elif field == "density" and "U" in data:
                cf = ax.contourf(X, Y, data["U"][0], levels=31, cmap="plasma")
                fig.colorbar(cf, ax=ax, label="ρ", shrink=0.8)
            elif field == "mach" and "U" in data:
                # Mach frames (reference ShockwaveVisualizer mach_frames)
                U = data["U"]
                rho_s = np.maximum(U[0], 1e-8)
                E = np.clip(U[3] / rho_s, 1e-8, None)
                ke = 0.5 * (u * u + v * v)
                p_s = np.maximum(0.4 * rho_s * (E - ke), 1e-8)
                a = np.sqrt(1.4 * p_s / rho_s)
                mach = np.sqrt(u * u + v * v) / a
                cf = ax.contourf(X, Y, mach, levels=31, cmap="coolwarm")
                fig.colorbar(cf, ax=ax, label="M", shrink=0.8)
            else:
                plt.close(fig)
                continue
            if cylinder is not None:
                from matplotlib import patches

                ax.add_patch(
                    patches.Circle(cylinder[0], cylinder[1], facecolor="black",
                                   edgecolor="gold", linewidth=1.5)
                )
            ax.set_aspect("equal")
            ax.set_title(f"{field}, t={t:.3f}")
            path = out / f"{field}_frames" / f"{field}_frame_{step:06d}.png"
            fig.savefig(path, dpi=dpi, bbox_inches="tight")
            plt.close(fig)
            paths[field].append(path)
    return paths


def plot_energy_history(metrics_history, out_path, dpi: int = 120):
    """Kinetic-energy time series (reference ``plot_energy_history``
    v5.py:557-593) from the runner's metrics history."""
    plt = _mpl()
    steps = [m["step"] for m in metrics_history]
    energy = [m["energy"] for m in metrics_history]
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.semilogx(np.maximum(steps, 1), energy, color="cyan",
                label="mean kinetic energy")
    ax.set_xlabel("step")
    ax.set_ylabel("E")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return Path(out_path)
