"""Published validation data for regression tests (a numpy-only copy of
``cfdsim_tpu.validation``).

Ghia, Ghia & Shin (1982) lid-driven cavity centerline velocity profiles —
the accuracy benchmark named in BASELINE.json. Values transcribed from the
published tables (u along the vertical centerline x=0.5; v along the
horizontal centerline y=0.5).
"""

import numpy as np

# y locations for u-profiles (Ghia Table I grid points)
GHIA_Y = np.array(
    [0.0000, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531,
     0.5000, 0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766, 1.0000]
)

GHIA_U = {
    100: np.array(
        [0.00000, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150, -0.15662,
         -0.21090, -0.20581, -0.13641, 0.00332, 0.23151, 0.68717, 0.73722,
         0.78871, 0.84123, 1.00000]
    ),
    400: np.array(
        [0.00000, -0.08186, -0.09266, -0.10338, -0.14612, -0.24299, -0.32726,
         -0.17119, -0.11477, 0.02135, 0.16256, 0.29093, 0.55892, 0.61756,
         0.68439, 0.75837, 1.00000]
    ),
    1000: np.array(
        [0.00000, -0.18109, -0.20196, -0.22220, -0.29730, -0.38289, -0.27805,
         -0.10648, -0.06080, 0.05702, 0.18719, 0.33304, 0.46604, 0.51117,
         0.57492, 0.65928, 1.00000]
    ),
}

# x locations for v-profiles (Ghia Table II grid points)
GHIA_X = np.array(
    [0.0000, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266, 0.2344,
     0.5000, 0.8047, 0.8594, 0.9063, 0.9453, 0.9531, 0.9609, 0.9688, 1.0000]
)

GHIA_V = {
    100: np.array(
        [0.00000, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077, 0.17507,
         0.17527, 0.05454, -0.24533, -0.22445, -0.16914, -0.10313, -0.08864,
         -0.07391, -0.05906, 0.00000]
    ),
    400: np.array(
        [0.00000, 0.18360, 0.19713, 0.20920, 0.22965, 0.28124, 0.30203,
         0.30174, 0.05186, -0.38598, -0.44993, -0.33827, -0.22847, -0.19254,
         -0.15663, -0.12146, 0.00000]
    ),
    1000: np.array(
        [0.00000, 0.27485, 0.29012, 0.30353, 0.32627, 0.37095, 0.33075,
         0.32235, 0.02526, -0.31966, -0.42665, -0.51550, -0.39188, -0.33714,
         -0.27669, -0.21388, 0.00000]
    ),
}


# Botella & Peyret (1998) spectral benchmark (Chebyshev N=160) for the
# steady Re=1000 lid-driven cavity: extrema of the centerline profiles.
# This is the high-accuracy reference — the Ghia tables themselves deviate
# from it by 5e-3 (u_min) to 1.1e-2 (v_min), which bounds any "error vs
# Ghia" below ~5e-3 regardless of scheme quality.
BOTELLA_PEYRET_RE1000 = {
    "u_min": -0.3885698, "u_min_y": 0.1717,
    "v_max": 0.3769447, "v_max_x": 0.1578,
    "v_min": -0.5270771, "v_min_x": 0.9092,
}


def profile_extremum(vals, coords, kind: str):
    """(value, location) of a profile extremum with parabolic subpixel
    interpolation through the three points around the discrete extremum."""
    vals = np.asarray(vals, np.float64)
    coords = np.asarray(coords, np.float64)
    i = int(np.argmin(vals) if kind == "min" else np.argmax(vals))
    if not 0 < i < len(vals) - 1:
        return float(vals[i]), float(coords[i])
    a, b, c = vals[i - 1], vals[i], vals[i + 1]
    denom = a - 2.0 * b + c
    if denom == 0.0:
        return float(b), float(coords[i])
    d = (a - c) / (2.0 * denom)
    val = b - 0.25 * (a - c) * d
    return float(val), float(coords[i] + d * (coords[i] - coords[i - 1]))


def botella_peyret_errors(u_c, y_u, v_c, x_v):
    """Absolute errors of the Re=1000 centerline extrema vs the Botella &
    Peyret spectral values: dict with u_min/v_max/v_min errors."""
    bp = BOTELLA_PEYRET_RE1000
    u_min, _ = profile_extremum(u_c, y_u, "min")
    v_max, _ = profile_extremum(v_c, x_v, "max")
    v_min, _ = profile_extremum(v_c, x_v, "min")
    return {
        "u_min": abs(u_min - bp["u_min"]),
        "v_max": abs(v_max - bp["v_max"]),
        "v_min": abs(v_min - bp["v_min"]),
    }


def cavity_centerline_profiles(u, v):
    """Extract (u(y) at x=0.5, v(x) at y=0.5) from (ny, nx) fields."""
    ny, nx = np.asarray(u).shape
    u_c = np.asarray(u)[:, nx // 2]
    v_c = np.asarray(v)[ny // 2, :]
    return u_c, v_c


def energy_spectrum(u, v, lx: float = 1.0, ly: float = 1.0, n_bins=None):
    """Radially binned kinetic-energy spectrum E(k) of a periodic 2D
    velocity field (the turbulence diagnostic for the Kolmogorov solver;
    the reference only eyeballs vorticity frames, SURVEY.md §4).

    Returns (k_centers, E): Σ_bins E·Δk equals the mean kinetic energy
    (Parseval). k is the angular wavenumber magnitude."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    ny, nx = u.shape
    uh = np.fft.fft2(u) / (nx * ny)
    vh = np.fft.fft2(v) / (nx * ny)
    e_modes = 0.5 * (np.abs(uh) ** 2 + np.abs(vh) ** 2)  # per-mode energy
    kx = 2.0 * np.pi * np.fft.fftfreq(nx, d=lx / nx)
    ky = 2.0 * np.pi * np.fft.fftfreq(ny, d=ly / ny)
    kmag = np.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
    if n_bins is None:
        n_bins = min(nx, ny) // 2
    k_max = min(np.abs(kx).max(), np.abs(ky).max())
    edges = np.linspace(0.0, k_max, n_bins + 1)
    dk = edges[1] - edges[0]
    which = np.digitize(kmag.ravel(), edges) - 1
    E = np.zeros(n_bins)
    for b in range(n_bins):
        E[b] = e_modes.ravel()[which == b].sum() / dk
    return 0.5 * (edges[:-1] + edges[1:]), E


def energy_spectrum_shells(*components, lengths=None):
    """Integer-shell-binned kinetic-energy spectrum for 2D OR 3D
    periodic velocity fields: E(k) = ½ Σ_{|k'| rounds to k} |û(k')|²,
    normalized so Σ_k E(k) = mean(½|u|²) minus the k=0 (mean-flow)
    share (Parseval — tested). The dimension-generic companion of
    ``energy_spectrum`` (which keeps the 2D density-normalized binning);
    numpy on the host (the JAX package runs the FFTs on its device).

    ``components``: 2 or 3 equal-shape arrays (u, v[, w]) on a uniform
    periodic grid; ``lengths``: physical domain lengths (default 2π
    per axis, making shells integer wavenumbers). Returns (k, E) for
    k = 1..k_max.
    """
    if len(components) not in (2, 3):
        raise ValueError("energy_spectrum_shells expects 2 or 3 components")
    shape = components[0].shape
    ndim = len(shape)
    if ndim != len(components):
        raise ValueError(
            f"{len(components)} components but {ndim}-dimensional arrays"
        )
    if lengths is None:
        lengths = (2.0 * np.pi,) * ndim
    n_tot = float(np.prod(shape))

    ks = []
    for ax, (n, L) in enumerate(zip(shape, lengths)):
        k1 = np.fft.fftfreq(n, d=1.0 / n) * (2.0 * np.pi / L)
        sh = [1] * ndim
        sh[ax] = n
        ks.append(k1.reshape(sh))
    k_mag = np.sqrt(sum(np.broadcast_to(k * k, shape) for k in ks))
    k_bin = np.rint(k_mag).astype(np.int32)
    k_max = int(k_bin.max())
    e_hat = 0.0
    for c in components:
        ch = np.fft.fftn(np.asarray(c))
        e_hat = e_hat + 0.5 * (np.abs(ch) ** 2)
    e_hat = e_hat / (n_tot * n_tot)

    spec = np.bincount(k_bin.ravel(), weights=e_hat.ravel(), minlength=k_max + 1)
    return np.arange(1, k_max + 1), spec[1:]


def spectrum_slope(k, E, k_lo, k_hi):
    """Least-squares log-log slope of E(k) over [k_lo, k_hi] — the
    inertial-range exponent (Kolmogorov: −5/3)."""
    k = np.asarray(k, np.float64)
    E = np.asarray(E, np.float64)
    m = (k >= k_lo) & (k <= k_hi) & (E > 0)
    lk, lE = np.log(k[m]), np.log(E[m])
    return float(np.polyfit(lk, lE, 1)[0])


def sphere_drag_schiller_naumann(re: float) -> float:
    """Standard-drag-curve correlation for a sphere,
    Cd = 24/Re·(1 + 0.15·Re^0.687) (Schiller & Naumann 1935; within a
    few % of experiment for Re ≲ 800) — the validation target for the
    ``sphere`` case's penalization-force drag."""
    return 24.0 / re * (1.0 + 0.15 * re**0.687)


def sphere_nusselt_ranz_marshall(re: float, pr: float = 0.7) -> float:
    """Ranz & Marshall (1952) forced-convection correlation for a
    sphere, Nu = 2 + 0.6·Re^½·Pr^⅓ (Re ≲ 5·10⁴) — the validation target
    for the ``heated_sphere`` case's penalization heat flux."""
    return 2.0 + 0.6 * re**0.5 * pr ** (1.0 / 3.0)


def dominant_frequency(signal, sample_dt: float) -> float:
    """Frequency (Hz) of the strongest non-DC component of a time series."""
    s = np.asarray(signal, dtype=np.float64)
    s = s - s.mean()
    # Hann window to suppress leakage from the non-integer period count
    s = s * np.hanning(len(s))
    spec = np.abs(np.fft.rfft(s))
    freqs = np.fft.rfftfreq(len(s), d=sample_dt)
    return float(freqs[1:][np.argmax(spec[1:])])


def strouhal_number(signal, sample_dt: float, diameter: float, velocity: float) -> float:
    """St = f·D/U from a probe time series (e.g. v-velocity in the wake).

    Empirical reference for a circular cylinder: St ≈ 0.16-0.17 at
    Re = 100-200 (Roshko). The reference repo checks this only by eye on
    its Kármán-street animations (SURVEY.md §4)."""
    f = dominant_frequency(signal, sample_dt)
    return f * diameter / velocity


def ghia_error_profiles(u_c, y_u, v_c, x_v, Re: int):
    """RMS error of given centerline profiles (u(y) at x=0.5, v(x) at
    y=0.5, with their sample coordinates) vs Ghia et al."""
    u_interp = np.interp(GHIA_Y, np.asarray(y_u), np.asarray(u_c))
    v_interp = np.interp(GHIA_X, np.asarray(x_v), np.asarray(v_c))
    err_u = np.sqrt(np.mean((u_interp - GHIA_U[Re]) ** 2))
    err_v = np.sqrt(np.mean((v_interp - GHIA_V[Re]) ** 2))
    return err_u, err_v


def ghia_error(u, v, Re: int, y_coords, x_coords):
    """RMS error of the simulated centerline profiles vs Ghia et al."""
    u_c, v_c = cavity_centerline_profiles(u, v)
    return ghia_error_profiles(u_c, y_coords, v_c, x_coords, Re)


def ghia_error_mac(u, v, Re: int, lid_velocity: float = 1.0):
    """Ghia RMS for staggered (MAC) fields: u (ny, nx+1) on vertical faces,
    v (ny+1, nx) on horizontal faces of an nx×ny cell grid on [0,1]².
    With even nx/ny the centerlines are exact face columns/rows — no
    interpolation error. Wall values are appended so the profiles span
    [0, 1] like the published tables."""
    u = np.asarray(u)
    v = np.asarray(v)
    ny, nxp1 = u.shape
    nx = nxp1 - 1
    u_c = u[:, nx // 2]
    y_u = (np.arange(ny) + 0.5) / ny
    u_full = np.concatenate([[0.0], u_c, [lid_velocity]])
    y_full = np.concatenate([[0.0], y_u, [1.0]])
    v_c = v[ny // 2, :]
    x_v = (np.arange(nx) + 0.5) / nx
    v_full = np.concatenate([[0.0], v_c, [0.0]])
    x_full = np.concatenate([[0.0], x_v, [1.0]])
    return ghia_error_profiles(u_full, y_full, v_full, x_full, Re)
