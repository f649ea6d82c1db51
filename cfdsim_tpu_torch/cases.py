"""Named case registry (``cfdsim_tpu.cases``).

Each named case is a builder that returns a ready-to-run bundle: static
config, step module and initial state, all on the ``device`` the caller
names. The collocated tier: ``"cavity"``, ``"channel"``, ``"cylinder"``,
``"transport"``; the staggered (MAC) tier: ``"cavity_mac"``,
``"cylinder_mac"``, ``"cylinder_oscillating"`` (uniform, or with
``stretched=True``); the stretched MAC tier: ``"cavity_stretched"``,
``"cylinder_stretched"``; Boussinesq convection: ``"heated_cavity"``,
``"rayleigh_benard"``; the 3D tier: ``"cavity3d"`` (collocated, multigrid)
and ``"cavity3d_mac"`` (staggered, exact 3D DCT).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from cfdsim_tpu_torch import boundary
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ibm import (
    _gaussian_shell,
    cylinder_masks,
    cylinder_masks_mac,
    oscillating_cylinder,
    potential_flow_cylinder,
    potential_flow_cylinder_mac,
)
from cfdsim_tpu_torch.models.incompressible import (
    IncompressibleConfig,
    init_state,
    make_step,
)
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig


@dataclasses.dataclass
class Case:
    """A runnable bundle: ``step(state, cfl_scale) -> (state, metrics)``."""

    name: str
    cfg: Any
    step: Callable
    state: Any
    grid: Grid
    extras: dict = dataclasses.field(default_factory=dict)


def _poisson_spec(poisson, cls=PoissonConfig):
    """Accept a ``cls`` (PoissonConfig, or the 3D tier's Poisson3DConfig) or
    a CLI-friendly "method[:iters[:omega]]" string (e.g. "mg:2",
    "rbsor:100:1.7", "dct")."""
    if poisson is None or isinstance(poisson, cls):
        return poisson
    parts = str(poisson).split(":")
    kw = {"method": parts[0]}
    if len(parts) > 1:
        kw["iters"] = int(parts[1])
    if len(parts) > 2:
        kw["omega"] = float(parts[2])
    return cls(**kw)


def lid_cavity(
    n: int = 128,
    Re: float = 100.0,
    lid_velocity: float = 1.0,
    poisson: Optional[PoissonConfig] = None,
    scheme: str = "central",
    cfl: float = 0.5,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """2D lid-driven cavity (the Ghia benchmark)."""
    grid = Grid(nx=n, ny=n)
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    cfg = IncompressibleConfig(
        grid=grid,
        nu=lid_velocity / Re,
        scheme=scheme,
        poisson=pois,
        cfl_target=cfl,
        dt_max=0.5 * min(grid.dx, grid.dy) / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bc = boundary.lid_cavity_bcs(lid_velocity)
    step = make_step(cfg, bc, device=device)
    state = init_state(cfg, device=device)
    return Case("cavity", cfg, step, state, grid)


def lid_cavity_mac(
    n: int = 128,
    Re: float = 100.0,
    lid_velocity: float = 1.0,
    poisson: Optional[PoissonConfig] = None,
    scheme: str = "central",
    cfl: float = 0.5,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Lid-driven cavity on the staggered (MAC) grid, the accuracy tier:
    an exactly divergence-free projection; the physics of ``lid_cavity``."""
    from cfdsim_tpu_torch.models import mac

    grid = Grid(nx=n, ny=n, centering="cell")
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    cfg = mac.MACConfig(
        grid=grid,
        nu=lid_velocity / Re,
        scheme=scheme,
        poisson=pois,
        cfl_target=cfl,
        dt_max=0.5 * min(grid.dx, grid.dy) / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bcs = mac.cavity_bcs(lid_velocity)
    kit = (mac.cavity_implicit_kit(grid, lid_velocity, device=device)
           if cfg.diffusion == "implicit" else None)
    step = mac.make_step(cfg, bcs, implicit_kit=kit, device=device)
    state = mac.init_state(cfg, device=device)
    return Case("cavity_mac", cfg, step, state, grid, {"lid_velocity": lid_velocity, "bcs": bcs})


def channel(
    nx: int = 512,
    ny: int = 128,
    Re: float = 100.0,
    u_in: float = 1.0,
    length: float = 4.0,
    height: float = 1.0,
    parabolic_inflow: bool = True,
    poisson: Optional[PoissonConfig] = None,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """2D channel / Poiseuille flow with inflow-outflow and no-slip walls."""
    grid = Grid(nx=nx, ny=ny, x_max=length, y_max=height)
    # Re based on channel height
    nu = u_in * height / Re
    profile = None
    if parabolic_inflow:
        y = torch.as_tensor(grid.y_coords(), dtype=torch.float32, device=device)
        profile = 6.0 * u_in * (y / height) * (1.0 - y / height)
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    cfg = IncompressibleConfig(
        grid=grid,
        nu=nu,
        scheme="central",
        poisson=pois,
        cfl_target=0.4,
        dt_max=0.4 * min(grid.dx, grid.dy) / max(u_in, 1e-10),
        max_velocity=10.0 * u_in,
        **cfg_overrides,
    )
    bc = boundary.channel_bcs(u_in, profile)
    step = make_step(cfg, bc, device=device)
    state = init_state(cfg, device=device)
    return Case("channel", cfg, step, state, grid, {"profile": profile})


def cylinder(
    nx: int = 600,
    ny: int = 180,
    Re: float = 600.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float] = (4.0, 2.0),
    domain: tuple[float, float] = (20.0, 4.0),
    scheme: str = "upwind",
    use_les: bool = False,
    smagorinsky_constant: float = 0.17,
    artificial_viscosity: float = 1e-3,
    poisson: Optional[PoissonConfig] = None,
    ref_parity: bool = False,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Flow past an immersed cylinder, the reference's flagship case
    (600×180 grid on a 20×4 domain, Re=600, artificial viscosity 1e-3, IBM
    ramp and fixed-dt warm-up over the first 1000 steps, velocity clip at
    5). ``ref_parity=True`` reproduces the reference's halved SUPG
    convection (with ``scheme="supg"``) and its masked red-black SOR
    pressure solve: 1500 sweeps at ω=1.7 with an early exit at residual
    1e-8 checked every 50 sweeps, streaming ``rbsor`` by default (pass
    ``poisson=PoissonConfig(method="rbsor_pallas", ...)`` for kernel A).
    The default scheme is monotone upwind with the exact DCT projection."""
    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1])
    solid, ibm = cylinder_masks(grid, center, radius)
    poisson = _poisson_spec(poisson)
    if poisson is None:
        if ref_parity:
            poisson = PoissonConfig(method="rbsor", iters=1500, tol=1e-8, check_every=50,
                                    omega=1.7)
        else:
            poisson = PoissonConfig(method="dct")
    defaults = dict(
        adaptive_dt=True,
        cfl_target=0.1,
        dt_base=5e-5,
        dt_min=1e-6,
        dt_max=1e-4,
        warmup_steps=1000,
        warmup_dt=2e-5,
        ibm_ramp_steps=1000,
        max_velocity=5.0 * v_inf,
        cleanup_iters=2,
        masked_poisson=ref_parity,
    )
    defaults.update(cfg_overrides)
    cfg = IncompressibleConfig(
        grid=grid,
        nu=v_inf / Re,
        scheme=("supg_refparity" if ref_parity and scheme == "supg" else scheme),
        use_les=use_les,
        smagorinsky_constant=smagorinsky_constant,
        artificial_viscosity=artificial_viscosity,
        poisson=poisson,
        **defaults,
    )
    bc = boundary.cylinder_inflow_bcs(v_inf, grid.y_coords(), grid.y_max, perturb_amp=0.01,
                                      perturb_ramp_steps=1000, device=device)
    step = make_step(cfg, bc, solid_mask=solid, ibm_mask=ibm, device=device)
    u0, v0 = potential_flow_cylinder(grid, center, radius, v_inf, ibm)
    state = init_state(cfg, u0=u0, v0=v0, device=device)
    return Case("cylinder", cfg, step, state, grid,
                {"solid_mask": solid, "ibm_mask": ibm, "center": center, "radius": radius})


def transport(
    n: int = 128,
    Re: float = 100.0,
    Pe: float = 100.0,
    scheme: str = "upwind",
    hot_lid: float = 1.0,
    *,
    device,
    **cavity_kwargs,
) -> Case:
    """Passive scalar (temperature/dye) carried by the lid-driven cavity
    flow: θ=hot_lid on the moving lid, θ=0 on the other walls, diffusivity
    κ = U·L/Pe."""
    from cfdsim_tpu_torch.models import transport as tr

    base = lid_cavity(n=n, Re=Re, device=device, **cavity_kwargs)

    def theta_bc(th):  # in place, like boundary.py's edge writes
        th[:, 0] = 0.0
        th[:, -1] = 0.0
        th[0, :] = 0.0
        th[-1, :] = hot_lid
        return th

    tcfg = tr.TransportConfig(grid=base.grid, kappa=1.0 / Pe, scheme=scheme)
    step = tr.make_coupled_step(base.step, tcfg, theta_bc)
    theta0 = theta_bc(base.grid.zeros(device=device))
    state = tr.init_coupled(base.state, theta0)
    return Case("transport", (base.cfg, tcfg), step, state, base.grid,
                {"hot_lid": hot_lid})


def cavity_stretched(
    n: int = 96,
    Re: float = 1000.0,
    lid_velocity: float = 1.0,
    beta: float = 1.5,
    scheme: str = "central",
    cfl: float = 0.5,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Lid-driven cavity on a tanh wall-clustered stretched MAC grid with the
    exact fast-diagonalization pressure solve."""
    from cfdsim_tpu_torch.models import mac
    from cfdsim_tpu_torch.models import mac_stretched as ms

    xf = ms.wall_clustered_faces(n, 1.0, beta=beta)
    yf = ms.wall_clustered_faces(n, 1.0, beta=beta)
    h_min = float(min((xf[1:] - xf[:-1]).min(), (yf[1:] - yf[:-1]).min()))
    defaults = dict(
        cfl_target=cfl,
        dt_max=cfl * h_min / max(lid_velocity, 1e-10),
        max_velocity=5.0 * lid_velocity,
    )
    defaults.update(cfg_overrides)
    cfg = ms.StretchedMACConfig(nx=n, ny=n, nu=lid_velocity / Re, scheme=scheme, **defaults)
    bcs = mac.cavity_bcs(lid_velocity)
    step = ms.make_step(cfg, bcs, xf, yf, device=device)
    state = ms.init_state(cfg, device=device)
    grid = Grid(nx=n, ny=n, centering="cell")  # the nominal uniform descriptor
    return Case("cavity_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "beta": beta, "lid_velocity": lid_velocity,
                 "bcs": bcs})


def cylinder_stretched(
    nx: int = 512,
    ny: int = 256,
    Re: float = 150.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float] = (6.0, 4.0),
    domain: tuple[float, float] = (24.0, 8.0),
    scheme: str = "tvd",
    refine_strength: float = 3.0,
    refine_width: float = 1.5,
    wake_length: float = 6.0,
    ibm_ramp_steps: int = 200,
    perturb_ramp_steps: int = 200,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Cylinder flow on a stretched MAC grid: grid lines cluster around the
    body and the near wake (Gaussian refinement regions)."""
    from cfdsim_tpu_torch.models import mac
    from cfdsim_tpu_torch.models import mac_stretched as ms

    xf = ms.stretched_faces(
        nx, domain[0],
        refine=[(center[0], refine_width, refine_strength),
                (center[0] + 0.5 * wake_length, wake_length, 0.5 * refine_strength)])
    yf = ms.stretched_faces(ny, domain[1], refine=[(center[1], refine_width, refine_strength)])
    h_min = float(min((xf[1:] - xf[:-1]).min(), (yf[1:] - yf[:-1]).min()))
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * h_min / max(v_inf, 1e-10),
        dt_min=1e-6,
        warmup_steps=ibm_ramp_steps,
        warmup_dt=min(5e-4, 0.1 * h_min / max(v_inf, 1e-10)),
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = ms.StretchedMACConfig(nx=nx, ny=ny, nu=v_inf * 2 * radius / Re, scheme=scheme,
                                **defaults)
    # face-sampled IBM masks at the stretched face locations
    xc = 0.5 * (xf[:-1] + xf[1:])
    yc = 0.5 * (yf[:-1] + yf[1:])
    h_near = float(np.diff(xf)[np.argmin(np.abs(xc - center[0]))])
    Xu, Yu = np.meshgrid(xf, yc, indexing="xy")
    Xv, Yv = np.meshgrid(xc, yf, indexing="xy")
    du = np.sqrt((Xu - center[0]) ** 2 + (Yu - center[1]) ** 2)
    dv = np.sqrt((Xv - center[0]) ** 2 + (Yv - center[1]) ** 2)
    mask_u = _gaussian_shell(du, radius, h_near).astype(np.float32)
    mask_v = _gaussian_shell(dv, radius, h_near).astype(np.float32)
    bcs = mac.external_flow_bcs(v_inf, yc, domain[1], perturb_ramp_steps=perturb_ramp_steps,
                                device=device)
    step = ms.make_step(cfg, bcs, xf, yf, ibm_mask_u=mask_u, ibm_mask_v=mask_v,
                        ibm_ramp_steps=ibm_ramp_steps, device=device)
    u0 = np.full((ny, nx + 1), v_inf, np.float32) * (np.float32(1.0) - mask_u)
    state = ms.init_state(cfg, u0=u0, device=device)
    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1], centering="cell")
    return Case("cylinder_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "ibm_mask_u": mask_u, "ibm_mask_v": mask_v,
                 "center": center, "radius": radius, "h_near": h_near, "v_inf": v_inf,
                 "bcs": bcs})


def cylinder_mac(
    nx: int = 720,
    ny: int = 240,
    Re: float = 150.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float] = (6.0, 4.0),
    domain: tuple[float, float] = (24.0, 8.0),
    scheme: str = "tvd",
    poisson: Optional[PoissonConfig] = None,
    ibm_ramp_steps: int = 200,
    perturb_ramp_steps: int = 200,
    ibm_profile: str = "shell",
    ibm_scheme: str = "penalize",
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Flow past a cylinder on the staggered (MAC) grid: exact projection,
    TVD convection, face-sampled IBM masks (``ibm_profile="shell"``, the
    Gaussian shell, or ``"sharp"`` for quantitative forces).
    ``ibm_scheme="ghost"``: sharp-interface ghost-cell direct forcing
    (``ibm_ghost.cylinder_ghost_ibm``), no-slip exactly on r = R."""
    from cfdsim_tpu_torch.models import mac

    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1], centering="cell")
    mask_u, mask_v = cylinder_masks_mac(grid, center, radius, profile=ibm_profile)
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * grid.dy / max(v_inf, 1e-10),
        dt_min=1e-6,
        dt_base=1e-3,
        warmup_steps=ibm_ramp_steps,
        warmup_dt=min(5e-4, 0.1 * grid.dy / max(v_inf, 1e-10)),
        max_velocity=5.0 * v_inf,
    )
    defaults.update(cfg_overrides)
    cfg = mac.MACConfig(grid=grid, nu=v_inf * 2 * radius / Re, scheme=scheme, poisson=pois,
                        **defaults)
    # the face centres in float32 arithmetic, as the JAX case builds them
    y_face_centers = np.float32(grid.y_min) + (
        np.arange(ny, dtype=np.float32) + np.float32(0.5)) * np.float32(grid.dy)
    bcs = mac.external_flow_bcs(v_inf, y_face_centers, grid.y_max,
                                perturb_ramp_steps=perturb_ramp_steps, device=device)
    if ibm_scheme == "ghost":
        from cfdsim_tpu_torch.ibm_ghost import cylinder_ghost_ibm

        xf = grid.x_min + np.arange(nx + 1) * grid.dx
        yf = grid.y_min + np.arange(ny + 1) * grid.dy
        ibm_kwargs = dict(ibm_ghost=cylinder_ghost_ibm(xf, yf, center, radius, device=device))
    elif ibm_scheme == "penalize":
        ibm_kwargs = dict(ibm_mask_u=mask_u, ibm_mask_v=mask_v)
    else:
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    step = mac.make_step(cfg, bcs, ibm_ramp_steps=ibm_ramp_steps, device=device, **ibm_kwargs)
    u0, v0 = potential_flow_cylinder_mac(grid, center, radius, v_inf, mask_u, mask_v)
    state = mac.init_state(cfg, u0=u0, v0=v0, device=device)
    return Case("cylinder_mac", cfg, step, state, grid,
                {"ibm_mask_u": mask_u, "ibm_mask_v": mask_v, "center": center,
                 "radius": radius, "v_inf": v_inf, "bcs": bcs})


def cylinder_oscillating(
    nx: int = 480,
    ny: int = 240,
    KC: float = 5.0,
    Re: float = 100.0,
    radius: float = 0.5,
    period: float = 5.0,
    domain: tuple[float, float] = (24.0, 12.0),
    center: tuple[float, float] = (12.0, 6.0),
    scheme: str = "tvd",
    poisson: Optional[PoissonConfig] = None,
    ibm_ramp_steps: int = 0,
    stretched: bool = False,
    refine_strength: float = 3.0,
    ibm_scheme: str = "penalize",
    *,
    device,
    **cfg_overrides,
) -> Case:
    """In-line oscillating cylinder in fluid at rest, the moving-geometry IBM
    benchmark: x_c(t) = x0 + A·sin(2πt/T), KC = 2πA/D, Re = U_max·D/ν with
    U_max = 2πA/T; the sharp face masks are rebuilt on the device every
    stage; the metrics carry the fluid–body momentum exchange (fx, fy);
    free-slip far field. ``stretched=True`` clusters the grid around the
    sweep. ``ibm_scheme="ghost"``: moving ghost-cell forcing, the wall
    condition u(r=R) = u_b(t) imposed exactly, classification and probe
    stencils rebuilt on the device every stage."""
    from cfdsim_tpu_torch.models import mac

    if ibm_scheme not in ("penalize", "ghost"):
        raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")
    D = 2 * radius
    A = KC * D / (2 * np.pi)
    u_max = 2 * np.pi * A / period
    nu = u_max * D / Re
    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1], centering="cell")
    pois = _poisson_spec(poisson) or PoissonConfig(method="dct")
    body = oscillating_cylinder(center, radius, A, period)
    bcs = mac.free_slip_bcs()
    extras = {"body": body, "amplitude": A, "period": period, "u_max": u_max,
              "center": center, "radius": radius,
              "coeff_scale": 2.0 / (u_max**2 * D)}  # Cd(t) = coeff_scale·fx(t)
    if stretched:
        from cfdsim_tpu_torch.models import mac_stretched as ms

        xf = ms.stretched_faces(nx, domain[0], refine=[(center[0], A + 2 * radius,
                                                        refine_strength)])
        yf = ms.stretched_faces(ny, domain[1], refine=[(center[1], 2.5 * radius,
                                                        refine_strength)])
        h_min = float(min(np.diff(xf).min(), np.diff(yf).min()))
        defaults = dict(
            cfl_target=0.4,
            dt_max=0.4 * h_min / max(u_max, 1e-10),
            dt_min=1e-6,
            max_velocity=5.0 * u_max,
        )
        defaults.update(cfg_overrides)
        scfg = ms.StretchedMACConfig(nx=nx, ny=ny, nu=nu, scheme=scheme, **defaults)
        step = ms.make_step(scfg, bcs, xf, yf, moving_body=body, ibm_ramp_steps=ibm_ramp_steps,
                            moving_scheme=ibm_scheme, device=device)
        state = ms.init_state(scfg, device=device)
        extras.update({"x_faces": xf, "y_faces": yf, "h_min": h_min})
        return Case("cylinder_oscillating", scfg, step, state, grid, extras)
    defaults = dict(
        cfl_target=0.4,
        dt_max=0.4 * grid.dy / max(u_max, 1e-10),
        dt_min=1e-6,
        max_velocity=5.0 * u_max,
    )
    defaults.update(cfg_overrides)
    cfg = mac.MACConfig(grid=grid, nu=nu, scheme=scheme, poisson=pois, **defaults)
    step = mac.make_step(cfg, bcs, moving_body=body, ibm_ramp_steps=ibm_ramp_steps,
                         moving_scheme=ibm_scheme, device=device)
    state = mac.init_state(cfg, device=device)
    return Case("cylinder_oscillating", cfg, step, state, grid, extras)


def heated_cavity(
    n: int = 64,
    Ra: float = 1e4,
    Pr: float = 0.71,
    theta_scheme: str = "central",
    poisson: Optional[PoissonConfig] = None,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Differentially heated square cavity (Boussinesq natural convection
    on the MAC tier): hot wall θ=1 at x=0, cold at x=1, adiabatic top and
    bottom; the de Vahl Davis (1983) benchmark (Nu = 1.118 at Ra=10³,
    2.243 at Ra=10⁴)."""
    from cfdsim_tpu_torch.models import boussinesq as bq

    grid = Grid(nx=n, ny=n, centering="cell")
    if poisson is not None:
        cfg_overrides["poisson"] = _poisson_spec(poisson)
    cfg = bq.BoussinesqConfig(grid=grid, rayleigh=Ra, prandtl=Pr, theta_scheme=theta_scheme,
                              **cfg_overrides)
    step = bq.make_step(cfg, device=device)
    state = bq.init_state(cfg, device=device)
    return Case("heated_cavity", cfg, step, state, grid, {"Ra": Ra, "Pr": Pr})


def rayleigh_benard(
    ny: int = 48,
    aspect: float = 2.0,
    Ra: float = 3000.0,
    Pr: float = 0.71,
    perturb: float = 1e-3,
    seed: int = 0,
    poisson: Optional[PoissonConfig] = None,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Rayleigh–Bénard convection: heated from below in an aspect-ratio box
    with adiabatic side walls. The conducting state is stable below Ra_c =
    1708 (rigid-rigid) and rolls grow above it; ``perturb`` seeds the
    instability with a small random θ disturbance from
    ``np.random.default_rng(seed)``, the JAX package's draw."""
    from cfdsim_tpu_torch.models import boussinesq as bq

    nx = int(round(ny * aspect))
    grid = Grid(nx=nx, ny=ny, x_max=aspect, y_max=1.0, centering="cell")
    if poisson is not None:
        cfg_overrides["poisson"] = _poisson_spec(poisson)
    cfg = bq.BoussinesqConfig(grid=grid, rayleigh=Ra, prandtl=Pr, heated_axis="y",
                              **cfg_overrides)
    step = bq.make_step(cfg, device=device)
    rng = np.random.default_rng(seed)
    yc = (np.arange(ny, dtype=np.float32) + 0.5) / ny
    conducting = (1.0 - yc)[:, None] * np.ones((ny, nx), np.float32)
    theta0 = conducting + perturb * rng.standard_normal((ny, nx)).astype(np.float32)
    state = bq.init_state(cfg, theta0=theta0, device=device)
    return Case("rayleigh_benard", cfg, step, state, grid, {"Ra": Ra, "Pr": Pr, "aspect": aspect})


def cavity3d(
    n: int = 64,
    Re: float = 400.0,
    lid_velocity: float = 1.0,
    poisson=None,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """3D lid-driven cavity, collocated (BASELINE.json config 5: 256³,
    multigrid Poisson, ``poisson="mg:2"`` by default)."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import incompressible3d as m3
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    grid = Grid3D(nx=n, ny=n, nz=n)
    cfg = m3.Incompressible3DConfig(
        grid=grid,
        nu=lid_velocity / Re,
        poisson=_poisson_spec(poisson, Poisson3DConfig) or Poisson3DConfig(method="mg", iters=2),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    step = m3.make_step(cfg, m3.lid_cavity3d_bcs(lid_velocity), device=device)
    state = m3.init_state(cfg, device=device)
    return Case("cavity3d", cfg, step, state, grid)


def cavity3d_mac(
    n: int = 64,
    Re: float = 400.0,
    lid_velocity: float = 1.0,
    poisson=None,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """3D lid-driven cavity on the staggered MAC grid: the exact 3D DCT
    projection (divergence-free to float32 roundoff); the geometry of
    ``cavity3d``, n cells per axis on [0, 1]³."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    grid = Grid3D(nx=n, ny=n, nz=n, centering="cell")
    cfg = mac3d.MAC3DConfig(
        grid=grid,
        nu=lid_velocity / Re,
        poisson=_poisson_spec(poisson, Poisson3DConfig) or Poisson3DConfig(method="dct"),
        max_velocity=5.0 * lid_velocity,
        **cfg_overrides,
    )
    bcs = mac3d.cavity3d_bcs(lid_velocity)
    step = mac3d.make_step(cfg, bcs, device=device)
    state = mac3d.init_state(cfg, device=device)
    return Case("cavity3d_mac", cfg, step, state, grid, {"bcs": bcs})


CASES: dict[str, Callable[..., Case]] = {
    "cavity": lid_cavity,
    "cavity3d": cavity3d,
    "cavity3d_mac": cavity3d_mac,
    "cavity_mac": lid_cavity_mac,
    "cavity_stretched": cavity_stretched,
    "channel": channel,
    "heated_cavity": heated_cavity,
    "rayleigh_benard": rayleigh_benard,
    "cylinder": cylinder,
    "cylinder_mac": cylinder_mac,
    "cylinder_oscillating": cylinder_oscillating,
    "cylinder_stretched": cylinder_stretched,
    "transport": transport,
}


def build(name: str, **kwargs) -> Case:
    """Build a named case (``device=`` is required)."""
    try:
        builder = CASES[name]
    except KeyError:
        raise KeyError(f"unknown case {name!r}; available: {sorted(CASES)}") from None
    return builder(**kwargs)
