"""Named case registry (``cfdsim_tpu.cases``).

Each named case is a builder that returns a ready-to-run bundle: static
config, step module and initial state, all on the ``device`` the caller
names. The collocated tier: ``"cavity"``, ``"channel"``, ``"cylinder"``,
``"transport"``; the staggered (MAC) tier: ``"cavity_mac"``,
``"cylinder_mac"``, ``"cylinder_oscillating"`` (uniform, or with
``stretched=True``); the stretched MAC tier: ``"cavity_stretched"``,
``"cylinder_stretched"``; Boussinesq convection: ``"heated_cavity"``,
``"rayleigh_benard"``; the 3D tier: ``"cavity3d"`` (collocated, multigrid),
``"cavity3d_mac"`` (staggered, exact 3D DCT), ``"cavity3d_stretched"``
(stretched, exact 3D FDM), the immersed sphere ``"sphere"`` and
``"sphere_stretched"`` (penalization or ghost-cell IBM), the heated sphere
``"heated_sphere"`` and ``"heated_sphere_stretched"`` (θ transport,
Nusselt number) and the heated cube ``"heated_cube"`` (3D Boussinesq); the
compressible tier: the oblique-shock ``"wedge"`` (three modes), the
supersonic open cavity ``"cavity_supersonic"`` (pinned or real geometry)
and the 3D ``"blast3d"``; the spectral tier: Kolmogorov flow on stable fluids
``"kolmogorov"`` and on the pseudo-spectral vorticity solver
``"kolmogorov_ps"``; the unstructured FEM tier: ``"cylinder_fem"``,
``"cavity_fem"`` and ``"schafer_turek_fem"``.
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
    # what parallel/sharded.py::make_sharded_step needs beyond the module
    step.explicit_spec = ("cavity", {"lid_velocity": lid_velocity})
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
    step.explicit_spec = ("cavity_mac", {"lid_velocity": lid_velocity})
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
    step.explicit_spec = ("channel", {"u_in": u_in, "profile": (
        None if profile is None else profile.detach().cpu().numpy())})
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
    step.explicit_spec = ("cylinder", {
        "v_inf": v_inf, "perturb_amp": 0.01, "perturb_ramp_steps": 1000, "ibm_mask": ibm,
        "solid_mask": solid, "y": np.asarray(grid.y_coords(), np.float32)})
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
    step.explicit_spec = ("transport", {**base.step.explicit_spec[1], "hot_lid": hot_lid})
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
    step.explicit_spec = ("cavity_stretched", {"x_faces": xf, "y_faces": yf,
                                               "lid_velocity": lid_velocity})
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
    step.explicit_spec = ("cylinder_stretched", {
        "x_faces": xf, "y_faces": yf, "v_inf": v_inf, "perturb_amp": 0.01,
        "perturb_ramp_steps": perturb_ramp_steps, "ibm_ramp_steps": ibm_ramp_steps,
        "ibm_mask_u": mask_u, "ibm_mask_v": mask_v})
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
    step.explicit_spec = ("cylinder_mac", {
        "v_inf": v_inf, "perturb_amp": 0.01, "perturb_ramp_steps": perturb_ramp_steps,
        "ibm_ramp_steps": ibm_ramp_steps, "ibm_scheme": ibm_scheme, "ibm_mask_u": mask_u,
        "ibm_mask_v": mask_v, "ibm_ghost": ibm_kwargs.get("ibm_ghost")})
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
        step.explicit_spec = ("cylinder_oscillating", {
            "body": body, "ibm_ramp_steps": ibm_ramp_steps, "moving_scheme": ibm_scheme,
            "x_faces": xf, "y_faces": yf})
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
    step.explicit_spec = ("cylinder_oscillating", {
        "body": body, "ibm_ramp_steps": ibm_ramp_steps, "moving_scheme": ibm_scheme})
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
    step.explicit_spec = ("boussinesq", {})
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
    step.explicit_spec = ("boussinesq", {})
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
    step.explicit_spec = ("cavity3d", {"lid_velocity": lid_velocity})
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
    step.explicit_spec = ("cavity3d_mac", {"lid_velocity": lid_velocity})
    state = mac3d.init_state(cfg, device=device)
    return Case("cavity3d_mac", cfg, step, state, grid, {"bcs": bcs})


def _inlet_profile(perturb: float, yc, zc, domain):
    """The static (nz, ny) inlet modulation 1 + ε·sin(2πy/Ly)·sin(2πz/Lz)
    (float32 numpy), or None for ε = 0."""
    if not perturb:
        return None
    Zc, Yc = np.meshgrid(zc, yc, indexing="ij")
    return (1.0 + perturb * np.sin(2 * np.pi * Yc / domain[1])
            * np.sin(2 * np.pi * Zc / domain[2])).astype(np.float32)


def _sphere_faces(nx, ny, nz, domain, center, refine_strength, refine_width, wake_length):
    """The body- and wake-refined stretched face vectors of the sphere cases."""
    from cfdsim_tpu_torch.models.mac_stretched import stretched_faces

    xf = stretched_faces(nx, domain[0], refine=[
        (center[0], refine_width, refine_strength),
        (center[0] + 0.5 * wake_length, wake_length, 0.5 * refine_strength)])
    yf = stretched_faces(ny, domain[1], refine=[(center[1], refine_width, refine_strength)])
    zf = stretched_faces(nz, domain[2], refine=[(center[2], refine_width, refine_strength)])
    return xf, yf, zf


def _sphere_ibm(ibm_scheme: str, xf, yf, zf, center, radius, masks, mask_c=None, *, device):
    """The step's IBM keywords: the penalization masks (and the θ mask), or
    the ghost stencils (and the cell-centred θ stencils)."""
    from cfdsim_tpu_torch.ibm_ghost import sphere_ghost_cells, sphere_ghost_ibm

    if ibm_scheme == "ghost":
        kw = dict(ibm_ghost=sphere_ghost_ibm(xf, yf, zf, center, radius, device=device))
        if mask_c is not None:
            kw["ibm_ghost_c"] = sphere_ghost_cells(xf, yf, zf, center, radius, device=device)
        return kw
    if ibm_scheme == "penalize":
        kw = dict(ibm_mask_u=masks[0], ibm_mask_v=masks[1], ibm_mask_w=masks[2])
        if mask_c is not None:
            kw["ibm_mask_c"] = mask_c
        return kw
    raise ValueError(f"unknown ibm_scheme {ibm_scheme!r}")


def _sphere_spec(v_inf, ibm_ramp_steps, masks, ibm_kwargs, faces=None,
                 inlet_profile=None) -> dict:
    """The explicit_spec of a sphere case: the inflow, the ramp, the
    penalization masks (u, v, w[, θ]) or the whole-grid ghost tables, the
    stretched face vectors, the (nz, ny) inlet modulation (None without
    one)."""
    spec = {"v_inf": v_inf, "ibm_ramp_steps": ibm_ramp_steps, "inlet_profile": inlet_profile,
            "ibm_ghost": ibm_kwargs.get("ibm_ghost"), "ibm_ghost_c": ibm_kwargs.get("ibm_ghost_c"),
            "ibm_masks": None if "ibm_ghost" in ibm_kwargs else masks}
    if faces is not None:
        spec.update(zip(("x_faces", "y_faces", "z_faces"), faces))
    return spec


def _ghost_extras(ibm_kwargs) -> dict:
    return {k: v for k, v in ibm_kwargs.items() if k in ("ibm_ghost", "ibm_ghost_c")}


def sphere_mac3d(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    poisson=None,
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    use_les: bool = False,
    perturb: float = 0.0,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Uniform flow past an immersed sphere on the 3D MAC grid: exact 3D DCT
    projection, TVD convection, potential-flow start; a D = 1 sphere in a
    (16D, 8D, 8D) box at 12 cells/D. Drag Cd = ``extras["coeff_scale"]``·fx
    (Schiller–Naumann 1.09 at Re = 100). ``ibm_scheme="ghost"``: ghost-cell
    stencils in place of the penalization masks; ``perturb`` a static inlet
    modulation 1 + ε·sin(2πy/Ly)·sin(2πz/Lz) that breaks the symmetry."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import _uniform_faces, potential_flow_sphere_mac3d, sphere_masks_mac3d
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1], z_max=domain[2],
                  centering="cell")
    masks = sphere_masks_mac3d(grid, center, radius, profile=ibm_profile)
    ibm_kwargs = _sphere_ibm(ibm_scheme, *_uniform_faces(grid), center, radius, masks,
                             device=device)
    h = min(grid.dx, grid.dy, grid.dz)
    defaults = dict(cfl_target=0.4, dt_max=0.4 * h / max(v_inf, 1e-10), dt_min=1e-6,
                    max_velocity=5.0 * v_inf, use_les=use_les)
    defaults.update(cfg_overrides)
    cfg = mac3d.MAC3DConfig(
        grid=grid, nu=v_inf * 2 * radius / Re, scheme=scheme,
        poisson=_poisson_spec(poisson, Poisson3DConfig) or Poisson3DConfig(method="dct"),
        **defaults)
    yc = (np.arange(ny) + 0.5) * (domain[1] / ny)
    zc = (np.arange(nz) + 0.5) * (domain[2] / nz)
    profile = _inlet_profile(perturb, yc, zc, domain)
    bcs = mac3d.external_flow_bcs3d(v_inf, inlet_profile=profile, device=device)
    step = mac3d.make_step(cfg, bcs, ibm_ramp_steps=ibm_ramp_steps, device=device, **ibm_kwargs)
    step.explicit_spec = ("sphere", _sphere_spec(v_inf, ibm_ramp_steps, masks, ibm_kwargs,
                                                 inlet_profile=profile))
    u0, v0, w0 = potential_flow_sphere_mac3d(grid, center, radius, v_inf, *masks)
    state = mac3d.init_state(cfg, u0=u0, v0=v0, w0=w0, device=device)
    return Case("sphere_mac3d", cfg, step, state, grid,
                {"ibm_masks": masks, "center": center, "radius": radius, "v_inf": v_inf,
                 "bcs": bcs, "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
                 **_ghost_extras(ibm_kwargs)})


def sphere_stretched(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    refine_strength: float = 3.0,
    refine_width: float = 1.2,
    wake_length: float = 4.0,
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    perturb: float = 0.0,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Flow past a sphere on a body- and wake-refined stretched 3D MAC grid
    (~30 cells/D near the body at the defaults): exact 3D fast
    diagonalization, TVD convection, volume-weighted forces and an
    area-weighted mass-consistent outflow. ``ibm_scheme="ghost"``: the
    ghost-cell wall, no slip exactly on r = R."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import potential_flow_sphere_faces, sphere_masks_faces
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.models import mac_stretched3d as ms3

    xf, yf, zf = _sphere_faces(nx, ny, nz, domain, center, refine_strength, refine_width,
                               wake_length)
    h_min = float(min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min()))
    defaults = dict(cfl_target=0.4, dt_max=0.4 * h_min / max(v_inf, 1e-10), dt_min=1e-6,
                    max_velocity=5.0 * v_inf)
    defaults.update(cfg_overrides)
    cfg = ms3.StretchedMAC3DConfig(nx=nx, ny=ny, nz=nz, nu=v_inf * 2 * radius / Re,
                                   scheme=scheme, **defaults)
    masks = sphere_masks_faces(xf, yf, zf, center, radius, profile=ibm_profile)
    ibm_kwargs = _sphere_ibm(ibm_scheme, xf, yf, zf, center, radius, masks, device=device)
    yc = 0.5 * (yf[:-1] + yf[1:])
    zc = 0.5 * (zf[:-1] + zf[1:])
    # the x-face areas h_y⊗h_z weight the outflow's mass balance
    fw = np.diff(zf)[:, None] * np.diff(yf)[None, :]
    profile = _inlet_profile(perturb, yc, zc, domain)
    bcs = mac3d.external_flow_bcs3d(v_inf, inlet_profile=profile, face_weights=fw, device=device)
    step = ms3.make_step(cfg, bcs, xf, yf, zf, ibm_ramp_steps=ibm_ramp_steps, device=device,
                         **ibm_kwargs)
    step.explicit_spec = ("sphere_stretched", _sphere_spec(
        v_inf, ibm_ramp_steps, masks, ibm_kwargs, (xf, yf, zf), inlet_profile=profile))
    u0, v0, w0 = potential_flow_sphere_faces(xf, yf, zf, center, radius, v_inf, *masks)
    state = ms3.init_state(cfg, u0=u0, v0=v0, w0=w0, device=device)
    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1], z_max=domain[2],
                  centering="cell")  # the nominal descriptor
    return Case("sphere_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "z_faces": zf, "ibm_masks": masks,
                 "center": center, "radius": radius, "v_inf": v_inf, "h_min": h_min,
                 "bcs": bcs, "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
                 **_ghost_extras(ibm_kwargs)})


def heated_sphere(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    Pr: float = 0.7,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    theta_scheme: str = "upwind",
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Forced convection from an isothermal sphere (θ = 1 body in a θ = 0
    stream, ``models/transport3d.py``): the heat flux from the θ forcing,
    the Nusselt number against Ranz–Marshall Nu = 2 + 0.6·Re^½·Pr^⅓.
    Below 16 cells/D at Re > 150 the uniform grid under-resolves the
    thermal boundary layer (a warning says so)."""
    import warnings

    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import (
        _uniform_faces,
        potential_flow_sphere_mac3d,
        sphere_mask_cells,
        sphere_masks_mac3d,
    )
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.models import transport3d as t3

    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1], z_max=domain[2],
                  centering="cell")
    masks = sphere_masks_mac3d(grid, center, radius, profile=ibm_profile)
    faces = _uniform_faces(grid)
    mask_c = sphere_mask_cells(*faces, center, radius, profile=ibm_profile, width=grid.dx)
    ibm_kwargs = _sphere_ibm(ibm_scheme, *faces, center, radius, masks, mask_c, device=device)
    h = min(grid.dx, grid.dy, grid.dz)
    cells_per_d = 2 * radius / max(grid.dx, grid.dy, grid.dz)
    if Re > 150.0 and cells_per_d < 16.0:
        warnings.warn(
            f"heated_sphere at Re={Re:g} with {cells_per_d:.0f} cells/D: the uniform grid "
            "under-resolves the thermal boundary layer; use heated_sphere_stretched or "
            "raise the resolution.", stacklevel=2)
    defaults = dict(cfl_target=0.4, dt_max=0.4 * h / max(v_inf, 1e-10),
                    max_velocity=5.0 * v_inf)
    defaults.update(cfg_overrides)
    cfg = t3.Transport3DConfig(grid=grid, nu=v_inf * 2 * radius / Re, prandtl=Pr, scheme=scheme,
                               theta_scheme=theta_scheme, body_diameter=2 * radius, **defaults)
    bcs = mac3d.external_flow_bcs3d(v_inf, device=device)
    step = t3.make_step(cfg, bcs, ibm_ramp_steps=ibm_ramp_steps, device=device, **ibm_kwargs)
    step.explicit_spec = ("heated_sphere", _sphere_spec(v_inf, ibm_ramp_steps,
                                                        (*masks, mask_c), ibm_kwargs))
    u0, v0, w0 = potential_flow_sphere_mac3d(grid, center, radius, v_inf, *masks)
    state = t3.init_state(cfg, u0=u0, v0=v0, w0=w0, device=device)
    return Case("heated_sphere", cfg, step, state, grid,
                {"ibm_masks": (*masks, mask_c), "center": center, "radius": radius,
                 "v_inf": v_inf, "bcs": bcs,
                 "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
                 **_ghost_extras(ibm_kwargs)})


def heated_sphere_stretched(
    nx: int = 192,
    ny: int = 96,
    nz: int = 96,
    Re: float = 100.0,
    Pr: float = 0.7,
    v_inf: float = 1.0,
    radius: float = 0.5,
    center: tuple[float, float, float] = (4.0, 4.0, 4.0),
    domain: tuple[float, float, float] = (16.0, 8.0, 8.0),
    scheme: str = "tvd",
    theta_scheme: str = "upwind",
    refine_strength: float = 3.0,
    refine_width: float = 1.2,
    wake_length: float = 4.0,
    ibm_ramp_steps: int = 200,
    ibm_profile: str = "sharp",
    ibm_scheme: str = "penalize",
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Forced convection from an isothermal sphere on the body- and
    wake-refined stretched grid of ``sphere_stretched``: the stretched
    momentum step composed with a metric-weighted θ update
    (``transport3d.make_stretched_step``)."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import (
        potential_flow_sphere_faces,
        sphere_mask_cells,
        sphere_masks_faces,
    )
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.models import transport3d as t3

    xf, yf, zf = _sphere_faces(nx, ny, nz, domain, center, refine_strength, refine_width,
                               wake_length)
    h_min = float(min(np.diff(xf).min(), np.diff(yf).min(), np.diff(zf).min()))
    masks = sphere_masks_faces(xf, yf, zf, center, radius, profile=ibm_profile)
    mask_c = sphere_mask_cells(xf, yf, zf, center, radius, profile=ibm_profile)
    ibm_kwargs = _sphere_ibm(ibm_scheme, xf, yf, zf, center, radius, masks, mask_c,
                             device=device)
    grid = Grid3D(nx=nx, ny=ny, nz=nz, x_max=domain[0], y_max=domain[1], z_max=domain[2],
                  centering="cell")  # the nominal descriptor
    defaults = dict(cfl_target=0.4, dt_max=0.4 * h_min / max(v_inf, 1e-10),
                    max_velocity=5.0 * v_inf)
    defaults.update(cfg_overrides)
    cfg = t3.Transport3DConfig(grid=grid, nu=v_inf * 2 * radius / Re, prandtl=Pr, scheme=scheme,
                               theta_scheme=theta_scheme, body_diameter=2 * radius, **defaults)
    fw = np.diff(zf)[:, None] * np.diff(yf)[None, :]
    bcs = mac3d.external_flow_bcs3d(v_inf, face_weights=fw, device=device)
    step = t3.make_stretched_step(cfg, bcs, xf, yf, zf, ibm_ramp_steps=ibm_ramp_steps,
                                  device=device, **ibm_kwargs)
    step.explicit_spec = ("heated_sphere_stretched", _sphere_spec(
        v_inf, ibm_ramp_steps, (*masks, mask_c), ibm_kwargs, (xf, yf, zf)))
    u0, v0, w0 = potential_flow_sphere_faces(xf, yf, zf, center, radius, v_inf, *masks)
    state = t3.init_state(cfg, u0=u0, v0=v0, w0=w0, device=device)
    return Case("heated_sphere_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "z_faces": zf, "ibm_masks": (*masks, mask_c),
                 "center": center, "radius": radius, "v_inf": v_inf, "h_min": h_min,
                 "bcs": bcs, "coeff_scale": 2.0 / (v_inf**2 * np.pi * radius**2),
                 **_ghost_extras(ibm_kwargs)})


def cavity3d_stretched(
    n: int = 48,
    Re: float = 400.0,
    lid_velocity: float = 1.0,
    beta: float = 1.5,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """3D lid-driven cavity on a tanh wall-clustered stretched MAC grid with
    the exact 3D fast-diagonalization pressure solve; the lid at z_hi
    moving in +x, as in ``cavity3d``."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import mac_stretched3d as ms3
    from cfdsim_tpu_torch.models.mac_stretched import wall_clustered_faces

    xf = yf = zf = wall_clustered_faces(n, 1.0, beta=beta)
    h_min = float((xf[1:] - xf[:-1]).min())
    defaults = dict(cfl_target=0.4, dt_max=0.4 * h_min / max(lid_velocity, 1e-10),
                    max_velocity=5.0 * lid_velocity)
    defaults.update(cfg_overrides)
    cfg = ms3.StretchedMAC3DConfig(nx=n, ny=n, nz=n, nu=lid_velocity / Re, **defaults)
    bcs = ms3.cavity3d_bcs(lid_velocity)
    step = ms3.make_step(cfg, bcs, xf, yf, zf, device=device)
    step.explicit_spec = ("cavity3d_stretched", {"x_faces": xf, "y_faces": yf, "z_faces": zf,
                                                 "lid_velocity": lid_velocity})
    state = ms3.init_state(cfg, device=device)
    grid = Grid3D(nx=n, ny=n, nz=n)  # the nominal uniform descriptor
    return Case("cavity3d_stretched", cfg, step, state, grid,
                {"x_faces": xf, "y_faces": yf, "z_faces": zf, "beta": beta,
                 "lid_velocity": lid_velocity, "bcs": bcs})


def heated_cube(
    n: int = 48,
    Ra: float = 1e4,
    Pr: float = 0.71,
    theta_scheme: str = "central",
    poisson=None,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Differentially heated cube (3D Boussinesq convection on the 3D MAC
    tier): hot x = 0 wall, cold x = 1, adiabatic elsewhere, gravity −z; the
    Tric, Labrosse & Betrouni (2000) benchmark (Nu = 2.054 at Ra = 1e4,
    4.337 at Ra = 1e5)."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import boussinesq3d as b3
    from cfdsim_tpu_torch.solvers.poisson3d import Poisson3DConfig

    grid = Grid3D(nx=n, ny=n, nz=n, centering="cell")
    if poisson is not None:
        cfg_overrides["poisson"] = _poisson_spec(poisson, Poisson3DConfig)
    cfg = b3.Boussinesq3DConfig(grid=grid, rayleigh=Ra, prandtl=Pr, theta_scheme=theta_scheme,
                                **cfg_overrides)
    step = b3.make_step(cfg, device=device)
    step.explicit_spec = ("heated_cube", {})
    state = b3.init_state(cfg, device=device)
    return Case("heated_cube", cfg, step, state, grid, {"Ra": Ra, "Pr": Pr})


def wedge(
    nx: int = 400,
    ny: int = 200,
    mach: float = 2.0,
    wedge_angle_deg: float = 10.0,
    wedge_start_x: float = 0.5,
    domain: tuple[float, float] = (2.0, 1.0),
    flux: str = "hllc",
    cfl: float = 0.4,
    reconstruction: str = "none",
    wall_treatment: str = "zero_momentum",
    frame: str = "lab",
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Supersonic flow over a wedge, the oblique-shock benchmark (reference
    ``ShockwaveSolver`` v1_shock.py:225-328: M = 2, 10° wedge).

    ``frame="lab"``: the embedded wedge under horizontal inflow, its solid
    by ``wall_treatment`` ``"zero_momentum"`` (reference parity,
    v1_shock.py:312-313) or ``"ghost"`` (the mirror-ghost slip wall of
    ``ibm.wedge_slip_ghost_map``). ``frame="wedge_aligned"``: the frame
    rotated by the wedge angle, so the wedge surface is the flat bottom
    grid line (slip wall from ``wedge_start_x`` on, pass-through before it)
    and the freestream enters at −θ; extras carry ``frame_angle`` (β =
    atan(slope) + θ)."""
    from cfdsim_tpu_torch import ibm
    from cfdsim_tpu_torch.models import compressible as comp

    grid = Grid(nx=nx, ny=ny, x_max=domain[0], y_max=domain[1], centering="cell")
    cfg = comp.CompressibleConfig(grid=grid, flux=flux, cfl=cfl, reconstruction=reconstruction,
                                  **cfg_overrides)
    theta = np.deg2rad(wedge_angle_deg)
    # the v sign flip of a reflecting wall, per component
    flip_v = torch.tensor([1.0, 1.0, -1.0, 1.0], device=device)[:, None]

    if frame == "wedge_aligned":
        a0 = (cfg.gamma * 1.0 / 1.0) ** 0.5
        uu = mach * a0 * np.cos(theta)
        vv = -mach * a0 * np.sin(theta)
        E = 1.0 / (1.0 * (cfg.gamma - 1.0)) + 0.5 * (uu * uu + vv * vv)
        U_inf = np.asarray([1.0, uu, vv, E], np.float32)
        u_inf = torch.as_tensor(U_inf, device=device)[:, None]
        xs_idx = int(np.searchsorted(grid.x_coords(), wedge_start_x))
        keep_wall = torch.as_tensor((np.arange(grid.nx) >= xs_idx)[None, :], device=device).to(
            torch.float32)

        def bc(U, step, t):
            U = U.clone()
            # freestream in from the left and the top (flow points down-right)
            U[:, :, 0] = u_inf
            U[:, -1, :] = u_inf
            U[:, :, -1] = U[:, :, -2]  # outflow at x_hi
            # bottom: pass-through before the wedge tip, reflecting slip wall
            # from the tip on (the switch anchors the shock at wedge_start_x)
            row = U[:, 1, :]
            U[:, 0, :] = (row * flip_v) * keep_wall + row * (1.0 - keep_wall)
            return U

        step = comp.make_step(cfg, bc, device=device)
        step.explicit_spec = ("wedge", {"frame": frame, "u_inf": U_inf,
                                        "keep_wall": np.arange(grid.nx) >= xs_idx})
        state = comp.init_state(cfg, U_inf, device=device)
        return Case("wedge", cfg, step, state, grid,
                    {"U_inf": U_inf, "mach": mach, "wedge_angle_deg": wedge_angle_deg,
                     "wedge_start_x": wedge_start_x, "frame_angle": wedge_angle_deg})
    if frame != "lab":
        raise ValueError(f"unknown frame {frame!r}")

    U_inf = comp.freestream(cfg, mach)
    u_inf = torch.as_tensor(U_inf, device=device)[:, None]
    solid = ibm.wedge_mask(grid, theta, wedge_start_x)
    ghost_map = host_map = None
    if wall_treatment == "ghost":
        host_map = ibm.wedge_slip_ghost_map(grid, theta, wedge_start_x)
        ghost_map = ibm.ghost_map_to(host_map, device)
    elif wall_treatment != "zero_momentum":
        raise ValueError(f"unknown wall_treatment {wall_treatment!r}")

    def bc(U, step, t):
        U = U.clone()
        U[:, :, 0] = u_inf  # supersonic inflow at x_lo (v1_shock.py:279-283)
        U[:, :, -1] = U[:, :, -2]  # extrapolation outflow at x_hi (:284)
        # reflecting bottom wall (v sign flip), extrapolating top (:285-289)
        U[:, 0, :] = U[:, 1, :] * flip_v
        U[:, -1, :] = U[:, -2, :]
        if ghost_map is not None:
            U = ibm.apply_slip_wall_ghosts(U, ghost_map, cfg.gamma, cfg.eps, cfg.max_val)
        return U

    step = comp.make_step(cfg, bc, zero_momentum_mask=solid, device=device)
    step.explicit_spec = ("wedge", {"frame": frame, "u_inf": U_inf, "zero_momentum": solid,
                                    "ghost_map": host_map})
    state = comp.init_state(cfg, U_inf, device=device)
    return Case("wedge", cfg, step, state, grid,
                {"wedge_mask": solid, "U_inf": U_inf, "mach": mach,
                 "wedge_angle_deg": wedge_angle_deg, "wedge_start_x": wedge_start_x})


def cavity_supersonic(
    nx: int = 600,
    ny: int = 180,
    ng: int = 2,
    mach: float = 2.5,
    domain: tuple[float, float] = (2.0, 1.0),
    cavity_x: float = 0.5,
    cavity_length: float = 0.5,
    l_over_d: float = 2.0,
    flux: str = "rusanov",
    cfl: float = 0.3,
    artificial_viscosity: float = 1e-3,
    reconstruction: str = "muscl",
    real_geometry: bool = False,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Mach-2.5 flow over an open cavity (reference ``CavityFlowSolver``
    cavity_flow_v1.py:248-308: ng = 2 ghost cells, Rusanov fluxes, minmod
    limiting, artificial viscosity, the cavity block pinned to quiescent
    fluid each step, cavity_flow_v1.py:165-170). ``real_geometry=True``
    puts the actual solid there instead: a plate at y ≤ depth with the
    cavity cut out (zero-momentum solid), so the recirculating cavity flow
    develops."""
    from cfdsim_tpu_torch import ibm
    from cfdsim_tpu_torch.models import compressible as comp

    grid = Grid(nx=nx, ny=ny, ng=ng, x_max=domain[0], y_max=domain[1], centering="node")
    cfg = comp.CompressibleConfig(grid=grid, flux=flux, cfl=cfl, reconstruction=reconstruction,
                                  artificial_viscosity=artificial_viscosity, max_val=100.0,
                                  **cfg_overrides)
    U_inf = comp.freestream(cfg, mach)
    u_inf = torch.as_tensor(U_inf, device=device)[:, None, None]
    # the quiescent ρ_inf, p_inf block (cavity_flow_v1.py:166-170)
    pin_state = np.asarray([1.0, 0.0, 0.0, 1.0 / (cfg.gamma - 1.0)], np.float32)
    mask = ibm.cavity_mask(grid, cavity_x, cavity_length, cavity_length / l_over_d)
    pin = mask > 0.5

    def bc(U, step, t):
        U = U.clone()
        # inflow ghosts at x_lo, extrapolation at x_hi (cavity_flow_v1.py:154-157)
        U[:, :, :ng] = u_inf
        U[:, :, -ng:] = U[:, :, -ng - 1:-ng]
        # freestream top ghosts, reflecting bottom wall rows (:158-162)
        U[:, -ng:, :] = u_inf
        for k in range(ng):
            src = 2 * ng - 1 - k
            U[0, k, :] = U[0, src, :]
            U[1, k, :] = U[1, src, :]
            U[2, k, :] = -U[2, src, :]
            U[3, k, :] = U[3, src, :]
        return U

    if real_geometry:
        # the solid plate with the cavity cut out
        X, Y = grid.meshgrid()
        depth = cavity_length / l_over_d
        solid = (Y <= depth) & ~((X >= cavity_x) & (X <= cavity_x + cavity_length))
        keep = torch.as_tensor(1.0 - solid.astype(np.float32), device=device)

        def bc_real(U, step_i, t):
            # the ghosts, then momentum killed inside the plate (the inflow
            # ghost writes otherwise inject freestream below the lip)
            U = bc(U, step_i, t)
            U[1] *= keep
            U[2] *= keep
            return U

        step = comp.make_step(cfg, bc_real, zero_momentum_mask=solid, device=device)
        step.explicit_spec = ("cavity_supersonic", {
            "ng": ng, "u_inf": U_inf, "zero_momentum": solid,
            "plate_keep": 1.0 - solid.astype(np.float32)})
        extras = {"solid_mask": solid, "U_inf": U_inf}
    else:
        step = comp.make_step(cfg, bc, pin_mask=pin, pin_state=pin_state, device=device)
        step.explicit_spec = ("cavity_supersonic", {"ng": ng, "u_inf": U_inf, "pin_mask": pin,
                                                    "pin_state": pin_state})
        extras = {"cavity_mask": mask, "U_inf": U_inf, "pin_state": pin_state}
    state = comp.init_state(cfg, U_inf, device=device)
    state = state._replace(U=bc(state.U, state.step, state.t))
    return Case("cavity_supersonic", cfg, step, state, grid, extras)


def blast3d(
    n: int = 64,
    gamma: float = 1.4,
    p_ratio: float = 10.0,
    r0: float = 0.15,
    flux: str = "hllc",
    reconstruction: str = "muscl",
    cfl: float = 0.3,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """3D spherical blast in a closed reflective box: a high-pressure sphere
    of radius ``r0`` at the box centre drives an expanding spherical shock;
    the three axis profiles through the centre test the axis-isotropy of
    the dimension-split solver."""
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.models import compressible3d as c3

    grid = Grid3D(nx=n, ny=n, nz=n)
    cfg = c3.Compressible3DConfig(grid=grid, gamma=gamma, flux=flux,
                                  reconstruction=reconstruction, cfl=cfl, **cfg_overrides)
    h = 1.0 / n
    c = (np.arange(n) + 0.5) * h
    Z, Y, X = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2)
    p0 = torch.as_tensor(np.where(r <= r0, p_ratio, 1.0).astype(np.float32), device=device)
    zero = torch.zeros_like(p0)
    U0 = c3.prim_to_cons_3d(torch.ones_like(p0), zero, zero, zero, p0, gamma)

    def bc(U, step, t):
        # reflective on all six faces, z, then y, then x, each on what the
        # previous axis wrote: the adjacent interior layer, normal momentum
        # flipped
        U = U.clone()
        for arr_axis, mom in ((1, 3), (2, 2), (3, 1)):  # z, y, x → ρw, ρv, ρu
            n_ax = U.shape[arr_axis]
            for dst, src in ((0, 1), (n_ax - 1, n_ax - 2)):
                U.select(arr_axis, dst).copy_(U.select(arr_axis, src))
                U[mom].select(arr_axis - 1, dst).neg_()
        return U

    step = c3.make_step(cfg, bc, device=device)
    step.explicit_spec = ("blast3d", {})
    state = c3.init_state(cfg, U0, device=device)
    return Case("blast3d", cfg, step, state, grid, {"r0": r0, "p_ratio": p_ratio})


def kolmogorov(
    ny: int = 360,
    aspect: float = 16.0 / 9.0,
    nu: float = 1e-3,
    dt: float = 0.01,
    forcing_wavenumber: int = 8,
    forcing_scale: float = 0.1,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Periodic Kolmogorov-forced turbulence on the spectral stable-fluids
    solver (reference plot.jl:14-24 defaults: 640×360, ν = 1e-3, dt =
    0.01, sin(8πy) forcing)."""
    from cfdsim_tpu_torch.models import spectral as spec

    cfg = spec.SpectralConfig(ny=ny, aspect=aspect, nu=nu, dt=dt,
                              forcing_wavenumber=forcing_wavenumber,
                              forcing_scale=forcing_scale, **cfg_overrides)
    step = spec.make_step(cfg, device=device)
    state = spec.init_state(cfg, device=device)
    grid = Grid(nx=cfg.nx, ny=cfg.ny, x_max=cfg.lx, y_max=1.0, centering="cell")
    return Case("kolmogorov", cfg, step, state, grid)


def kolmogorov_ps(
    ny: int = 512,
    aspect: float = 1.0,
    nu: float = 1e-5,
    dt: float = 2e-3,
    forcing_wavenumber: int = 8,
    forcing_scale: float = 0.1,
    noise: float = 0.0,
    seed: int = 0,
    *,
    device,
    **cfg_overrides,
) -> Case:
    """Kolmogorov flow on the pseudo-spectral vorticity solver
    (``models/spectral_ps.py``): the same physics as ``kolmogorov`` with no
    advection dissipation, the forcing per unit time; ``noise`` seeds the
    instability (``default_rng(seed)``). ``extras["velocities"]`` maps a
    state to (u, v)."""
    from cfdsim_tpu_torch.models import spectral_ps as ps

    cfg = ps.PseudoSpectralConfig(ny=ny, aspect=aspect, nu=nu, dt=dt,
                                  forcing_wavenumber=forcing_wavenumber,
                                  forcing_scale=forcing_scale, **cfg_overrides)
    step = ps.make_step(cfg, device=device)
    state = ps.init_state(cfg, noise=noise, seed=seed, device=device)
    grid = Grid(nx=cfg.nx, ny=cfg.ny, x_max=cfg.lx, y_max=1.0, centering="cell")
    return Case("kolmogorov_ps", cfg, step, state, grid,
                {"velocities": lambda s: ps.velocities(cfg, s)})



def _fem_case(name, mesh, spaces, cfg, g, precision, scheme, grid, extras, device,
              perturb_fn=None):
    """The FEM cases' common tail: element tables in ``precision``, the
    Stokes initial state (falling back to the Dirichlet lift where the
    solve comes back non-finite), an optional perturbation of it, the
    monolithic or projection step and the sampler onto ``grid``."""
    from cfdsim_tpu_torch.fem.assembly import build_element_ops
    from cfdsim_tpu_torch.fem.sample import build_sampler
    from cfdsim_tpu_torch.models import fem as mfem

    if precision not in ("fp32", "fp64"):
        raise ValueError(f"unknown precision {precision!r}")
    if scheme not in ("monolithic", "projection"):
        raise ValueError(f"unknown scheme {scheme!r}")
    ops = build_element_ops(spaces, torch.float64 if precision == "fp64" else torch.float32,
                            device=device)
    # Stokes init: restart 40 with extra block-preconditioner sweeps; a
    # non-finite solve falls back to the Dirichlet lift
    stokes_cfg = dataclasses.replace(cfg, gmres_restart=40, gmres_maxiter=30, pc_sweeps=4)
    state = mfem.solve_stokes(ops, stokes_cfg, g)
    if not bool(torch.isfinite(state.u).all()):
        state = state._replace(u=torch.as_tensor(g, device=device).to(ops.dtype),
                               p=torch.zeros((ops.n_p,), dtype=ops.dtype, device=device))
    if perturb_fn is not None:
        state = state._replace(u=perturb_fn(state.u))
    force_nodes = spaces.dirichlet_tag_nodes.get("cylinder")
    if scheme == "projection":
        step = mfem.make_projection_step(ops, cfg, g, mesh.tags["outlet"],
                                         force_nodes=force_nodes)
        step.explicit_spec = ("fem", {"g": g, "force_nodes": force_nodes,
                                      "p_out_nodes": mesh.tags["outlet"]})
        # seed the pressure-increment carry: the CG warm start
        state = state._replace(phi=torch.zeros_like(state.p))
    else:
        step = mfem.make_step(ops, cfg, g, force_nodes=force_nodes)
        step.explicit_spec = ("fem", {"g": g, "force_nodes": force_nodes})
    sampler = build_sampler(spaces, grid.x_coords(), grid.y_coords(), device=device)
    return Case(name, cfg, step, state, grid,
                {"mesh": mesh, "spaces": spaces, "ops": ops, "sampler": sampler, "g": g,
                 **extras})


def cylinder_fem(
    re: float = 100.0,
    space: str = "p1p1",
    h_far: float = 0.2,
    h_near: float = 0.02,
    dt: float = 0.05,
    v_inf: float = 1.0,
    tau_h=None,
    wake_refine: bool = False,
    gmres_tol: float = 1e-5,
    perturb: float = 0.03,
    theta: float = 1.0,
    precision: str = "fp32",
    scheme: str = "monolithic",
    pp_tol: float = 1e-6,
    rotational: float = 0.0,
    supg: float = 0.0,
    stab: str = "bp",
    viz_shape: tuple = (200, 300),
    mesh=None,
    *,
    device,
) -> Case:
    """Unstructured-FEM flow over a cylinder (the reference's Gridap
    "efficient" configuration: [-L, 8L]×[-2L, 2L], D = L = 1 at (3L, 0),
    uniform inlet V∞, no-slip walls and cylinder, h 0.02→0.2 grading, dt =
    0.05, semi-implicit P1-P1 + τ; ``space="p2p1"`` Taylor-Hood).
    ``wake_refine`` adds an h = 2·h_near wake band; ``scheme="projection"``
    the pressure-correction step; ``stab="pspg"`` the consistent
    stabilization; ``mesh`` an external TriMesh (e.g. ``fem.msh_io.read_msh``)
    whose geometry carries the cylinder's circle. Metrics fx/fy are the
    reaction drag and lift per unit density (Cd = 2·fx/(V∞²·D))."""
    from cfdsim_tpu_torch.fem.mesh import cylinder_mesh
    from cfdsim_tpu_torch.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu_torch.models.fem import FEMConfig

    if mesh is None:
        L = 1.0
        mesh = cylinder_mesh(
            h_far=h_far, h_near=h_near, x_span=(-L, 8 * L), y_span=(-2 * L, 2 * L),
            center=(3 * L, 0.0), radius=L / 2,
            wake_box=(3 * L, 7.5 * L, -1.0, 1.0) if wake_refine else None,
            h_wake=2 * h_near if wake_refine else None,
        )
    else:
        L = 2.0 * mesh.geometry["cylinder_radius"]
    cx, cy = mesh.geometry.get("cylinder_center", (3.0, 0.0))
    spaces = build_spaces(mesh, space)
    cfg = FEMConfig(nu=v_inf * L / re, dt=dt, space=space, v_inf=v_inf, tau_h=tau_h,
                    gmres_tol=gmres_tol, theta=theta, pp_tol=pp_tol, rotational=rotational,
                    supg=supg, stab=stab)
    g = dirichlet_values(spaces, {
        "inlet": lambda x, y: (v_inf + 0 * x, 0 * y),
        "walls": lambda x, y: (0 * x, 0 * y),
        "cylinder": lambda x, y: (0 * x, 0 * y),
    })

    def perturb_fn(u):
        # a one-sided v bump behind the body breaks the symmetry, so
        # shedding starts promptly
        xp, yp = spaces.u_points[:, 0], spaces.u_points[:, 1]
        bump = perturb * np.exp(-(((xp - (cx + L)) / (0.7 * L)) ** 2
                                  + ((yp - cy) / (0.7 * L)) ** 2))
        bump[spaces.dirichlet_mask] = 0.0
        u = u.clone()
        u[:, 1] += torch.as_tensor(bump, device=u.device).to(u.dtype)
        return u

    ny, nx = viz_shape
    # the reference's 300×200 window, centred on the body
    grid = Grid(nx=nx, ny=ny, x_min=cx - 3.5 * L, x_max=cx + 4 * L, y_min=cy - 1.5 * L,
                y_max=cy + 1.5 * L)
    return _fem_case("cylinder_fem", mesh, spaces, cfg, g, precision, scheme, grid,
                     {"re": re, "diameter": L}, device, perturb_fn if perturb else None)


def cavity_fem(
    n: int = 48,
    Re: float = 100.0,
    space: str = "p1p1",
    dt: float = 0.05,
    lid_velocity: float = 1.0,
    gmres_tol: float = 1e-5,
    theta: float = 1.0,
    stab: str = "bp",
    viz_shape: tuple = (128, 128),
    *,
    device,
) -> Case:
    """Lid-driven cavity on the unstructured FEM tier (the Ghia benchmark
    on a criss-cross triangulation): velocity Dirichlet on all four sides,
    lid u = V on the top edge with zeroed corners; the enclosed pressure is
    defined up to a constant (GMRES works in the quotient space).
    Monolithic only: the projection scheme needs outflow nodes."""
    from cfdsim_tpu_torch.fem.mesh import rectangle_mesh
    from cfdsim_tpu_torch.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu_torch.models.fem import FEMConfig

    mesh = rectangle_mesh(n, n, crisscross=True)
    spaces = build_spaces(mesh, space, dirichlet_tags=("inlet", "outlet", "walls", "cylinder"))
    cfg = FEMConfig(nu=lid_velocity / Re, dt=dt, space=space, v_inf=lid_velocity,
                    gmres_tol=gmres_tol, theta=theta, stab=stab)
    eps = 0.25 / n

    def lid(x, y):
        on_lid = (y > 1.0 - eps) & (x > eps) & (x < 1.0 - eps)
        return (lid_velocity * on_lid.astype(np.float64), 0.0 * y)

    zero = lambda x, y: (0.0 * x, 0.0 * y)  # noqa: E731
    g = dirichlet_values(spaces, {"walls": lid, "inlet": zero, "outlet": zero})
    ny, nx = viz_shape
    return _fem_case("cavity_fem", mesh, spaces, cfg, g, "fp32", "monolithic",
                     Grid(nx=nx, ny=ny), {"re": Re}, device)


def schafer_turek_fem(
    re: float = 100.0,
    space: str = "p1p1",
    h_near: float = 0.008,
    h_far: float = 0.04,
    dt: float = 0.0025,
    u_mean: float = 1.0,
    gmres_tol: float = 1e-5,
    theta: float = 1.0,
    wake_refine: bool = False,
    precision: str = "fp32",
    scheme: str = "monolithic",
    pp_tol: float = 1e-6,
    rotational: float = 0.0,
    supg: float = 0.0,
    stab: str = "bp",
    viz_shape: tuple = (120, 640),
    *,
    device,
) -> Case:
    """Schäfer–Turek 2D-2 on the FEM tier: channel [0, 2.2]×[0, 0.41], D =
    0.1 cylinder at (0.2, 0.2) (off centre: it sheds by itself), parabolic
    inlet with U_max = 1.5·ū. Published at Re = ūD/ν = 100: Cd 3.22–3.24,
    Cl amplitude ≈ 1.0, St 0.295–0.305; Cd = 2·fx/(ū²D), Cl = 2·fy/(ū²D)
    (``extras["coeff_scale"]``). The steady 2D-1 variant is re = 20,
    u_mean = 0.2."""
    from cfdsim_tpu_torch.fem.mesh import cylinder_mesh
    from cfdsim_tpu_torch.fem.spaces import build_spaces, dirichlet_values
    from cfdsim_tpu_torch.models.fem import FEMConfig

    H, Lx, D = 0.41, 2.2, 0.1
    u_max = 1.5 * u_mean
    mesh = cylinder_mesh(
        h_far=h_far, h_near=h_near, x_span=(0.0, Lx), y_span=(0.0, H), center=(0.2, 0.2),
        radius=D / 2, grade=0.2,
        wake_box=(0.2, 1.4, 0.06, 0.35) if wake_refine else None,
        h_wake=2.0 * h_near if wake_refine else None,
    )
    spaces = build_spaces(mesh, space)
    cfg = FEMConfig(nu=u_mean * D / re, dt=dt, space=space, v_inf=u_max, gmres_tol=gmres_tol,
                    theta=theta, pp_tol=pp_tol, rotational=rotational, supg=supg, stab=stab)
    g = dirichlet_values(spaces, {
        "inlet": lambda x, y: (4.0 * u_max * y * (H - y) / H**2, 0 * y),
        "walls": lambda x, y: (0 * x, 0 * y),
        "cylinder": lambda x, y: (0 * x, 0 * y),
    })
    ny, nx = viz_shape
    grid = Grid(nx=nx, ny=ny, x_min=0.0, x_max=Lx, y_min=0.0, y_max=H)
    return _fem_case("schafer_turek_fem", mesh, spaces, cfg, g, precision, scheme, grid,
                     {"re": re, "diameter": D, "u_mean": u_mean,
                      "coeff_scale": 2.0 / (u_mean**2 * D)}, device)

CASES: dict[str, Callable[..., Case]] = {
    "cavity": lid_cavity,
    "cavity3d": cavity3d,
    "cavity3d_mac": cavity3d_mac,
    "cavity3d_stretched": cavity3d_stretched,
    "cavity_mac": lid_cavity_mac,
    "cavity_stretched": cavity_stretched,
    "channel": channel,
    "heated_cavity": heated_cavity,
    "heated_cube": heated_cube,
    "heated_sphere": heated_sphere,
    "heated_sphere_stretched": heated_sphere_stretched,
    "rayleigh_benard": rayleigh_benard,
    "sphere": sphere_mac3d,
    "sphere_stretched": sphere_stretched,
    "cylinder": cylinder,
    "cylinder_mac": cylinder_mac,
    "cylinder_oscillating": cylinder_oscillating,
    "cylinder_stretched": cylinder_stretched,
    "transport": transport,
    "wedge": wedge,
    "cavity_supersonic": cavity_supersonic,
    "blast3d": blast3d,
    "kolmogorov": kolmogorov,
    "kolmogorov_ps": kolmogorov_ps,
    "cylinder_fem": cylinder_fem,
    "cavity_fem": cavity_fem,
    "schafer_turek_fem": schafer_turek_fem,
}


def build(name: str, **kwargs) -> Case:
    """Build a named case (``device=`` is required)."""
    try:
        builder = CASES[name]
    except KeyError:
        raise KeyError(f"unknown case {name!r}; available: {sorted(CASES)}") from None
    return builder(**kwargs)
