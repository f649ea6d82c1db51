"""Named case registry (``cfdsim_tpu.cases``).

Each named case is a builder that returns a ready-to-run bundle: static
config, step module and initial state, all on the ``device`` the caller
names: ``"cavity"``, ``"channel"``, ``"cylinder"`` and ``"transport"`` so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from cfdsim_tpu_torch import boundary
from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.ibm import cylinder_masks, potential_flow_cylinder
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


def _poisson_spec(poisson):
    """Accept a PoissonConfig or a CLI-friendly "method[:iters[:omega]]"
    string (e.g. "mg:2", "rbsor:100:1.7", "dct")."""
    if poisson is None or isinstance(poisson, PoissonConfig):
        return poisson
    parts = str(poisson).split(":")
    kw = {"method": parts[0]}
    if len(parts) > 1:
        kw["iters"] = int(parts[1])
    if len(parts) > 2:
        kw["omega"] = float(parts[2])
    return PoissonConfig(**kw)


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


CASES: dict[str, Callable[..., Case]] = {
    "cavity": lid_cavity,
    "channel": channel,
    "cylinder": cylinder,
    "transport": transport,
}


def build(name: str, **kwargs) -> Case:
    """Build a named case (``device=`` is required)."""
    try:
        builder = CASES[name]
    except KeyError:
        raise KeyError(f"unknown case {name!r}; available: {sorted(CASES)}") from None
    return builder(**kwargs)
