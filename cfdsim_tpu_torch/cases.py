"""Named case registry (``cfdsim_tpu.cases``).

Each named case is a builder that returns a ready-to-run bundle: static
config, step module and initial state, all on the ``device`` the caller
names. Only ``"cavity"`` is ported so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from cfdsim_tpu_torch import boundary
from cfdsim_tpu_torch.grid import Grid
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
    """Accept a PoissonConfig or a method name (e.g. "dct", as the CLI's
    ``--poisson dct`` passes it)."""
    if poisson is None or isinstance(poisson, PoissonConfig):
        return poisson
    return PoissonConfig(method=str(poisson))


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


CASES: dict[str, Callable[..., Case]] = {
    "cavity": lid_cavity,
}


def build(name: str, **kwargs) -> Case:
    """Build a named case (``device=`` is required)."""
    try:
        builder = CASES[name]
    except KeyError:
        raise KeyError(f"unknown case {name!r}; available: {sorted(CASES)}") from None
    return builder(**kwargs)
