"""Passive-scalar transport: coupled advection-diffusion over a flow field
(``cfdsim_tpu.models.transport``).

A scalar θ (temperature, dye) is advanced alongside the incompressible
solver in one step, with the convection and diffusion operators the
momentum equations use. The scalar update is plain torch on the card, as it
is plain XLA code in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.models.incompressible import IncompressibleState
from cfdsim_tpu_torch.ops.convection import convection_central, convection_upwind
from cfdsim_tpu_torch.ops.stencil import laplacian


class CoupledState(NamedTuple):
    flow: IncompressibleState
    theta: torch.Tensor

    # runner interface: time/step bookkeeping lives on the flow state
    @property
    def t(self):
        return self.flow.t

    @property
    def step(self):
        return self.flow.step


class CoupledMetrics(NamedTuple):
    flow: object  # StepMetrics
    theta_min: torch.Tensor
    theta_max: torch.Tensor
    theta_mean: torch.Tensor

    # runner/monitor interface: passthrough to the flow metrics
    @property
    def dt(self):
        return self.flow.dt

    @property
    def energy(self):
        return self.flow.energy

    @property
    def max_vel(self):
        return self.flow.max_vel

    @property
    def div_post(self):
        return self.flow.div_post


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    grid: Grid
    kappa: float  # scalar diffusivity
    scheme: str = "upwind"  # upwind (monotone) | central
    # The scalar's explicit stability bound (advection number + diffusion
    # number ≤ 1) is usually tighter than the momentum dt the flow solver
    # picks, so the scalar takes `substeps` sub-steps of dt/substeps.
    substeps: int = 2


def make_transport_step(cfg: TransportConfig, bc_fn: Callable) -> Callable:
    """``step(theta, u, v, dt) -> theta``: one explicit advection-diffusion
    update with the scalar's own BCs applied as edge writes."""
    dx, dy = cfg.grid.dx, cfg.grid.dy
    conv = convection_upwind if cfg.scheme == "upwind" else convection_central

    def step(theta, u, v, dt):
        dt_sub = dt / cfg.substeps
        for _ in range(cfg.substeps):
            c = conv(u, v, theta, dx, dy)
            d = laplacian(theta, dx, dy)
            theta = bc_fn(theta + dt_sub * (cfg.kappa * d - c))
        return theta

    return step


class CoupledStep(nn.Module):
    """``step(CoupledState, cfl_scale) -> (CoupledState, CoupledMetrics)``:
    a flow step, then the scalar advected by the freshly projected velocity
    field. The flow step is a submodule, so its buffers are this module's;
    ``device``, ``cfg`` and ``reads_host`` are the flow step's."""

    def __init__(self, flow_step: Callable, transport_cfg: TransportConfig, theta_bc: Callable):
        super().__init__()
        self.flow_step = flow_step
        self.t_step = make_transport_step(transport_cfg, theta_bc)
        self.cfg = getattr(flow_step, "cfg", None)
        self.transport_cfg = transport_cfg
        self.device = getattr(flow_step, "device", None)
        self.reads_host = getattr(flow_step, "reads_host", True)

    def forward(self, state: CoupledState, cfl_scale):
        flow, metrics = self.flow_step(state.flow, cfl_scale)
        theta = self.t_step(state.theta, flow.u, flow.v, metrics.dt)
        m = CoupledMetrics(
            flow=metrics,
            theta_min=theta.amin(),
            theta_max=theta.amax(),
            theta_mean=theta.mean(),
        )
        return CoupledState(flow=flow, theta=theta), m


def make_coupled_step(flow_step: Callable, transport_cfg: TransportConfig,
                      theta_bc: Callable) -> CoupledStep:
    """Fuse a flow step and a transport step into one update."""
    return CoupledStep(flow_step, transport_cfg, theta_bc)


def init_coupled(flow_state: IncompressibleState, theta0) -> CoupledState:
    """θ on the flow state's device, float32."""
    theta = torch.as_tensor(theta0, dtype=torch.float32, device=flow_state.u.device).clone()
    return CoupledState(flow=flow_state, theta=theta)
