"""Passive-scalar transport on rank blocks: the explicit counterpart of
``models/transport.py::CoupledStep`` (the JAX package shards the coupled
step only through GSPMD and has no explicit one).

The flow is the collocated :class:`~cfdsim_tpu_torch.parallel.explicit.
ExplicitStep` (the lid cavity of the ``transport`` case); θ, cut like the
pressure, then takes the transport config's ``substeps`` updates of
dt/substeps with the freshly projected u and v, as the single-device
scalar step does: upwind or central convection and the 5-point Laplacian,
both on one edge-halo exchange of (u, v, θ) per substep (every operator is
plus-shaped), zero on the global frame, and then θ's Dirichlet values
written on the global edges this rank holds, in the order x_lo, x_hi,
y_lo, y_hi. θ's minimum and maximum ride one MAX all-reduce (the minimum
as a negated maximum) and its sum one SUM, for the mean.
"""

from __future__ import annotations

import torch
from torch import nn

from cfdsim_tpu_torch.models.transport import CoupledMetrics, CoupledState, TransportConfig
from cfdsim_tpu_torch.ops.convection import convection_central, convection_upwind
from cfdsim_tpu_torch.ops.stencil import laplacian
from cfdsim_tpu_torch.parallel.explicit import ExplicitStep, make_cavity_explicit_step
from cfdsim_tpu_torch.parallel.halo import sharded_stencil
from cfdsim_tpu_torch.parallel.mesh import GridMesh, pmax, psum


class TransportExplicitStep(nn.Module):
    """``step(state, cfl_scale) -> (CoupledState, CoupledMetrics)`` on this
    rank's blocks of a ``CoupledState``; see
    :func:`make_transport_explicit_step`."""

    def __init__(self, flow: ExplicitStep, transport_cfg: TransportConfig, theta_edges,
                 mesh: GridMesh):
        super().__init__()
        if transport_cfg.scheme not in ("upwind", "central"):
            raise ValueError(f"unknown transport scheme {transport_cfg.scheme!r}")
        if flow.use_ibm or flow.needs_y or flow.cfg.masked_poisson:
            raise ValueError("the transport step rides a flow step that takes no extra blocks")
        self.flow = flow
        self.transport_cfg = transport_cfg
        self.theta_edges = tuple(float(x) for x in theta_edges)
        self.cfg, self.mesh, self.device = flow.cfg, mesh, flow.device
        self.local_shape = flow.local_shape
        self.reads_host = False
        self.collectives = True
        self.n_global = flow.n_global

    def _theta_bc(self, th):
        """θ's edge values (x_lo, x_hi, y_lo, y_hi) on the global edges this
        rank holds, in place and in that order, as the case's ``theta_bc``."""
        mesh = self.mesh
        x_lo, x_hi, y_lo, y_hi = self.theta_edges
        if mesh.ix == 0:
            th[:, 0] = x_lo
        if mesh.ix == mesh.px - 1:
            th[:, -1] = x_hi
        if mesh.iy == 0:
            th[0, :] = y_lo
        if mesh.iy == mesh.py - 1:
            th[-1, :] = y_hi
        return th

    def forward(self, state: CoupledState, cfl_scale):
        tcfg = self.transport_cfg
        mesh = self.mesh
        dx, dy = tcfg.grid.dx, tcfg.grid.dy
        conv = convection_upwind if tcfg.scheme == "upwind" else convection_central
        flow, metrics = self.flow(state.flow, cfl_scale)
        u, v = flow.u.float(), flow.v.float()
        theta = state.theta
        dt_sub = metrics.dt / tcfg.substeps
        for _ in range(tcfg.substeps):
            c, d = sharded_stencil(
                lambda a, b, th: (conv(a, b, th, dx, dy), laplacian(th, dx, dy)),
                (u, v, theta), mesh, 1, corners=False, mask=self.flow.imask)
            theta = self._theta_bc(theta + dt_sub * (tcfg.kappa * d - c))
        neg_min, th_max = pmax(torch.stack([-theta.amin(), theta.amax()]), mesh).unbind(0)
        th_sum = psum(theta.sum(), mesh)
        return CoupledState(flow=flow, theta=theta), CoupledMetrics(
            flow=metrics, theta_min=-neg_min, theta_max=th_max,
            theta_mean=th_sum / self.n_global)


def make_transport_explicit_step(flow_cfg, transport_cfg: TransportConfig, mesh: GridMesh,
                                 lid_velocity: float = 1.0, hot_lid: float = 1.0, *,
                                 device=None) -> TransportExplicitStep:
    """The explicit-communication step of the ``transport`` case: the lid
    cavity's explicit step (``flow_cfg``) and θ = ``hot_lid`` on the lid
    row, 0 on the other walls. ``step(state, cfl_scale)`` on this rank's
    blocks of the ``CoupledState`` (the flow state and θ cut alike)."""
    flow = make_cavity_explicit_step(flow_cfg, mesh, lid_velocity, device=device)
    return TransportExplicitStep(flow, transport_cfg, (0.0, 0.0, 0.0, hot_lid), mesh)
