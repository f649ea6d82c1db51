"""Unstructured FEM on ranks: element-partitioned assembly
(``cfdsim_tpu.parallel.fem_explicit``).

Each rank owns a contiguous slice of the elements. Its :class:`ElementOps`
(:func:`local_element_ops`) holds that slice's tables and its own
fixed-order scatter table, so an operator application is the
single-device assembly (``fem/assembly.py``: ``apply_ns``,
``apply_pspg``, ``apply_momentum_conv``, ``apply_su``, ``apply_grad_p``,
``apply_div_u``, ``apply_stiffness_p``) on the local slice, a partial
nodal vector of full length, and one SUM ``all_reduce`` over the world
that gives every rank the global result (the parts of one application go
through it packed). The DOF vectors, the mass and diagonal tables, the
block preconditioner, the two-level coarse levels and the Krylov loops
stay replicated, built from the full ops on every rank as in the JAX
package: the all-reduced sums are the same bits on every rank, so every
rank takes the same Krylov exits (each read on the host once per
iteration) and calls the same collectives.

- :func:`make_sharded_ns_apply`: the coupled (u, p) operator;
- :class:`ShardedFEMStep` (``make_step``): the monolithic step (θ-scheme,
  τ∇p·∇q or consistent PSPG), one all-reduce per GMRES matvec;
- :class:`ShardedFEMProjectionStep` (``make_projection_step``): the
  pressure-correction step (P1-P1 K_p, or the Taylor–Hood exact Schur
  operator at two all-reduces per CG matvec; SUPG on or off), one
  all-reduce per predictor matvec;
- :func:`solve_stokes_sharded`: the steady Stokes initial state.

Deliberate differences from the JAX package: the slices may differ by one
element, so no zero-weight padding elements are appended (``_pad_tables``);
the elements are split over every rank of the mesh (a 1×n mesh is the JAX
layout); there is no body force (the JAX steps take none) and no gradient
path (the JAX steps have no gradient test): a state that requires grad
raises. The Krylov iterations run eagerly (``capture=False``): a NCCL
all-reduce inside a captured CUDA graph is not measured here. A step reads
the host, so ``make_chunk`` runs it on the loop route.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch
import torch.distributed as dist
from torch import nn

from cfdsim_tpu_torch.fem.assembly import (
    ElementOps,
    apply_div_u,
    apply_grad_p,
    apply_mass_u,
    apply_momentum_conv,
    apply_ns,
    apply_pspg,
    apply_stiffness_p,
    apply_su,
    scatter_table,
)
from cfdsim_tpu_torch.models.fem import (
    FEMConfig,
    FEMProjectionStep,
    FEMState,
    FEMStep,
    _force_mask,
    _gmres,
    _ImplicitSolver,
    _lift,
    _preconditioner,
    _tau,
    build_schur_coarse,
)
from cfdsim_tpu_torch.parallel.explicit import step_device
from cfdsim_tpu_torch.parallel.mesh import GridMesh
from cfdsim_tpu_torch.solvers.fdm import full_fp32_matmul


def element_slice(n_elements: int, mesh: GridMesh) -> slice:
    """This rank's contiguous slice of the elements (sizes differ by at most
    one across the ranks)."""
    return slice(n_elements * mesh.rank // mesh.size,
                 n_elements * (mesh.rank + 1) // mesh.size)


def local_element_ops(ops: ElementOps, mesh: GridMesh) -> ElementOps:
    """The ops of this rank's element slice: the same DOF counts, Dirichlet
    mask and bases, the slice's per-element tables, and scatter tables built
    from the slice's DOF maps (each node's entries summed in a fixed order)."""
    sl = element_slice(ops.elem_u.shape[0], mesh)
    elem_u, elem_p = ops.elem_u[sl], ops.elem_p[sl]

    def table(elem, n):
        return torch.as_tensor(scatter_table(elem.cpu().numpy(), n), device=ops.device)

    return dataclasses.replace(
        ops, elem_u=elem_u, elem_p=elem_p, Gu=ops.Gu[sl], Gp=ops.Gp[sl], wq=ops.wq[sl],
        xq=ops.xq[sl], h_e=ops.h_e[sl], scatter_u=table(elem_u, ops.n_u),
        scatter_p=table(elem_p, ops.n_p))


def psum_parts(mesh: GridMesh, *parts) -> list:
    """The sum over every rank of each partial vector, in one SUM
    ``all_reduce`` of the parts packed end to end."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    mesh.check(flat)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return [c.view(p.shape) for c, p in zip(flat.split([p.numel() for p in parts]), parts)]


def _psum(mesh: GridMesh, part):
    return psum_parts(mesh, part)[0]


def _refuse_grad(state: FEMState):
    if any(torch.is_tensor(x) and x.requires_grad for x in state):
        raise ValueError("the element-sharded FEM steps have no gradient path; use the "
                         "single-device step (models/fem.py) to differentiate")


class ShardedNSApply:
    """``apply(u, p, inv_dt=None, adv_u=None, nu=None) -> (yu, yp)``: the
    coupled operator of ``apply_ns`` assembled on this rank's elements
    (``local``, their stabilization ``tau``) and summed over the ranks
    (replicated in and out). The transient form (mass or convection
    present) takes the consistent PSPG continuity row when ``cfg.stab ==
    "pspg"``; the steady one the τ∇p·∇q row. ``nu`` overrides ``cfg.nu``
    (the θ-scheme's scaled calls)."""

    def __init__(self, ops: ElementOps, mesh: GridMesh, cfg: FEMConfig):
        self.mesh, self.cfg = mesh, cfg
        self.local = local_element_ops(ops, mesh)
        self.tau = _tau(self.local, cfg)
        self.pspg = cfg.stab == "pspg" and self.tau is not None

    def __call__(self, u, p, inv_dt=None, adv_u=None, nu=None):
        local, tau = self.local, self.tau
        nu = self.cfg.nu if nu is None else nu
        if self.pspg and (inv_dt is not None or adv_u is not None):
            yu, yp = apply_ns(local, u, p, nu, inv_dt, adv_u, None)
            yp = yp + apply_pspg(local, tau, u=u, p=p, inv_dt=inv_dt, adv_u=adv_u)
        else:
            yu, yp = apply_ns(local, u, p, nu, inv_dt, adv_u, tau)
        return psum_parts(self.mesh, yu, yp)


def make_sharded_ns_apply(ops: ElementOps, mesh: GridMesh, cfg: FEMConfig) -> ShardedNSApply:
    """The element-sharded coupled operator (:class:`ShardedNSApply`)."""
    return ShardedNSApply(ops, mesh, cfg)


class _ShardedImplicitSolver(_ImplicitSolver):
    """The monolithic system of ``models/fem.py`` with its operator, its θ
    and PSPG rhs shares and its reaction rows assembled on the rank's
    elements; the preconditioner (from the full ops) and the GMRES loop
    replicated, its iterations eager."""

    capture = False

    def __init__(self, ops, cfg, g, counts, mesh: GridMesh):
        super().__init__(ops, cfg, g, None, None, counts)
        self.mesh = mesh
        self.apply = make_sharded_ns_apply(ops, mesh, cfg)

    def opA(self, u_prev, inv_dt, x):
        u, p = x
        yu, yp = self.apply(u, p, inv_dt, self.th * u_prev, nu=self.th * self.cfg.nu)
        return (torch.where(self.ops.dir_mask[:, None], u, yu), yp)

    def rhs(self, u_prev, p_prev, inv_dt):
        ops, th, local = self.ops, self.th, self.apply.local
        parts = []
        if th != 1.0:
            # explicit part −(1−θ)(νK + C(ū))·u_prev
            parts.append(apply_momentum_conv(local, u_prev, (1.0 - th) * self.cfg.nu, None,
                                             (1.0 - th) * u_prev))
        if self.pspg:
            parts.append(apply_pspg(local, self.apply.tau, u=u_prev, inv_dt=inv_dt,
                                    adv_u=None if th == 1.0 else -(1.0 - th) * u_prev))
        sums = psum_parts(self.mesh, *parts) if parts else []
        rhs_u = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            rhs_u = rhs_u - sums.pop(0)
        bu = torch.where(ops.dir_mask[:, None], self.g, rhs_u)
        bp = 0.0 * p_prev
        if self.pspg:
            bp = bp + sums.pop(0)
        return (bu, bp), rhs_u

    def unmasked_momentum(self, u_prev, inv_dt, x):
        u, p = x
        return self.apply(u, p, inv_dt, self.th * u_prev, nu=self.th * self.cfg.nu)[0]


class ShardedFEMStep(nn.Module):
    """The element-sharded monolithic step: ``models/fem.py``'s
    :class:`~cfdsim_tpu_torch.models.fem.FEMStep` (its step body) on a
    :class:`_ShardedImplicitSolver`. ``counts`` accumulates the Krylov
    counts of this rank's solves."""

    reads_host = True
    collectives = True

    def __init__(self, ops: ElementOps, cfg: FEMConfig, g, mesh: GridMesh, force_nodes=None):
        super().__init__()
        self.ops, self.cfg, self.mesh = ops, cfg, mesh
        self.device = step_device(mesh, ops.device)
        self.counts = Counter()
        self.g = _lift(ops, g)
        self.fmask = _force_mask(ops, force_nodes)
        with full_fp32_matmul():
            self.solver = _ShardedImplicitSolver(ops, cfg, self.g, self.counts, mesh)

    def forward(self, state: FEMState, cfl_scale=1.0):
        _refuse_grad(state)
        with torch.no_grad(), full_fp32_matmul():
            return self._step(state, cfl_scale)

    _step = FEMStep._step


class ShardedFEMProjectionStep(FEMProjectionStep):
    """The element-sharded projection step: ``models/fem.py``'s
    :class:`~cfdsim_tpu_torch.models.fem.FEMProjectionStep` with every
    assembled operator on the rank's elements and one all-reduce per
    application (the predictor's convection and SU rows together); its
    Krylov iterations eager."""

    capture = False
    collectives = True

    def __init__(self, ops: ElementOps, cfg: FEMConfig, g, p_out_nodes, mesh: GridMesh,
                 force_nodes=None):
        super().__init__(ops, cfg, g, p_out_nodes, force_nodes)
        self.mesh = mesh
        self.device = step_device(mesh, ops.device)
        self.local = local_element_ops(ops, mesh)
        self.sl = element_slice(ops.elem_u.shape[0], mesh)

    def forward(self, state: FEMState, cfl_scale=1.0):
        _refuse_grad(state)
        with torch.no_grad():
            return super().forward(state, cfl_scale)

    def grad_p(self, q):
        return _psum(self.mesh, apply_grad_p(self.local, q))

    def div_u(self, u):
        return _psum(self.mesh, apply_div_u(self.local, u))

    def stiffness_p(self, q):
        return _psum(self.mesh, apply_stiffness_p(self.local, q))

    def _momentum_local(self, v, nu, inv_dt, adv, su_weight, tau_su):
        """(M/dt + νK + C(adv)) v [+ su_weight·S(ū) v] on the rank's elements."""
        y = apply_momentum_conv(self.local, v, nu, inv_dt, adv)
        if tau_su is not None:
            y = y + su_weight * apply_su(self.local, v, self.u_prev, tau_su[self.sl])
        return y

    def Am(self, v):
        th = self.th
        y = _psum(self.mesh, self._momentum_local(v, th * self.cfg.nu, self.inv_dt,
                                                       th * self.u_prev, th, self.tau_su))
        return torch.where(self.ops.dir_mask[:, None], v, y)

    def explicit_rhs(self, rhs_base, u_prev, tau_su):
        th = self.th
        return rhs_base - _psum(self.mesh, self._momentum_local(
            u_prev, (1.0 - th) * self.cfg.nu, None, (1.0 - th) * u_prev, 1.0 - th, tau_su))

    def momentum_residual(self, u_new, p_new, u_prev, inv_dt, tau_su, rhs_base):
        th = self.th
        y = (self._momentum_local(u_new, th * self.cfg.nu, inv_dt, th * u_prev, th, tau_su)
             + apply_grad_p(self.local, p_new))
        return _psum(self.mesh, y) - rhs_base


def make_step(ops: ElementOps, cfg: FEMConfig, g, mesh: GridMesh,
              force_nodes=None) -> ShardedFEMStep:
    """The element-sharded monolithic step (:class:`ShardedFEMStep`)."""
    return ShardedFEMStep(ops, cfg, g, mesh, force_nodes)


def make_projection_step(ops: ElementOps, cfg: FEMConfig, g, p_out_nodes, mesh: GridMesh,
                         force_nodes=None) -> ShardedFEMProjectionStep:
    """The element-sharded projection step (:class:`ShardedFEMProjectionStep`)."""
    return ShardedFEMProjectionStep(ops, cfg, g, p_out_nodes, mesh, force_nodes)


def solve_stokes_sharded(ops: ElementOps, cfg: FEMConfig, g, mesh: GridMesh) -> FEMState:
    """The steady Stokes initial state (``models/fem.py::solve_stokes``
    without a body force) with the operator assembled on the ranks."""
    step_device(mesh, ops.device)
    apply = make_sharded_ns_apply(ops, mesh, cfg)
    dm = ops.dir_mask[:, None]

    def A(x):
        u, p = x
        yu, yp = apply(u, p)
        return (torch.where(dm, u, yu), yp)

    with torch.no_grad(), full_fp32_matmul():
        g = _lift(ops, g)
        tau = _tau(ops, cfg)
        zeros_p = torch.zeros((ops.n_p,), dtype=ops.dtype, device=ops.device)
        bu = torch.where(dm, g, torch.zeros_like(g))
        M = _preconditioner(ops, cfg, None, tau, build_schur_coarse(ops, cfg, steady=True))
        u, p = _gmres(A, (bu, zeros_p), (g, zeros_p), M, cfg, None, capture=False)
    return FEMState(u=u.clone(), p=p.clone(),
                    t=torch.zeros((), dtype=torch.float32, device=ops.device),
                    step=torch.zeros((), dtype=torch.int32, device=ops.device))
