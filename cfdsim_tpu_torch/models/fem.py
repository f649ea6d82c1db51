"""Unstructured FEM incompressible Navier–Stokes (``cfdsim_tpu.models.fem``):
matrix-free Krylov solves of the semi-implicit step.

Two steps, each ``step(state, cfl_scale) -> (state, StepMetrics)``:

- :class:`FEMStep` (``make_step``), the monolithic scheme: semi-implicit
  backward Euler (or θ-scheme) with linearized convection, one coupled
  (u, p) GMRES solve per step, P1-P1 with τ∇p·∇q ("bp") or consistent PSPG
  stabilization, or Taylor-Hood P2-P1. The solve is a
  ``torch.autograd.Function`` (the JAX package's ``custom_vjp``): forward
  is the GMRES solve, backward solves Aᵀλ = x̄ by GMRES with the same
  preconditioner, Aᵀv being the vector-Jacobian product of the linear
  operator, and pulls λ through the residual b(θ) − A(θ)·x at fixed x
  with respect to (u_prev, p_prev, inv_dt).
- :class:`FEMProjectionStep` (``make_projection_step``), the incremental
  pressure-correction scheme: a GMRES momentum predictor, a CG pressure
  increment with the two-level preconditioner (``fem/multilevel.py``),
  the velocity correction and, optionally, the rotational pressure update.

A solve that comes back non-finite or above ``accept_relres`` keeps the
previous state, by a device ``torch.where`` (no extra host read). The
Krylov exits are read on the host once per iteration
(``solvers/krylov.py``), so the steps set ``reads_host`` and a chunk of
them is the loop of step calls. Every contraction and product runs with
TF32 off (``solvers/fdm.py::full_fp32_matmul``), as the JAX steps run
under ``jax.default_matmul_precision("float32")``. ``counts`` on each step
(a ``collections.Counter``) accumulates the matvecs, preconditioner
applications, Krylov iterations and host reads of its solves.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from cfdsim_tpu_torch.fem.assembly import (
    ElementOps,
    apply_div_u,
    apply_grad_p,
    apply_mass_u,
    apply_momentum_block,
    apply_momentum_conv,
    apply_ns,
    apply_pressure_schur,
    apply_pspg,
    apply_stiffness_p,
    apply_su,
    assemble,
    interpolate_u,
    l2_norm,
    lumped_mass_u,
    mass_p_diag,
    operator_diag,
    stiffness_p_diag,
    su_tau,
)
from cfdsim_tpu_torch.fem.multilevel import (
    build_coarse,
    build_pressure_coarse,
    coarse_correct,
    make_pressure_pc,
    schur_proxy_elements,
)
from cfdsim_tpu_torch.models.incompressible import StepMetrics
from cfdsim_tpu_torch.solvers.fdm import full_fp32_matmul
from cfdsim_tpu_torch.solvers.krylov import Workspace, cg, gmres


class FEMState(NamedTuple):
    """u: (n_u, 2) nodal velocity; p: (n_p,) nodal pressure; t float32,
    step int32. ``phi`` ((n_p,), projection scheme only, else None): the
    previous pressure increment, the warm start of the next CG solve.

    A snapshot stores these nodal fields as ``fem_u``, ``fem_p`` (and
    ``fem_phi``) beside the sampled grid fields (``io_.restore`` reads
    them back by this prefix)."""

    u: torch.Tensor
    p: torch.Tensor
    t: torch.Tensor
    step: torch.Tensor
    phi: Optional[torch.Tensor] = None

    snapshot_prefix = "fem_"


@dataclasses.dataclass(frozen=True)
class FEMConfig:
    """Static solver configuration: the JAX package's fields and defaults.

    ``tau_h``: None → per-element τ = h_e²/(4ν+2V∞h_e); a float pins the
    global τ. Taylor-Hood ("p2p1") runs unstabilized unless ``force_tau``.
    ``stab``: "bp" (τ∇p·∇q) or "pspg" (the consistent residual form) for
    the monolithic P1-P1 step. ``theta``: 1 backward Euler, ½
    Crank–Nicolson on the viscous and convective terms. ``pc_sweeps``
    damped-Jacobi sweeps (ω = ``pc_omega``) in the block preconditioner
    (0: diagonal scaling). ``pp_*`` and ``rotational`` tune the
    projection scheme's pressure solve; ``pp_pc`` is "2level",
    "2level_v" or "jacobi"; ``supg`` scales the projection predictor's
    streamline-upwind term. ``gmres_method`` "incremental" is the one
    ported.
    """

    nu: float = 0.01
    dt: float = 0.05
    space: str = "p1p1"
    v_inf: float = 1.0
    tau_h: Optional[float] = None
    force_tau: bool = False
    stab: str = "bp"
    theta: float = 1.0
    gmres_tol: float = 1e-5
    gmres_restart: int = 40
    gmres_maxiter: int = 8
    accept_relres: float = 1e-2
    pc_sweeps: int = 0
    pc_omega: float = 0.4
    gmres_method: str = "incremental"
    pp_tol: float = 1e-6
    pp_maxiter: int = 400
    rotational: float = 0.0
    pp_pc: str = "2level"
    pp_max_coarse: int = 4096
    supg: float = 0.0


def _tau(ops: ElementOps, cfg: FEMConfig):
    if cfg.space == "p2p1" and not cfg.force_tau:
        return None
    h = ops.h_e if cfg.tau_h is None else torch.full_like(ops.h_e, cfg.tau_h)
    return h * h / (4.0 * cfg.nu + 2.0 * cfg.v_inf * h)


def _masked_operator(ops, cfg, inv_dt, adv_u, tau):
    """A with identity rows at Dirichlet velocity DOFs (matrix-free
    row replacement; the columns stay)."""
    dm = ops.dir_mask[:, None]

    def A(x):
        u, p = x
        yu, yp = apply_ns(ops, u, p, cfg.nu, inv_dt, adv_u, tau)
        return (torch.where(dm, u, yu), yp)

    return A


def _kp_scale(ops, inv_dt, tau):
    """K_p weight of the Schur proxy: τ (stabilization) + dt (transient
    Schur term S = B(M/dt)⁻¹Bᵀ ≈ dt·L_p)."""
    if inv_dt is None:
        return tau
    dtv = (1.0 / inv_dt) * torch.ones_like(ops.h_e)
    return dtv if tau is None else tau + dtv


def build_schur_coarse(ops, cfg, steady: bool = False):
    """Two-level hierarchy of the monolithic block preconditioner's
    Schur proxy (1/ν_eff)M_p + (τ+dt)K_p, built once per step with the
    nominal dt; None for steady solves and ``pp_pc="jacobi"``."""
    if cfg.pp_pc == "jacobi" or steady:
        return None
    inv_dt = 1.0 / cfg.dt
    tau = _tau(ops, cfg)
    nu_eff = cfg.nu * float(cfg.theta)
    kp_np = _kp_scale(ops, inv_dt, tau).cpu().numpy()
    return build_coarse(
        ops.elem_p.cpu().numpy(),
        schur_proxy_elements(ops, nu_eff, kp_np),
        ops.n_p,
        excluded_nodes=(),
        max_coarse=cfg.pp_max_coarse,
        dtype=ops.dtype,
        device=ops.device,
    )


class _BlockPreconditioner:
    """Block preconditioner: ``pc_sweeps`` damped-Jacobi iterations on the
    symmetric momentum block and on the Cahouet-Chabard Schur operator
    (0: plain diagonal scaling); ``level`` adds the additive two-level
    coarse correction to the pressure block. Its diagonals live in buffers
    that :meth:`update` rewrites for a step's dt, so the callable stays the
    same object and reads the same memory from step to step (a Krylov
    workspace's captured iterations replay it)."""

    def __init__(self, ops, cfg, tau, level, steady: bool):
        self.ops, self.cfg, self.tau, self.level = ops, cfg, tau, level
        self.nu_eff = cfg.nu * (1.0 if steady else float(cfg.theta))
        self.inv_du = torch.zeros((ops.n_u, 1), dtype=ops.dtype, device=ops.device)
        self.inv_dp = torch.zeros((ops.n_p,), dtype=ops.dtype, device=ops.device)
        self.kp = None if steady and tau is None else torch.zeros_like(ops.h_e)
        self.inv_dt = None if steady else torch.zeros((), dtype=ops.dtype, device=ops.device)

    def update(self, inv_dt):
        """The diagonals (and the Schur proxy's K_p weight) for ``inv_dt``
        (None: steady)."""
        ops = self.ops
        du, dp = operator_diag(ops, self.nu_eff, inv_dt, self.tau)
        self.inv_du.copy_((1.0 / torch.where(ops.dir_mask, 1.0, du))[:, None])
        self.inv_dp.copy_(1.0 / dp)
        if self.kp is not None:
            self.kp.copy_(_kp_scale(ops, inv_dt, self.tau))
        if self.inv_dt is not None:
            self.inv_dt.copy_(torch.as_tensor(inv_dt))
        return self

    def _zp_base(self, p):
        zp = self.inv_dp * p
        if self.level is not None:
            zp = zp + coarse_correct(self.level, p)
        return zp

    def __call__(self, x):
        u, p = x
        k, om, ops = int(self.cfg.pc_sweeps), self.cfg.pc_omega, self.ops
        if k <= 0:
            return (u * self.inv_du, self._zp_base(p))
        dm = ops.dir_mask[:, None]
        zu = self.inv_du * u
        for _ in range(k):
            y = apply_momentum_block(ops, zu, self.nu_eff, self.inv_dt)
            zu = zu + om * self.inv_du * (u - torch.where(dm, zu, y))
        zp = self._zp_base(p)
        for _ in range(k):
            zp = zp + om * self.inv_dp * (p - apply_pressure_schur(ops, zp, self.nu_eff,
                                                                   self.kp))
        return (zu, zp)


def _preconditioner(ops, cfg, inv_dt, tau, level=None):
    """The block preconditioner (:class:`_BlockPreconditioner`) for
    ``inv_dt`` (None: steady)."""
    return _BlockPreconditioner(ops, cfg, tau, level, steady=inv_dt is None).update(inv_dt)


def _gmres(A, b, x0, M, cfg, counts, capture=True, workspace=None):
    return gmres(A, b, x0=x0, M=M, tol=cfg.gmres_tol, atol=0.0, restart=cfg.gmres_restart,
                 maxiter=cfg.gmres_maxiter, solve_method=cfg.gmres_method, counts=counts,
                 capture=capture, workspace=workspace)


def _relres(A, x, b):
    r = [ax - bx for ax, bx in zip(A(x), b)]
    num = torch.sqrt(sum(torch.sum(y * y) for y in r))
    den = torch.sqrt(sum(torch.sum(y * y) for y in b))
    return num / torch.clamp(den, min=1e-30)


def _body_force_quad(ops: ElementOps, f: Callable):
    """Body force sampled at the quadrature points, (nt, nq, 2)."""
    fx, fy = f(ops.xq[..., 0], ops.xq[..., 1])
    return torch.stack(torch.broadcast_tensors(torch.as_tensor(fx), torch.as_tensor(fy)),
                       dim=-1).to(ops.dtype)


def _body_force_rhs(ops: ElementOps, f: Callable):
    """∫ f·v for a vectorized f(x, y) -> (fx, fy) at the quad points."""
    ru = torch.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, _body_force_quad(ops, f))
    return assemble(ru, ops.scatter_u)


def _force_mask(ops, force_nodes):
    if force_nodes is None or len(force_nodes) == 0:
        return None
    fmask = torch.zeros((ops.n_u,), dtype=ops.dtype, device=ops.device)
    fmask[torch.as_tensor(np.asarray(force_nodes, np.int64), device=ops.device)] = 1.0
    return fmask


def _lift(ops, g):
    return torch.as_tensor(np.asarray(g), device=ops.device).to(ops.dtype)


def _time_step(ops, cfl_scale, cfg):
    """(dt, inv_dt) as 0-dim tensors of the ops' dtype."""
    cfl = torch.as_tensor(cfl_scale, device=ops.device).to(ops.dtype)
    dt = cfg.dt * cfl
    return dt, 1.0 / dt


def _diagnostics(ops, u):
    """(‖div u‖_L2, max |ω|, mean kinetic energy, max |u|) from the quad
    points."""
    uq, gu = interpolate_u(ops, u)
    div_l2 = l2_norm(ops, gu[..., 0, 0] + gu[..., 1, 1])
    vort = gu[..., 1, 0] - gu[..., 0, 1]
    area = torch.sum(ops.wq)
    energy = 0.5 * torch.sum(ops.wq * torch.sum(uq * uq, dim=-1)) / area
    max_vel = torch.sqrt(torch.max(torch.sum(uq * uq, dim=-1)))
    return div_l2, torch.max(torch.abs(vort)), energy, max_vel


def _metrics(dt, div_pre, div_post, max_vel, energy, vort_max, relres, fx, fy):
    """StepMetrics of float32 0-dim tensors (fz = 0: a 2D body)."""
    f32 = [x.to(torch.float32) for x in (dt, div_pre, div_post, max_vel, energy, vort_max,
                                         relres, fx, fy)]
    return StepMetrics(*f32, fz=torch.zeros_like(f32[0]))


class _ImplicitSolver:
    """The monolithic step's linear system A(u_prev, inv_dt) x = b(u_prev,
    p_prev, inv_dt) and its preconditioner (the JAX package's
    ``_make_implicit_solver``)."""

    def __init__(self, ops, cfg, g, bf, fq, counts):
        self.ops, self.cfg, self.g, self.bf, self.fq = ops, cfg, g, bf, fq
        self.counts = counts
        self.tau = _tau(ops, cfg)
        self.pspg = cfg.stab == "pspg" and self.tau is not None
        self.tau_ns = None if self.pspg else self.tau
        self.th = float(cfg.theta)
        self.level = build_schur_coarse(ops, cfg)
        # the forward solve's operator and preconditioner read these buffers,
        # so its Krylov workspace replays the same captured iterations every step
        self.u_prev = torch.zeros((ops.n_u, 2), dtype=ops.dtype, device=ops.device)
        self.inv_dt = torch.zeros((), dtype=ops.dtype, device=ops.device)
        self.M = _BlockPreconditioner(ops, cfg, self.tau, self.level, steady=False)
        self.workspace = Workspace()

    def A(self, x):
        """The operator at the buffered (u_prev, inv_dt)."""
        return self.opA(self.u_prev, self.inv_dt, x)

    def opA(self, u_prev, inv_dt, x):
        # θ-weighting by linearity: θ(νK + C(ū))u = (θν)Ku + C(θū)u
        ops, th = self.ops, self.th
        u, p = x
        yu, yp = apply_ns(ops, u, p, th * self.cfg.nu, inv_dt, th * u_prev, self.tau_ns)
        if self.pspg:
            # the unknowns' share of the θ-scheme momentum residual
            yp = yp + apply_pspg(ops, self.tau, u=u, p=p, inv_dt=inv_dt, adv_u=th * u_prev)
        return (torch.where(ops.dir_mask[:, None], u, yu), yp)

    def rhs(self, u_prev, p_prev, inv_dt):
        ops, th = self.ops, self.th
        rhs_u = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            # explicit part −(1−θ)(νK + C(ū))·u_prev (p = 0 drops the coupling)
            yu_e, _ = apply_ns(ops, u_prev, torch.zeros_like(p_prev), (1.0 - th) * self.cfg.nu,
                               None, (1.0 - th) * u_prev, None)
            rhs_u = rhs_u - yu_e
        if self.bf is not None:
            rhs_u = rhs_u + self.bf
        bu = torch.where(ops.dir_mask[:, None], self.g, rhs_u)
        bp = 0.0 * p_prev
        if self.pspg:
            bp = bp + apply_pspg(ops, self.tau, u=u_prev, inv_dt=inv_dt,
                                 adv_u=None if th == 1.0 else -(1.0 - th) * u_prev, fq=self.fq)
        return (bu, bp), rhs_u

    def precond(self, inv_dt):
        return _preconditioner(self.ops, self.cfg, inv_dt, self.tau, self.level)

    def unmasked_momentum(self, u_prev, inv_dt, x):
        """θ-weighted momentum rows without the Dirichlet replacement (the
        reaction-force readout)."""
        u, p = x
        yu, _ = apply_ns(self.ops, u, p, self.th * self.cfg.nu, inv_dt, self.th * u_prev,
                         self.tau)
        return yu

    def solve(self, u_prev, p_prev, inv_dt):
        return _ImplicitSolve.apply(u_prev, p_prev, inv_dt, self)


class _ImplicitSolve(torch.autograd.Function):
    """x = A⁻¹b by GMRES, differentiated by the implicit adjoint."""

    @staticmethod
    def forward(ctx, u_prev, p_prev, inv_dt, solver):
        b, _ = solver.rhs(u_prev, p_prev, inv_dt)
        solver.u_prev.copy_(u_prev)
        solver.inv_dt.copy_(inv_dt)
        solver.M.update(inv_dt)
        u, p = _gmres(solver.A, b, (u_prev, p_prev), solver.M, solver.cfg, solver.counts,
                      workspace=solver.workspace)
        ctx.solver = solver
        ctx.save_for_backward(u_prev, p_prev, inv_dt, u, p)
        return u, p

    @staticmethod
    def backward(ctx, ubar, pbar):
        u_prev, p_prev, inv_dt, u, p = (t.detach() for t in ctx.saved_tensors)
        solver = ctx.solver
        # Aᵀv is the vector-Jacobian product of the linear x ↦ A x: one graph
        # of A at x, pulled back once per GMRES matvec
        with torch.enable_grad():
            xs = (u.clone().requires_grad_(), p.clone().requires_grad_())
            ax = solver.opA(u_prev, inv_dt, xs)

        def At(v):
            return torch.autograd.grad(ax, xs, grad_outputs=v, retain_graph=True)

        xbar = (torch.zeros_like(u) if ubar is None else ubar,
                torch.zeros_like(p) if pbar is None else pbar)
        lam = _gmres(At, xbar, tuple(torch.zeros_like(v) for v in xbar),
                     solver.precond(inv_dt), solver.cfg, solver.counts, capture=False)
        # pull λ through the residual b(θ) − A(θ)·x at fixed x
        with torch.enable_grad():
            theta = [t.clone().requires_grad_() for t in (u_prev, p_prev, inv_dt)]
            b, _ = solver.rhs(*theta)
            ax_fixed = solver.opA(theta[0], theta[2], (u, p))
            residual = [bi - ai for bi, ai in zip(b, ax_fixed)]
            grads = torch.autograd.grad(residual, theta, grad_outputs=lam, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, theta)]
        return (*grads, None)


def solve_stokes(ops: ElementOps, cfg: FEMConfig, g,
                 body_force: Optional[Callable] = None) -> FEMState:
    """Steady Stokes initialization: ν∇u:∇v − p∇·v + q∇·u (+ τ∇p·∇q) =
    (f, v) with the Dirichlet lift g (``stab="pspg"`` adds the τ∫∇q·f
    continuity rhs)."""
    with full_fp32_matmul():
        g = _lift(ops, g)
        tau = _tau(ops, cfg)
        A = _masked_operator(ops, cfg, None, None, tau)
        bu = torch.zeros((ops.n_u, 2), dtype=ops.dtype, device=ops.device)
        bp = torch.zeros((ops.n_p,), dtype=ops.dtype, device=ops.device)
        if body_force is not None:
            bu = bu + _body_force_rhs(ops, body_force)
            if cfg.stab == "pspg" and tau is not None:
                bp = bp + apply_pspg(ops, tau, fq=_body_force_quad(ops, body_force))
        bu = torch.where(ops.dir_mask[:, None], g, bu)
        x0 = (g, torch.zeros((ops.n_p,), dtype=ops.dtype, device=ops.device))
        M = _preconditioner(ops, cfg, None, tau, build_schur_coarse(ops, cfg, steady=True))
        u, p = _gmres(A, (bu, bp), x0, M, cfg, None)
    return FEMState(u=u.clone(), p=p.clone(),
                    t=torch.zeros((), dtype=torch.float32, device=ops.device),
                    step=torch.zeros((), dtype=torch.int32, device=ops.device))


class FEMStep(nn.Module):
    """The monolithic semi-implicit step (the JAX package's ``make_step``).

    ``g``: (n_u, 2) Dirichlet lift; ``force_nodes``: velocity-DOF indices
    on which the reaction force is reported (StepMetrics.fx/fy, per unit
    density; Cd = 2 fx / (V∞² D))."""

    reads_host = True

    def __init__(self, ops: ElementOps, cfg: FEMConfig, g, force_nodes=None,
                 body_force: Optional[Callable] = None):
        super().__init__()
        self.ops, self.cfg = ops, cfg
        self.device = ops.device
        self.counts = Counter()
        self.g = _lift(ops, g)
        self.fmask = _force_mask(ops, force_nodes)
        with full_fp32_matmul():
            bf = _body_force_rhs(ops, body_force) if body_force is not None else None
            fq = _body_force_quad(ops, body_force) if body_force is not None else None
            self.solver = _ImplicitSolver(ops, cfg, self.g, bf, fq, self.counts)

    def forward(self, state: FEMState, cfl_scale=1.0):
        with full_fp32_matmul():
            return self._step(state, cfl_scale)

    def _step(self, state, cfl_scale):
        ops, cfg, solver = self.ops, self.cfg, self.solver
        dt, inv_dt = _time_step(ops, cfl_scale, cfg)
        u_prev, p_prev = state.u, state.p

        u, p = solver.solve(u_prev, p_prev, inv_dt)

        # an unconverged or non-finite solve keeps the previous state
        b, rhs_u = solver.rhs(u_prev, p_prev, inv_dt)
        relres = _relres(lambda x: solver.opA(u_prev, inv_dt, x), (u, p), b)
        finite = torch.isfinite(torch.sum(u)) & torch.isfinite(torch.sum(p))
        ok = finite & (relres < cfg.accept_relres)
        u = torch.where(ok, u, u_prev)
        p = torch.where(ok, p, p_prev)

        div_l2, vort_max, energy, max_vel = _diagnostics(ops, u)
        fx = fy = torch.zeros((), dtype=ops.dtype, device=ops.device)
        if self.fmask is not None:
            # consistent reaction force: minus the momentum residual (no
            # Dirichlet row replacement) summed over the body nodes
            res_u = solver.unmasked_momentum(u_prev, inv_dt, (u, p)) - rhs_u
            fx = -torch.sum(self.fmask * res_u[:, 0])
            fy = -torch.sum(self.fmask * res_u[:, 1])
        new = FEMState(u=u, p=p, t=(state.t + dt).to(state.t.dtype), step=state.step + 1)
        return new, _metrics(dt, div_l2, div_l2, max_vel, energy, vort_max, relres, fx, fy)


class FEMProjectionStep(nn.Module):
    """The incremental pressure-correction step (the JAX package's
    ``make_projection_step``):

    1. predictor: (M/dt + θνK + C(θūⁿ)) u* = (M/dt)uⁿ − (1−θ)(νK +
       C(ūⁿ))uⁿ − G pⁿ + f, Dirichlet rows = g; Jacobi-preconditioned GMRES;
    2. pressure increment: K_p φ = −(1/dt) B u*, φ = 0 on the outflow nodes
       (P1-P1; Taylor-Hood solves the exact lumped Schur operator
       B P M_L⁻¹ Bᵀ); CG with the two-level preconditioner;
    3. update: p ← p + φ (− χ·ν·M_p⁻¹ B u* in rotational form), u ← u* −
       dt·M_L⁻¹ G φ (HRZ-lumped mass; Dirichlet rows kept).
    """

    reads_host = True

    def __init__(self, ops: ElementOps, cfg: FEMConfig, g, p_out_nodes, force_nodes=None,
                 body_force: Optional[Callable] = None):
        super().__init__()
        if len(p_out_nodes) == 0:
            raise ValueError("projection scheme needs pressure-Dirichlet (outflow) nodes")
        self.ops, self.cfg = ops, cfg
        self.device = ops.device
        self.counts = Counter()
        self.g = _lift(ops, g)
        self.fmask = _force_mask(ops, force_nodes)
        self.th = float(cfg.theta)
        # what the predictor's operator and preconditioner read, in buffers a
        # step rewrites, so the Krylov workspaces replay the same captured
        # iterations every step
        self.u_prev = torch.zeros((ops.n_u, 2), dtype=ops.dtype, device=ops.device)
        self.inv_dt = torch.zeros((), dtype=ops.dtype, device=ops.device)
        self.tau_su = torch.zeros_like(ops.h_e) if cfg.supg else None
        self.inv_du = torch.zeros((ops.n_u, 1), dtype=ops.dtype, device=ops.device)
        self.workspace_u, self.workspace_p = Workspace(), Workspace()
        with full_fp32_matmul():
            self.bf = _body_force_rhs(ops, body_force) if body_force is not None else None
            pm = torch.zeros((ops.n_p,), dtype=torch.bool, device=ops.device)
            pm[torch.as_tensor(np.asarray(p_out_nodes, np.int64), device=ops.device)] = True
            self.pm = pm
            self.inv_ml = 1.0 / lumped_mass_u(ops)
            self.inv_mp = 1.0 / mass_p_diag(ops)
            inv_dp_k = 1.0 / torch.where(pm, 1.0, stiffness_p_diag(ops))
            # the K_p coarse space also preconditions the Taylor-Hood exact
            # Schur operator (spectrally equivalent)
            level = (build_pressure_coarse(ops, p_out_nodes, cfg.pp_max_coarse)
                     if cfg.pp_pc != "jacobi" else None)
            self.Mp = make_pressure_pc(level, inv_dp_k, Ap=self.Ap, kind=cfg.pp_pc)

    def corr_of(self, q):
        """Velocity correction direction M_L⁻¹ G q, zero on Dirichlet rows."""
        c = self.inv_ml[:, None] * apply_grad_p(self.ops, q)
        return torch.where(self.ops.dir_mask[:, None], 0.0, c)

    def Ap(self, q):
        """The pressure operator: P K_p P + (I − P) on P1-P1, where P zeroes
        the outflow rows; on Taylor-Hood the exact lumped Schur operator
        B P M_L⁻¹ Bᵀ, matrix-free."""
        q0 = torch.where(self.pm, 0.0, q)
        if self.ops.kind != "p1p1":
            y = -apply_div_u(self.ops, self.corr_of(q0))
        else:
            y = apply_stiffness_p(self.ops, q0)
        return torch.where(self.pm, q, y)

    def Am(self, v):
        """The predictor's operator (M/dt + θνK + C(θū) [+ θ S(ū)]) v at the
        buffered ū and dt, Dirichlet rows replaced."""
        ops, th = self.ops, self.th
        y = apply_momentum_conv(ops, v, th * self.cfg.nu, self.inv_dt, th * self.u_prev)
        if self.tau_su is not None:
            y = y + th * apply_su(ops, v, self.u_prev, self.tau_su)
        return torch.where(ops.dir_mask[:, None], v, y)

    def Mu(self, v):
        """The predictor's Jacobi preconditioner."""
        return self.inv_du * v

    def forward(self, state: FEMState, cfl_scale=1.0):
        with full_fp32_matmul():
            return self._step(state, cfl_scale)

    def _step(self, state, cfl_scale):
        ops, cfg, th = self.ops, self.cfg, self.th
        dt, inv_dt = _time_step(ops, cfl_scale, cfg)
        u_prev, p_prev = state.u, state.p
        dm = ops.dir_mask[:, None]
        self.u_prev.copy_(u_prev)
        self.inv_dt.copy_(inv_dt)

        # --- 1. momentum predictor; SU is quadratic in ū, so its θ weights
        # are explicit: θ·S(ū)u implicit, (1−θ)·S(ū)u_prev explicit
        tau_su = None
        if cfg.supg:
            tau_su = self.tau_su
            tau_su.copy_(cfg.supg * su_tau(ops, u_prev, cfg.nu, inv_dt))
        rhs_base = inv_dt * apply_mass_u(ops, u_prev)
        if th != 1.0:
            rhs_base = rhs_base - apply_momentum_conv(ops, u_prev, (1.0 - th) * cfg.nu, None,
                                                      (1.0 - th) * u_prev)
            if tau_su is not None:
                rhs_base = rhs_base - (1.0 - th) * apply_su(ops, u_prev, u_prev, tau_su)
        if self.bf is not None:
            rhs_base = rhs_base + self.bf
        rhs_u = rhs_base - apply_grad_p(ops, p_prev)
        b = torch.where(dm, self.g, rhs_u)

        du, _ = operator_diag(ops, th * cfg.nu, inv_dt, None)
        self.inv_du.copy_((1.0 / torch.where(ops.dir_mask, 1.0, du))[:, None])
        u_star = _gmres(self.Am, b, u_prev, self.Mu, cfg, self.counts,
                        workspace=self.workspace_u)

        # --- 2. pressure-increment Poisson
        div_star = apply_div_u(ops, u_star)
        bp = torch.where(self.pm, 0.0, -inv_dt * div_star)
        phi0 = (torch.zeros_like(bp) if state.phi is None
                else torch.where(self.pm, 0.0, state.phi))
        phi = cg(self.Ap, bp, x0=phi0, M=self.Mp, tol=cfg.pp_tol, atol=0.0,
                 maxiter=cfg.pp_maxiter, counts=self.counts, workspace=self.workspace_p)

        # --- 3. correction
        u_new = u_star - dt * self.corr_of(phi)
        p_new = p_prev + phi
        if cfg.rotational:
            p_new = p_new - cfg.rotational * cfg.nu * self.inv_mp * div_star

        # an unconverged or non-finite solve keeps the previous state
        r = self.Am(u_star) - b
        relres = torch.sqrt(torch.sum(r * r)) / torch.clamp(torch.sqrt(torch.sum(b * b)),
                                                            min=1e-30)
        finite = torch.isfinite(torch.sum(u_new)) & torch.isfinite(torch.sum(p_new))
        ok = finite & (relres < cfg.accept_relres)
        u_new = torch.where(ok, u_new, u_prev)
        p_new = torch.where(ok, p_new, p_prev)

        _, gu_s = interpolate_u(ops, u_star)
        div_pre = l2_norm(ops, gu_s[..., 0, 0] + gu_s[..., 1, 1])
        div_post, vort_max, energy, max_vel = _diagnostics(ops, u_new)

        fx = fy = torch.zeros((), dtype=ops.dtype, device=ops.device)
        if self.fmask is not None:
            # the reaction force from the scheme's own momentum balance at
            # (u_new, p_new)
            yu = apply_momentum_conv(ops, u_new, th * cfg.nu, inv_dt, th * u_prev)
            if tau_su is not None:
                yu = yu + th * apply_su(ops, u_new, u_prev, tau_su)
            res_u = yu + apply_grad_p(ops, p_new) - rhs_base
            fx = -torch.sum(self.fmask * res_u[:, 0])
            fy = -torch.sum(self.fmask * res_u[:, 1])

        # carry the increment for the next warm start iff the state carried one
        new_phi = None if state.phi is None else torch.where(ok, phi, state.phi)
        new = FEMState(u=u_new, p=p_new, t=(state.t + dt).to(state.t.dtype),
                       step=state.step + 1, phi=new_phi)
        return new, _metrics(dt, div_pre, div_post, max_vel, energy, vort_max, relres, fx, fy)


def make_step(ops: ElementOps, cfg: FEMConfig, g, force_nodes=None,
              body_force: Optional[Callable] = None) -> FEMStep:
    """The monolithic step on the ops' device (:class:`FEMStep`)."""
    return FEMStep(ops, cfg, g, force_nodes, body_force)


def make_projection_step(ops: ElementOps, cfg: FEMConfig, g, p_out_nodes, force_nodes=None,
                         body_force: Optional[Callable] = None) -> FEMProjectionStep:
    """The projection step on the ops' device (:class:`FEMProjectionStep`)."""
    return FEMProjectionStep(ops, cfg, g, p_out_nodes, force_nodes, body_force)
