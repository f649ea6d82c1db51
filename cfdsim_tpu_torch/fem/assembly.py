"""Vectorized FEM assembly: batched einsum contractions over all elements
(``cfdsim_tpu.fem.assembly``).

Each bilinear form is a handful of dense einsum contractions batched over
the whole element set: gather the element DOFs, contract them against the
basis and gradient tables at the quadrature points, and assemble the
element vectors into nodal ones. No sparse matrix is formed; the operators
are applied matrix-free inside the Krylov solvers (``solvers/krylov.py``).

Weak form (semi-implicit backward Euler, the JAX package's):

    (u - u_prev)·v/dt + ν ∇u:∇v + (ū·∇u)·v − p ∇·v + q ∇·u
        + τ ∇p·∇q   =   0

with ū = u_prev (linearized convection) and τ the pressure-gradient
stabilization (0 for Taylor-Hood). Quadrature: the 7-point degree-5
Dunavant rule, exact for every P2-P1 term.

The assembly is a deterministic scatter. The JAX package sums element
vectors into nodes with ``segment_sum``; ``index_add_`` would do the same on
CUDA with float atomics, whose order changes from run to run and so would
break bit-exact resume and chunk equality. Instead :func:`build_element_ops`
builds, once on the host, each node's list of (element, local slot) entries
padded to the largest valence with a slot that holds zero; assembling is a
gather of that table and a sum over its rows, in the same order every run.
The basis and geometry tables are built in float64 numpy and cast to the
ops' dtype, as the JAX package builds them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfdsim_tpu_torch.fem.spaces import FESpaces


def _dunavant7():
    """Degree-5 7-point rule on the reference triangle; weights sum to
    1/2 (the reference area)."""
    s15 = np.sqrt(15.0)
    b1 = (6.0 + s15) / 21.0
    b2 = (6.0 - s15) / 21.0
    pts = [(1 / 3, 1 / 3)]
    wts = [9.0 / 40.0]
    for b in (b1,):
        w = (155.0 + s15) / 1200.0
        a = 1.0 - 2.0 * b
        pts += [(a, b), (b, a), (b, b)]
        wts += [w, w, w]
    for b in (b2,):
        w = (155.0 - s15) / 1200.0
        a = 1.0 - 2.0 * b
        pts += [(a, b), (b, a), (b, b)]
        wts += [w, w, w]
    pts = np.asarray(pts, dtype=np.float64)  # (7, 2) = (ξ, η)
    wts = 0.5 * np.asarray(wts, dtype=np.float64)
    return pts, wts


def _basis_tables(kind: str, qp: np.ndarray):
    """Shape-function values and reference gradients at quad points.

    Returns (N (nq, nloc), dN (nq, nloc, 2)). Barycentric
    λ = (1-ξ-η, ξ, η); P2 midside ordering m_k opposite vertex k."""
    xi, eta = qp[:, 0], qp[:, 1]
    lam = np.stack([1.0 - xi - eta, xi, eta], axis=1)  # (nq, 3)
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
    if kind == "p1":
        N = lam
        dN = np.broadcast_to(dlam, (len(qp), 3, 2)).copy()
        return N, dN
    # P2
    nq = len(qp)
    N = np.zeros((nq, 6))
    dN = np.zeros((nq, 6, 2))
    for i in range(3):
        N[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dN[:, i] = (4.0 * lam[:, i] - 1.0)[:, None] * dlam[i]
    pairs = [(1, 2), (2, 0), (0, 1)]  # m0, m1, m2
    for k, (a, b) in enumerate(pairs):
        N[:, 3 + k] = 4.0 * lam[:, a] * lam[:, b]
        dN[:, 3 + k] = 4.0 * (
            lam[:, a][:, None] * dlam[b] + lam[:, b][:, None] * dlam[a]
        )
    return N, dN


def scatter_table(index: np.ndarray, n: int) -> np.ndarray:
    """(n, valence) int64: for each of ``n`` nodes, the flat positions in
    ``index.ravel()`` that name it, ascending, padded with ``index.size``
    (the zero slot :func:`assemble` appends). ``index`` holds node ids,
    e.g. an element-to-DOF map (nt, nloc)."""
    flat = np.asarray(index).ravel()
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n)
    width = max(int(counts.max()) if n else 0, 1)
    table = np.full((n, width), flat.size, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(flat.size) - np.repeat(starts, counts)
    table[flat[order], slot] = order
    return table


def assemble(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum element-slot values into nodes through a :func:`scatter_table`:
    ``values`` (nt, nloc[, 2]) → (n[, 2]), each node's entries summed in
    the table's order (the same bits every run, on any device)."""
    flat = values.reshape(-1, *values.shape[2:])
    flat = torch.cat([flat, flat.new_zeros((1, *flat.shape[1:]))])
    return flat[table].sum(1)


@dataclasses.dataclass(frozen=True, eq=False)
class ElementOps:
    """Assembly tables on one device.

    Nu/Np : (nq, nloc) basis values; Gu/Gp : (nt, nq, nloc, 2) physical
    gradients; wq : (nt, nq) quadrature weights ×|J|; xq : (nt, nq, 2)
    quad-point coordinates; h_e : (nt,) element size √(2A) feeding the
    τ stabilization; elem_u/elem_p : DOF maps (int64); dir_mask : (n_u,)
    bool; scatter_u/scatter_p : the :func:`scatter_table` of each DOF map.
    """

    kind: str
    n_u: int
    n_p: int
    elem_u: torch.Tensor
    elem_p: torch.Tensor
    Nu: torch.Tensor
    Np: torch.Tensor
    Gu: torch.Tensor
    Gp: torch.Tensor
    wq: torch.Tensor
    xq: torch.Tensor
    h_e: torch.Tensor
    dir_mask: torch.Tensor
    scatter_u: torch.Tensor
    scatter_p: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.wq.device

    @property
    def dtype(self) -> torch.dtype:
        return self.wq.dtype


def build_element_ops(spaces: FESpaces, dtype=torch.float32, *, device) -> ElementOps:
    """Precompute all per-element geometry and basis tables (runs once)."""
    mesh = spaces.mesh
    qp, qw = _dunavant7()
    Nu, dNu = _basis_tables("p1" if spaces.kind == "p1p1" else "p2", qp)
    Np, dNp = _basis_tables("p1", qp)

    tri_pts = mesh.points[mesh.tris]  # (nt, 3, 2)
    J = np.stack(
        [tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0]],
        axis=2,
    )  # (nt, 2, 2): columns are edge vectors
    detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    inv = np.empty_like(J)
    inv[:, 0, 0] = J[:, 1, 1]
    inv[:, 0, 1] = -J[:, 0, 1]
    inv[:, 1, 0] = -J[:, 1, 0]
    inv[:, 1, 1] = J[:, 0, 0]
    inv /= detJ[:, None, None]
    # physical gradient: dN_phys[c] = dN_ref[k] * inv[k, c]
    Gu = np.einsum("qlk,ekc->eqlc", dNu, inv)
    Gp = np.einsum("qlk,ekc->eqlc", dNp, inv)
    wq = np.abs(detJ)[:, None] * qw[None, :]
    xq = tri_pts[:, None, 0, :] + np.einsum("qk,eck->eqc", qp, J)
    h_e = np.sqrt(np.abs(detJ))  # √(2A): characteristic element size

    def real(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def index(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return ElementOps(
        kind=spaces.kind,
        n_u=spaces.n_u,
        n_p=spaces.n_p,
        elem_u=index(spaces.elem_u),
        elem_p=index(spaces.elem_p),
        Nu=real(Nu),
        Np=real(Np),
        Gu=real(Gu),
        Gp=real(Gp),
        wq=real(wq),
        xq=real(xq),
        h_e=real(h_e),
        dir_mask=torch.as_tensor(spaces.dirichlet_mask, device=device),
        scatter_u=index(scatter_table(spaces.elem_u, spaces.n_u)),
        scatter_p=index(scatter_table(spaces.elem_p, spaces.n_p)),
    )


def _sum_u(ops: ElementOps, ru):
    return assemble(ru, ops.scatter_u)


def _sum_p(ops: ElementOps, rp):
    return assemble(rp, ops.scatter_p)


def apply_ns(ops: ElementOps, u, p, nu, inv_dt, adv_u, tau):
    """y = A(u, p): one application of the coupled NS block operator.

    u : (n_u, 2), p : (n_p,); ``adv_u`` is the frozen advecting field
    (None → Stokes); ``inv_dt`` None drops the mass term (steady);
    ``tau`` (nt,) is the per-element stabilization (None → none).
    Returns (yu (n_u, 2), yp (n_p,)).
    """
    ue = u[ops.elem_u]  # (nt, nlu, 2)
    pe = p[ops.elem_p]  # (nt, 3)
    gu = torch.einsum("eqlc,eld->eqdc", ops.Gu, ue)  # ∇u at quads
    pq = torch.einsum("ql,el->eq", ops.Np, pe)
    divu = gu[..., 0, 0] + gu[..., 1, 1]

    # momentum: ν ∇u:∇v
    ru = nu * torch.einsum("eq,eqlc,eqdc->eld", ops.wq, ops.Gu, gu)
    if inv_dt is not None:
        uq = torch.einsum("ql,eld->eqd", ops.Nu, ue)
        ru = ru + inv_dt * torch.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    if adv_u is not None:
        aq = torch.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
        conv = torch.einsum("eqc,eqdc->eqd", aq, gu)
        ru = ru + torch.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, conv)
    # − p ∇·v
    ru = ru - torch.einsum("eq,eqld,eq->eld", ops.wq, ops.Gu, pq)

    # continuity: q ∇·u (+ τ ∇p·∇q)
    rp = torch.einsum("eq,ql,eq->el", ops.wq, ops.Np, divu)
    if tau is not None:
        gp = torch.einsum("eqlc,el->eqc", ops.Gp, pe)
        rp = rp + torch.einsum("e,eq,eqlc,eqc->el", tau, ops.wq, ops.Gp, gp)
    return _sum_u(ops, ru), _sum_p(ops, rp)


def apply_pspg(ops: ElementOps, tau_e, u=None, p=None, inv_dt=None, adv_u=None, fq=None):
    """Consistent PSPG continuity-row stabilization:
    y_l = Σ_e τ_e ∫ ∇N_l · r, with r the elementwise momentum-residual
    pieces selected by the caller — r = inv_dt·u + (adv_u·∇)u + ∇p + fq
    (each term only when its argument is given; the P1 viscous term
    vanishes elementwise). The θ-scheme operator row passes (u, p, inv_dt,
    θ·ū); the matching rhs row passes (u_prev, inv_dt, −(1−θ)·ū, f_q).
    Returns (n_p,)."""
    r = None

    def acc(r, term):
        return term if r is None else r + term

    if u is not None:
        ue = u[ops.elem_u]
        if inv_dt is not None:
            uq = torch.einsum("ql,eld->eqd", ops.Nu, ue)
            r = acc(r, inv_dt * uq)
        if adv_u is not None:
            gu = torch.einsum("eqlc,eld->eqdc", ops.Gu, ue)
            aq = torch.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
            r = acc(r, torch.einsum("eqc,eqdc->eqd", aq, gu))
    if p is not None:
        gp = torch.einsum("eqlc,el->eqc", ops.Gp, p[ops.elem_p])
        r = acc(r, gp)
    if fq is not None:
        r = acc(r, fq)
    if r is None:
        return torch.zeros((ops.n_p,), dtype=ops.dtype, device=ops.device)
    rp = torch.einsum("e,eq,eqlc,eqc->el", tau_e, ops.wq, ops.Gp, r)
    return _sum_p(ops, rp)


def apply_mass_u(ops: ElementOps, u):
    """y = M u (velocity mass matrix), the backward-Euler rhs carrier."""
    ue = u[ops.elem_u]
    uq = torch.einsum("ql,eld->eqd", ops.Nu, ue)
    ru = torch.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    return _sum_u(ops, ru)


def operator_diag(ops: ElementOps, nu, inv_dt, tau):
    """Diagonal of the (convection-free) block operator, for Jacobi
    preconditioning: momentum diag = Σ w (ν|∇N|² + N²/dt); pressure
    diag is a Cahouet-Chabard Schur-complement proxy, (1/ν)·mass plus
    dt·|∇N|² (S = B(M/dt)⁻¹Bᵀ ≈ dt·L_p), plus the τ block when on."""
    du_e = nu * torch.einsum("eq,eqlc,eqlc->el", ops.wq, ops.Gu, ops.Gu)
    if inv_dt is not None:
        du_e = du_e + inv_dt * torch.einsum("eq,ql,ql->el", ops.wq, ops.Nu, ops.Nu)
    dp_e = (1.0 / nu) * torch.einsum("eq,ql,ql->el", ops.wq, ops.Np, ops.Np)
    kp_scale = tau
    if inv_dt is not None:
        dt_bcast = (1.0 / inv_dt) * torch.ones_like(ops.h_e)
        kp_scale = dt_bcast if tau is None else tau + dt_bcast
    if kp_scale is not None:
        dp_e = dp_e + torch.einsum("e,eq,eqlc,eqlc->el", kp_scale, ops.wq, ops.Gp, ops.Gp)
    return _sum_u(ops, du_e), _sum_p(ops, dp_e)


def apply_momentum_block(ops: ElementOps, u, nu, inv_dt):
    """y = (M/dt + νK) u: the symmetric part of the momentum block (the
    block preconditioner's inner Jacobi sweeps)."""
    return apply_momentum_conv(ops, u, nu, inv_dt, None)


def apply_pressure_schur(ops: ElementOps, q, nu, kp_scale):
    """y = (1/ν)·M_p q + kp_scale·K_p q: the Cahouet-Chabard Schur proxy as
    an operator (kp_scale (nt,) = τ + dt; see operator_diag)."""
    qe = q[ops.elem_p]
    qq = torch.einsum("ql,el->eq", ops.Np, qe)
    rp = (1.0 / nu) * torch.einsum("eq,ql,eq->el", ops.wq, ops.Np, qq)
    if kp_scale is not None:
        gq = torch.einsum("eqlc,el->eqc", ops.Gp, qe)
        rp = rp + torch.einsum("e,eq,eqlc,eqc->el", kp_scale, ops.wq, ops.Gp, gq)
    return _sum_p(ops, rp)


def apply_momentum_conv(ops: ElementOps, u, nu, inv_dt, adv_u):
    """y = (M/dt + νK + C(adv_u)) u: the momentum block without pressure
    coupling (the projection scheme's predictor operator); ``adv_u`` None
    drops convection, ``inv_dt`` None the mass term."""
    ue = u[ops.elem_u]
    gu = torch.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    ru = nu * torch.einsum("eq,eqlc,eqdc->eld", ops.wq, ops.Gu, gu)
    if inv_dt is not None:
        uq = torch.einsum("ql,eld->eqd", ops.Nu, ue)
        ru = ru + inv_dt * torch.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, uq)
    if adv_u is not None:
        aq = torch.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
        conv = torch.einsum("eqc,eqdc->eqd", aq, gu)
        ru = ru + torch.einsum("eq,ql,eqd->eld", ops.wq, ops.Nu, conv)
    return _sum_u(ops, ru)


def su_tau(ops: ElementOps, adv_u, nu, inv_dt):
    """Per-element streamline-upwind time scale (Shakib form):
    τ_e = ((2/dt)² + (2|ā|/h)² + (12ν/h²)²)^(-1/2), with ā the
    element-mean advecting speed."""
    aq = torch.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
    a_mag = torch.sqrt(torch.sum(torch.mean(aq, dim=1) ** 2, dim=-1) + 1e-30)
    h = ops.h_e
    t1 = (2.0 * inv_dt) ** 2 if inv_dt is not None else 0.0
    t2 = (2.0 * a_mag / h) ** 2
    t3 = (12.0 * nu / (h * h)) ** 2
    return 1.0 / torch.sqrt(t1 + t2 + t3)


def apply_su(ops: ElementOps, u, adv_u, tau_e):
    """Streamline-upwind stabilization y_l = Σ_e τ_e ∫_e (ā·∇N_l)(ā·∇u):
    anisotropic diffusion along streamlines only. Quadratic in ``adv_u``,
    so θ-scheme callers weight it explicitly."""
    ue = u[ops.elem_u]
    gu = torch.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    aq = torch.einsum("ql,eld->eqd", ops.Nu, adv_u[ops.elem_u])
    conv = torch.einsum("eqc,eqdc->eqd", aq, gu)  # ā·∇u
    wl = torch.einsum("eqc,eqlc->eql", aq, ops.Gu)  # ā·∇N_l
    ru = torch.einsum("e,eq,eql,eqd->eld", tau_e, ops.wq, wl, conv)
    return _sum_u(ops, ru)


def apply_grad_p(ops: ElementOps, p):
    """y = G p: the momentum-equation pressure term −∫ p ∇·v (the coupling
    block of apply_ns on its own, for the projection predictor's rhs)."""
    pe = p[ops.elem_p]
    pq = torch.einsum("ql,el->eq", ops.Np, pe)
    ru = -torch.einsum("eq,eqld,eq->eld", ops.wq, ops.Gu, pq)
    return _sum_u(ops, ru)


def apply_div_u(ops: ElementOps, u):
    """y = B u: the weak divergence ∫ q ∇·u (n_p,)."""
    ue = u[ops.elem_u]
    gu = torch.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    divu = gu[..., 0, 0] + gu[..., 1, 1]
    rp = torch.einsum("eq,ql,eq->el", ops.wq, ops.Np, divu)
    return _sum_p(ops, rp)


def apply_stiffness_p(ops: ElementOps, q):
    """y = K_p q: the pressure Laplacian ∫ ∇q·∇φ."""
    qe = q[ops.elem_p]
    gq = torch.einsum("eqlc,el->eqc", ops.Gp, qe)
    rp = torch.einsum("eq,eqlc,eqc->el", ops.wq, ops.Gp, gq)
    return _sum_p(ops, rp)


def stiffness_p_diag(ops: ElementOps):
    """diag(K_p): Jacobi preconditioner of the projection Poisson."""
    dp_e = torch.einsum("eq,eqlc,eqlc->el", ops.wq, ops.Gp, ops.Gp)
    return _sum_p(ops, dp_e)


def lumped_mass_u(ops: ElementOps):
    """HRZ (diagonal-scaling) lumped velocity mass vector (n_u,): per
    element m_l = A_e·∫N_l² / Σ_k ∫N_k², then assembled (strictly positive
    on P1 and P2, unlike row-sum lumping on P2)."""
    me = torch.einsum("eq,ql,ql->el", ops.wq, ops.Nu, ops.Nu)
    area = torch.sum(ops.wq, dim=1)
    ml_e = me * (area / torch.sum(me, dim=1))[:, None]
    return _sum_u(ops, ml_e)


def mass_p_diag(ops: ElementOps):
    """Row-sum lumped pressure mass (n_p,)."""
    ml_e = torch.einsum("eq,ql->el", ops.wq, ops.Np)
    return _sum_p(ops, ml_e)


def interpolate_u(ops: ElementOps, u):
    """Velocity and its gradient at all quadrature points: uq (nt, nq, 2),
    gu (nt, nq, 2, 2)."""
    ue = u[ops.elem_u]
    uq = torch.einsum("ql,eld->eqd", ops.Nu, ue)
    gu = torch.einsum("eqlc,eld->eqdc", ops.Gu, ue)
    return uq, gu


def l2_norm(ops: ElementOps, fq):
    """√∫ |f|² over the mesh for a quad-point field fq (nt, nq, ...)."""
    sq = fq * fq
    if fq.ndim > 2:
        sq = torch.sum(sq, dim=tuple(range(2, fq.ndim)))
    return torch.sqrt(torch.sum(ops.wq * sq))
