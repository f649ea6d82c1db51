"""Dynamic Smagorinsky (Germano–Lilly) subgrid model, 3D
(``cfdsim_tpu.ops.les_dynamic``).

The model coefficient c = (C_s Δ)² comes from the resolved field through
the Germano identity instead of being prescribed. A test filter at width
2Δ gives the Leonard stress L_ij = (ū_i ū_j)^ − û_i û_j, which the
modelled stress difference M_ij = 2Δ²[(|S̄| S̄_ij)^ − α²|Ŝ| Ŝ_ij] must carry;
Lilly's least-squares solution with volume averaging gives one scalar,

    c = ⟨L_ij M_ij⟩ / ⟨M_ij M_ij⟩,   clipped to [0, c_max],

which goes to 0 on a smooth, resolved field (the model switches itself
off where the static one over-damps). α² = 6: the [1/4, 1/2, 1/4] test
filter's second moment is that of a box √6·h wide. Δ² rides inside M, so
on a stretched grid ν_t = C_s²·Δ²(x)·|S| stays consistent with the
identity. The wall frame (``boundary_skip`` cells) is left out of the
contraction, and so are the cells of an immersed body (``mask``, bool).

All fields are at cell centres, (nz, ny, nx); gradients are central
differences of the edge-clamped field. Everything is elementwise work and
separable 3-point filters; the quotient is a ratio of two float32 sums,
kept on the device (no host read), so a step that calls it captures.
"""

from __future__ import annotations

import torch

from cfdsim_tpu_torch.solvers.poisson3d import pad_edge_3d


def box_filter_3d(f):
    """Separable trapezoidal test filter at width 2Δ, weights [1/4, 1/2,
    1/4] per axis, edge-clamped at the walls (a convex average: constants
    pass unchanged)."""
    g = pad_edge_3d(f)
    g = 0.25 * g[:-2] + 0.5 * g[1:-1] + 0.25 * g[2:]
    g = 0.25 * g[:, :-2] + 0.5 * g[:, 1:-1] + 0.25 * g[:, 2:]
    return 0.25 * g[:, :, :-2] + 0.5 * g[:, :, 1:-1] + 0.25 * g[:, :, 2:]


def _center_gradients(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z):
    """∂u_i/∂x_j at the centres from edge-clamped central differences;
    ``inv_g2*`` are 1/(two-centre gaps): 0.5/h on a uniform grid, or per
    axis tensors broadcastable over (nz, ny, nx) on a stretched one."""

    def grad(f):
        g = pad_edge_3d(f)
        return ((g[1:-1, 1:-1, 2:] - g[1:-1, 1:-1, :-2]) * inv_g2x,
                (g[1:-1, 2:, 1:-1] - g[1:-1, :-2, 1:-1]) * inv_g2y,
                (g[2:, 1:-1, 1:-1] - g[:-2, 1:-1, 1:-1]) * inv_g2z)

    return grad(uc), grad(vc), grad(wc)


def _strain(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z):
    """(S_11, S_22, S_33, S_12, S_13, S_23) and |S| at the cell centres."""
    (ux, uy, uz), (vx, vy, vz), (wx, wy, wz) = _center_gradients(
        uc, vc, wc, inv_g2x, inv_g2y, inv_g2z)
    s12 = 0.5 * (uy + vx)
    s13 = 0.5 * (uz + wx)
    s23 = 0.5 * (vz + wy)
    mag = torch.sqrt(2.0 * (ux * ux + vy * vy + wz * wz)
                     + 4.0 * (s12 * s12 + s13 * s13 + s23 * s23))
    return (ux, vy, wz, s12, s13, s23), mag


def lilly_integrand_3d(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z, delta_sq,
                       alpha_sq: float = 6.0):
    """The pointwise Lilly contraction fields (L_ij M_ij, M_ij M_ij) at the
    cell centres, the six independent components weighted (1, 1, 1, 2, 2,
    2); L is made deviatoric (its trace subtracted) so the discrete trace
    cannot pollute the quotient. ``delta_sq`` is Δ² (a scalar, or a
    cell-centre field)."""
    s, s_mag = _strain(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z)
    uf, vf, wf = box_filter_3d(uc), box_filter_3d(vc), box_filter_3d(wc)
    sf, sf_mag = _strain(uf, vf, wf, inv_g2x, inv_g2y, inv_g2z)

    vel = (uc, vc, wc)
    velf = (uf, vf, wf)
    pairs = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
    weights = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
    l_comp = [box_filter_3d(vel[i] * vel[j]) - velf[i] * velf[j] for i, j in pairs]
    tr_l = (l_comp[0] + l_comp[1] + l_comp[2]) / 3.0
    for k in range(3):
        l_comp[k] = l_comp[k] - tr_l
    m_comp = [2.0 * (box_filter_3d(delta_sq * s_mag * s[k])
                     - alpha_sq * delta_sq * sf_mag * sf[k]) for k in range(6)]
    lm = sum(wgt * l_ * m_ for wgt, l_, m_ in zip(weights, l_comp, m_comp))
    mm = sum(wgt * m_ * m_ for wgt, m_ in zip(weights, m_comp))
    return lm, mm


def dynamic_cs2_3d(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z, delta_sq, mask=None,
                   c_max_cs: float = 0.3, alpha_sq: float = 6.0, boundary_skip: int = 3,
                   eps: float = 1e-20):
    """The dimensionless Germano–Lilly C_s², one 0-dim device tensor: the
    volume-averaged Lilly quotient over the cells that are fluid (``mask``,
    bool, True = fluid; None: all) and at least ``boundary_skip`` cells from
    the walls, clipped to [0, c_max_cs²]. The sums are float32
    ``torch.sum``, as the JAX package's ``jnp.sum``."""
    lm, mm = lilly_integrand_3d(uc, vc, wc, inv_g2x, inv_g2y, inv_g2z, delta_sq,
                                alpha_sq=alpha_sq)
    if mask is not None:
        lm = torch.where(mask, lm, 0.0)
        mm = torch.where(mask, mm, 0.0)
    # the edge-clamped padding makes the filter and the gradients one-sided
    # at the walls; their spurious Leonard stress is left out
    k = boundary_skip
    if k > 0:
        if any(d <= 2 * k for d in lm.shape):
            raise ValueError(
                f"grid {tuple(lm.shape)} too small for the dynamic model's "
                f"boundary_skip={k} (needs > {2 * k} cells per axis); "
                "the contraction would be empty and c silently 0")
        lm = lm[k:-k, k:-k, k:-k]
        mm = mm[k:-k, k:-k, k:-k]
    c = lm.sum() / (mm.sum() + eps)
    return c.clamp(0.0, c_max_cs**2)


def dynamic_coefficient_3d(uc, vc, wc, dx: float, dy: float, dz: float,
                           c_max_cs: float = 0.3, alpha_sq: float = 6.0,
                           boundary_skip: int = 3, eps: float = 1e-20):
    """c = (C_s Δ)² (length², a 0-dim tensor) on a uniform grid, Δ = (dx dy
    dz)^{1/3}: :func:`dynamic_cs2_3d` times Δ²."""
    delta = (dx * dy * dz) ** (1.0 / 3.0)
    delta_sq = delta * delta
    cs2 = dynamic_cs2_3d(uc, vc, wc, 0.5 / dx, 0.5 / dy, 0.5 / dz, delta_sq,
                         c_max_cs=c_max_cs, alpha_sq=alpha_sq, boundary_skip=boundary_skip,
                         eps=eps)
    return cs2 * delta_sq


def _as_tensor(a):
    return a if torch.is_tensor(a) else torch.as_tensor(a)


def ibm_fluid_mask_centers(ibm_mask_u=None, ibm_mask_v=None, ibm_mask_w=None, ibm_ghost=None):
    """The bool cell-centre fluid indicator (True = fluid) of the dynamic
    contraction, from the face-sampled penalization masks (a cell is solid
    where a mask on one of its faces reaches 0.5) or from a
    ``GhostIBM3D`` (a cell is solid where one of its faces is); None when
    there is no static body."""
    if ibm_mask_u is not None:
        mu, mv, mw = (_as_tensor(m) for m in (ibm_mask_u, ibm_mask_v, ibm_mask_w))
        solid = torch.maximum(
            torch.maximum(torch.maximum(mu[:, :, 1:], mu[:, :, :-1]),
                          torch.maximum(mv[:, 1:, :], mv[:, :-1, :])),
            torch.maximum(mw[1:], mw[:-1]))
        return solid < 0.5
    if ibm_ghost is not None:
        su, sv, sw = ibm_ghost.u.solid, ibm_ghost.v.solid, ibm_ghost.w.solid
        solid_c = ((su[:, :, 1:] | su[:, :, :-1]) | (sv[:, 1:, :] | sv[:, :-1, :])
                   | (sw[1:] | sw[:-1]))
        return ~solid_c
    return None
