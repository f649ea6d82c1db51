"""Vectorised Riemann solvers of the compressible Euler modules
(``cfdsim_tpu.solvers.riemann``).

Every solver takes whole left/right state tensors for one sweep direction
and returns the whole face-flux tensor, elementwise: a face is one element
of every intermediate, so a sweep is a chain of elementwise passes.

State layout is component-leading: U has shape (4, ny, nx) with components
(ρ, ρu, ρv, ρE). ``axis=1`` means x-faces (flux F), ``axis=0`` y-faces (G).

The 2D functions and the dimension-generic ``*_nd`` family do not share
arithmetic (the 2D Roe floors ρ̃² at eps and normalises by wL + wR + eps; the
nd Roe takes wL·wR and 1/(wL + wR)), so each is ported as written. HLLC's
branches are all computed and picked by nested ``torch.where``, as the JAX
package picks them with ``jnp.where``.

Parity references of the JAX package: ``compute_fluxes`` v1_shock.py:84-95,
``hllc_solver`` v1_shock.py:147-209, ``roe_solver`` v1_shock.py:97-145,
``rusanov_riemann_solver_limited`` cavity_flow_v1.py:123-150.
"""

from __future__ import annotations

import torch


def cons_to_prim(U, gamma: float, eps: float = 1e-8, max_val: float = 1e3):
    """Primitive recovery (ρ, u, v, p) with positivity floors and velocity
    clips."""
    rho = U[0].clamp(min=eps)
    inv = 1.0 / rho
    u = (U[1] * inv).clamp(-max_val, max_val)
    v = (U[2] * inv).clamp(-max_val, max_val)
    E = (U[3] * inv).clamp(eps, max_val)
    p = ((gamma - 1.0) * rho * (E - 0.5 * (u * u + v * v))).clamp(min=eps)
    return rho, u, v, p


def prim_to_cons(rho, u, v, p, gamma: float):
    """(ρ, ρu, ρv, ρE) stacked from primitives."""
    E = p / ((gamma - 1.0) * rho) + 0.5 * (u * u + v * v)
    return torch.stack([rho, rho * u, rho * v, rho * E])


def euler_flux(U, gamma: float, axis: int, eps: float = 1e-8, max_val: float = 1e3):
    """Physical flux along ``axis`` (1 = x → F, 0 = y → G)."""
    rho, u, v, p = cons_to_prim(U, gamma, eps, max_val)
    E = (U[3] / rho).clamp(eps, max_val)
    q = u if axis == 1 else v
    mom_x = rho * u * q
    mom_y = rho * v * q
    return torch.stack([
        rho * q,
        mom_x + p if axis == 1 else mom_x,
        mom_y + p if axis == 0 else mom_y,
        rho * q * (E + p / rho),
    ])


def sound_speed(rho, p, gamma: float, eps: float = 1e-8):
    return (gamma * p / rho).clamp(min=eps).sqrt()


def rusanov_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8, max_val: float = 1e3):
    """Local Lax–Friedrichs: ½(F_L+F_R) − ½ λ_max ΔU."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    qL = uL if axis == 1 else vL
    qR = uR if axis == 1 else vR
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)
    lam = torch.maximum(qL.abs() + aL, qR.abs() + aR)
    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * lam[None] * (UR - UL)


def _where3(sL, sR, sM, FL, FR, F_star_L, F_star_R):
    """HLLC's choice over the wave-speed signs, every branch computed."""
    return torch.where((sL >= 0)[None], FL,
                       torch.where((sR <= 0)[None], FR,
                                   torch.where((sM >= 0)[None], F_star_L, F_star_R)))


def hllc_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8, max_val: float = 1e3):
    """HLLC with star states, branch-free over the wave-speed sign
    pattern."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    EL = (UL[3] / UL[0].clamp(min=eps)).clamp(eps, max_val)
    ER = (UR[3] / UR[0].clamp(min=eps)).clamp(eps, max_val)
    qL = uL if axis == 1 else vL
    qR = uR if axis == 1 else vR
    tL = vL if axis == 1 else uL  # tangential velocity
    tR = vR if axis == 1 else uR
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)

    sL = torch.minimum(qL - aL, qR - aR)
    sR = torch.maximum(qL + aL, qR + aR)
    sM = (rR * qR * (sR - qR) - rL * qL * (sL - qL) + pL - pR) / (
        rR * (sR - qR) - rL * (sL - qL) + eps)

    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)

    def star(rho, q, s, E, p, tang):
        """Star-region conserved state behind wave speed s."""
        coef = rho * (s - q) / (s - sM + eps)
        p_star = rho * (q - s) * (q - sM) + p
        e_star = E + (p_star * sM - p * q) / (rho * (s - q) + eps)
        if axis == 1:
            mom_x, mom_y = coef * sM, coef * tang
        else:
            mom_x, mom_y = coef * tang, coef * sM
        return torch.stack([coef, mom_x, mom_y, coef * e_star])

    UsL = star(rL, qL, sL, EL, pL, tL)
    UsR = star(rR, qR, sR, ER, pR, tR)
    F_star_L = FL + sL[None] * (UsL - UL)
    F_star_R = FR + sR[None] * (UsR - UR)
    return _where3(sL, sR, sM, FL, FR, F_star_L, F_star_R)


def _harten(lam, a_roe):
    """Harten's entropy fix: |λ| → λ²/(2δ) + δ/2 for |λ| < δ = 0.1·ã."""
    delta = 0.1 * a_roe
    return torch.where(lam.abs() < delta, lam * lam / (2.0 * delta) + 0.5 * delta, lam.abs())


def _roe_averages(UL, UR, gamma: float, eps: float, max_val: float):
    """Roe-averaged (ũ, ṽ, h̃, ã) plus the primitive L/R states and wL·wR."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    hL = (UL[3] + pL) / UL[0].clamp(min=eps)
    hR = (UR[3] + pR) / UR[0].clamp(min=eps)
    wL = rL.sqrt()
    wR = rR.sqrt()
    norm = wL + wR + eps
    u_roe = (uL * wL + uR * wR) / norm
    v_roe = (vL * wL + vR * wR) / norm
    h_roe = (hL * wL + hR * wR) / norm
    a_roe = ((gamma - 1.0) * (h_roe - 0.5 * (u_roe * u_roe + v_roe * v_roe))).clamp(
        min=eps).sqrt()
    return (rL, uL, vL, pL), (rR, uR, vR, pR), (u_roe, v_roe, h_roe, a_roe), wL * wR


def roe_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8, max_val: float = 1e3):
    """Textbook Roe flux: full characteristic decomposition (acoustic pair,
    entropy wave, shear wave) with the Harten entropy fix on the acoustic
    waves, F = ½(F_L + F_R) − ½ Σ_k α_k |λ_k| r_k."""
    (rL, uL, vL, pL), (rR, uR, vR, pR), (u_roe, v_roe, h_roe, a_roe), rho_roe_sq = (
        _roe_averages(UL, UR, gamma, eps, max_val))
    rho_roe = rho_roe_sq.clamp(min=eps).sqrt()  # ρ̃ = √(ρ_L ρ_R)
    if axis == 1:  # x-normal: q = u (normal), w = v (tangential)
        q_roe = u_roe
        dq, dw = uR - uL, vR - vL
    else:
        q_roe = v_roe
        dq, dw = vR - vL, uR - uL
    drho = rR - rL
    dp = pR - pL

    a2_inv = 1.0 / (a_roe * a_roe)
    alpha1 = 0.5 * (dp - rho_roe * a_roe * dq) * a2_inv  # q̃ − ã wave
    alpha2 = drho - dp * a2_inv  # entropy wave
    alpha3 = 0.5 * (dp + rho_roe * a_roe * dq) * a2_inv  # q̃ + ã wave
    alpha4 = rho_roe * dw  # shear wave

    l1 = _harten(q_roe - a_roe, a_roe)
    l2 = q_roe.abs()
    l3 = _harten(q_roe + a_roe, a_roe)

    ke_roe = 0.5 * (u_roe * u_roe + v_roe * v_roe)
    one, zero = torch.ones_like(u_roe), torch.zeros_like(u_roe)
    if axis == 1:
        r1 = torch.stack([one, u_roe - a_roe, v_roe, h_roe - u_roe * a_roe])
        r3 = torch.stack([one, u_roe + a_roe, v_roe, h_roe + u_roe * a_roe])
        r4 = torch.stack([zero, zero, one, v_roe])
    else:
        r1 = torch.stack([one, u_roe, v_roe - a_roe, h_roe - v_roe * a_roe])
        r3 = torch.stack([one, u_roe, v_roe + a_roe, h_roe + v_roe * a_roe])
        r4 = torch.stack([zero, one, zero, u_roe])
    r2 = torch.stack([one, u_roe, v_roe, ke_roe])

    diss = ((alpha1 * l1)[None] * r1 + (alpha2 * l2)[None] * r2
            + (alpha3 * l3)[None] * r3 + (alpha4 * l2)[None] * r4)
    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * diss


def roe_ref_flux(UL, UR, gamma: float, axis: int, eps: float = 1e-8, max_val: float = 1e3):
    """The reference's "roe" scheme (v1_shock.py:97-145): Roe-averaged
    velocities and sound speed with an entropy floor 0.05·ã, dissipating
    with the *sum* of the three floored eigenvalues applied to ΔU (a
    Rusanov-like variant, kept for parity; :func:`roe_flux` is the
    characteristic solver)."""
    rL, uL, vL, pL = cons_to_prim(UL, gamma, eps, max_val)
    rR, uR, vR, pR = cons_to_prim(UR, gamma, eps, max_val)
    hL = (UL[3] + pL) / UL[0].clamp(min=eps)
    hR = (UR[3] + pR) / UR[0].clamp(min=eps)

    wL = rL.sqrt()
    wR = rR.sqrt()
    norm = wL + wR + eps
    u_roe = (uL * wL + uR * wR) / norm
    v_roe = (vL * wL + vR * wR) / norm
    h_roe = (hL * wL + hR * wR) / norm
    a_roe = ((gamma - 1.0) * (h_roe - 0.5 * (u_roe * u_roe + v_roe * v_roe))).clamp(
        min=eps).sqrt()
    q = u_roe if axis == 1 else v_roe
    floor = 0.05 * a_roe
    l1 = torch.maximum(floor, q.abs())
    l2 = torch.maximum(floor, (q + a_roe).abs())
    l3 = torch.maximum(floor, (q - a_roe).abs())

    FL = euler_flux(UL, gamma, axis, eps, max_val)
    FR = euler_flux(UR, gamma, axis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * (l1 + l2 + l3)[None] * (UR - UL)


FLUXES = {
    "rusanov": rusanov_flux,
    "hllc": hllc_flux,
    "roe": roe_flux,
    "roe_ref": roe_ref_flux,
}


# ---------------------------------------------------------------------------
# dimension-generic solvers (any number of velocity components): the 3D
# tier's; the 2D solvers above keep their own arithmetic
# ---------------------------------------------------------------------------

def cons_to_prim_nd(U, gamma: float, eps: float = 1e-8, max_val: float = 1e3):
    """Primitive recovery for U = (ρ, ρu_1..ρu_d, ρE): (ρ, [u_i], p)."""
    nv = U.shape[0] - 2
    rho = U[0].clamp(min=eps)
    inv = 1.0 / rho
    vels = [(U[1 + i] * inv).clamp(-max_val, max_val) for i in range(nv)]
    E = (U[-1] * inv).clamp(eps, max_val)
    ke = sum(w * w for w in vels) * 0.5
    p = ((gamma - 1.0) * rho * (E - ke)).clamp(min=eps)
    return rho, vels, p


def euler_flux_nd(U, gamma: float, vaxis: int, eps: float = 1e-8, max_val: float = 1e3):
    """Physical flux along velocity component ``vaxis`` (0-based)."""
    rho, vels, p = cons_to_prim_nd(U, gamma, eps, max_val)
    E = (U[-1] / rho).clamp(eps, max_val)
    q = vels[vaxis]
    comps = [rho * q]
    for i, w in enumerate(vels):
        mom = rho * w * q
        comps.append(mom + p if i == vaxis else mom)
    comps.append(rho * q * (E + p / rho))
    return torch.stack(comps)


def rusanov_flux_nd(UL, UR, gamma: float, vaxis: int, eps: float = 1e-8,
                    max_val: float = 1e3):
    rL, vL, pL = cons_to_prim_nd(UL, gamma, eps, max_val)
    rR, vR, pR = cons_to_prim_nd(UR, gamma, eps, max_val)
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)
    lam = torch.maximum(vL[vaxis].abs() + aL, vR[vaxis].abs() + aR)
    FL = euler_flux_nd(UL, gamma, vaxis, eps, max_val)
    FR = euler_flux_nd(UR, gamma, vaxis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * lam[None] * (UR - UL)


def hllc_flux_nd(UL, UR, gamma: float, vaxis: int, eps: float = 1e-8, max_val: float = 1e3):
    """HLLC with star states for any velocity dimension: the normal
    component jumps to s_M in the star region, tangentials are advected."""
    rL, vL, pL = cons_to_prim_nd(UL, gamma, eps, max_val)
    rR, vR, pR = cons_to_prim_nd(UR, gamma, eps, max_val)
    EL = (UL[-1] / UL[0].clamp(min=eps)).clamp(eps, max_val)
    ER = (UR[-1] / UR[0].clamp(min=eps)).clamp(eps, max_val)
    qL, qR = vL[vaxis], vR[vaxis]
    aL = sound_speed(rL, pL, gamma, eps)
    aR = sound_speed(rR, pR, gamma, eps)
    sL = torch.minimum(qL - aL, qR - aR)
    sR = torch.maximum(qL + aL, qR + aR)
    sM = (rR * qR * (sR - qR) - rL * qL * (sL - qL) + pL - pR) / (
        rR * (sR - qR) - rL * (sL - qL) + eps)
    FL = euler_flux_nd(UL, gamma, vaxis, eps, max_val)
    FR = euler_flux_nd(UR, gamma, vaxis, eps, max_val)

    def star(rho, q, s, E, p, vels):
        coef = rho * (s - q) / (s - sM + eps)
        p_star = rho * (q - s) * (q - sM) + p
        e_star = E + (p_star * sM - p * q) / (rho * (s - q) + eps)
        comps = [coef]
        for i, w in enumerate(vels):
            comps.append(coef * (sM if i == vaxis else w))
        comps.append(coef * e_star)
        return torch.stack(comps)

    UsL = star(rL, qL, sL, EL, pL, vL)
    UsR = star(rR, qR, sR, ER, pR, vR)
    F_star_L = FL + sL[None] * (UsL - UL)
    F_star_R = FR + sR[None] * (UsR - UR)
    return _where3(sL, sR, sM, FL, FR, F_star_L, F_star_R)


def roe_flux_nd(UL, UR, gamma: float, vaxis: int, eps: float = 1e-8, max_val: float = 1e3):
    """Textbook Roe flux for any velocity dimension: characteristic
    decomposition (acoustic pair, entropy wave, D−1 shear waves) with the
    Harten entropy fix."""
    rL, vL, pL = cons_to_prim_nd(UL, gamma, eps, max_val)
    rR, vR, pR = cons_to_prim_nd(UR, gamma, eps, max_val)
    ndim = len(vL)
    wL = rL.clamp(min=eps).sqrt()
    wR = rR.clamp(min=eps).sqrt()
    inv_w = 1.0 / (wL + wR)
    v_roe = [(wL * vL[i] + wR * vR[i]) * inv_w for i in range(ndim)]
    EL = (UL[-1] / UL[0].clamp(min=eps)).clamp(eps, max_val)
    ER = (UR[-1] / UR[0].clamp(min=eps)).clamp(eps, max_val)
    hL = EL + pL / rL.clamp(min=eps)
    hR = ER + pR / rR.clamp(min=eps)
    h_roe = (wL * hL + wR * hR) * inv_w
    ke_roe = 0.5 * sum(c * c for c in v_roe)
    a_roe = ((gamma - 1.0) * (h_roe - ke_roe)).clamp(min=eps).sqrt()
    rho_roe = wL * wR

    q_roe = v_roe[vaxis]
    dq = vR[vaxis] - vL[vaxis]
    drho = rR - rL
    dp = pR - pL
    a2_inv = 1.0 / (a_roe * a_roe)
    alpha1 = 0.5 * (dp - rho_roe * a_roe * dq) * a2_inv
    alpha2 = drho - dp * a2_inv
    alpha3 = 0.5 * (dp + rho_roe * a_roe * dq) * a2_inv

    l1 = _harten(q_roe - a_roe, a_roe)
    l2 = q_roe.abs()
    l3 = _harten(q_roe + a_roe, a_roe)

    one = torch.ones_like(q_roe)
    zero = torch.zeros_like(q_roe)

    def eigvec(vel_normal, energy):
        return torch.stack([one] + [vel_normal if i == vaxis else v_roe[i]
                                    for i in range(ndim)] + [energy])

    r1 = eigvec(q_roe - a_roe, h_roe - q_roe * a_roe)
    r3 = eigvec(q_roe + a_roe, h_roe + q_roe * a_roe)
    r2 = torch.stack([one] + list(v_roe) + [ke_roe])
    diss = (alpha1 * l1)[None] * r1 + (alpha2 * l2)[None] * r2 + (alpha3 * l3)[None] * r3
    for i in range(ndim):
        if i == vaxis:
            continue
        alpha_s = rho_roe * (vR[i] - vL[i])
        r_s = torch.stack([zero] + [one if j == i else zero for j in range(ndim)] + [v_roe[i]])
        diss = diss + (alpha_s * l2)[None] * r_s

    FL = euler_flux_nd(UL, gamma, vaxis, eps, max_val)
    FR = euler_flux_nd(UR, gamma, vaxis, eps, max_val)
    return 0.5 * (FL + FR) - 0.5 * diss


FLUXES_ND = {"rusanov": rusanov_flux_nd, "hllc": hllc_flux_nd, "roe": roe_flux_nd}
