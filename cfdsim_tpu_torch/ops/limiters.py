"""Slope limiters (``cfdsim_tpu.ops.limiters``).

Each operates elementwise on whole face tensors, so a single call limits
every interface at once. The incompressible TVD scheme
(``ops/convection.py::convection_tvd``) uses :func:`vanleer_slope`; the
others are the compressible finite-volume module's.
"""

from __future__ import annotations

import torch


def minmod(a, b):
    """Textbook minmod: the smaller-magnitude argument when a and b agree
    in sign (a tie returns that common value), else 0."""
    same = a * b > 0
    pick_b = torch.logical_and(b.abs() < a.abs(), same)
    return torch.where(same, torch.where(pick_b, b, a), 0.0)


def minmod3(a, b, c):
    """Three-argument minmod (used by MUSCL reconstruction)."""
    return minmod(a, minmod(b, c))


def superbee(a, b):
    """Superbee-limited delta: max(0, min(2r,1), min(r,2)) * b with r=a/b;
    0 where a·b ≤ 0."""
    r = a / (b + 1e-10)
    lim = torch.maximum((2.0 * r).clamp(max=1.0).clamp(min=0.0), r.clamp(max=2.0))
    return torch.where(a * b <= 0, 0.0, lim * b)


def superbee_slope(a, b):
    """Textbook superbee slope: maxmod(minmod(2a, b), minmod(a, 2b)), the
    sharpest TVD limiter (Roe 1985)."""
    s1 = minmod(2.0 * a, b)
    s2 = minmod(a, 2.0 * b)
    return torch.where(s1.abs() > s2.abs(), s1, s2)


def vanleer_slope(a, b):
    """Van Leer harmonic-mean slope: 2ab/(a+b) where a·b > 0, else 0: the
    smooth TVD limiter, the default for the incompressible TVD scheme."""
    prod = a * b
    den = a + b
    den = torch.where(den.abs() < 1e-30, 1e-30, den)
    return torch.where(prod > 0.0, 2.0 * prod / den, 0.0)


SLOPE_LIMITERS = {
    "minmod": minmod,
    "superbee": superbee_slope,
    "vanleer": vanleer_slope,
}
