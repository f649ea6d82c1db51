"""Boundary conditions as edge writes (``cfdsim_tpu.boundary``).

Each BC writes the edge rows/columns of a field and returns it. Unlike the
JAX package's pure ``.at[].set()`` transforms, these write IN PLACE: the
step only ever hands them tensors it has just allocated itself (the
predictor and corrector outputs), so no caller-visible tensor is changed.
Pass a clone to keep the input.

Sides are named by axis and end: ``x_lo`` (j=0 column), ``x_hi`` (last
column), ``y_lo`` (i=0 row), ``y_hi`` (last row). Arrays are (ny, nx).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

SIDES = ("x_lo", "x_hi", "y_lo", "y_hi")


def set_edge(field, side: str, value):
    """Dirichlet: set the edge line to ``value`` (scalar or 1D tensor)."""
    if side == "x_lo":
        field[:, 0] = value
    elif side == "x_hi":
        field[:, -1] = value
    elif side == "y_lo":
        field[0, :] = value
    elif side == "y_hi":
        field[-1, :] = value
    else:
        raise ValueError(side)
    return field


def copy_edge(field, side: str):
    """Neumann / zero-gradient outflow: copy the adjacent interior line."""
    if side == "x_lo":
        field[:, 0] = field[:, 1]
    elif side == "x_hi":
        field[:, -1] = field[:, -2]
    elif side == "y_lo":
        field[0, :] = field[1, :]
    elif side == "y_hi":
        field[-1, :] = field[-2, :]
    else:
        raise ValueError(side)
    return field


def mirror_all_edges(field):
    """Zero-normal-gradient on all four edges (used for pressure Neumann)."""
    for side in SIDES:
        copy_edge(field, side)
    return field


def apply_bc_spec(field, spec: dict):
    """Apply a {side: bc} dict, side by side in ``SIDES`` order, where bc is
    ("dirichlet", value), ("neumann",) or a callable ``field -> field``;
    writes in place like the edge writes above."""
    for side in SIDES:
        bc = spec.get(side)
        if bc is None:
            continue
        if callable(bc):
            field = bc(field)
        elif bc[0] == "dirichlet":
            field = set_edge(field, side, bc[1])
        elif bc[0] == "neumann":
            field = copy_edge(field, side)
        else:
            raise ValueError(f"unknown bc {bc!r} for side {side}")
    return field


def lid_cavity_bcs(lid_velocity: float = 1.0) -> Callable:
    """Lid-driven cavity: moving lid at y_hi, no-slip elsewhere.

    The lid row is written after the walls, so the top corners of ``u``
    carry ``lid_velocity``.
    """

    def apply(u, v, step=None, t=None):
        for f in (u, v):
            f[:, 0] = 0.0
            f[:, -1] = 0.0
            f[0, :] = 0.0
        u[-1, :] = lid_velocity
        v[-1, :] = 0.0
        return u, v

    return apply


def channel_bcs(u_in: float = 1.0, profile=None) -> Callable:
    """Channel / Poiseuille: inflow at x_lo (uniform ``u_in`` or the 1D
    ``profile`` tensor), zero-gradient outflow at x_hi, no-slip walls at
    y_lo / y_hi."""

    def apply(u, v, step=None, t=None):
        u[:, 0] = u_in if profile is None else profile
        v[:, 0] = 0.0
        u[:, -1] = u[:, -2]
        v[:, -1] = v[:, -2]
        for f in (u, v):
            f[0, :] = 0.0
            f[-1, :] = 0.0
        return u, v

    return apply


def cylinder_inflow_bcs(v_inf: float, y_coords, y_max: float, perturb_amp: float = 0.01,
                        perturb_ramp_steps: int = 1000, *, device) -> Callable:
    """External-flow BCs for the cylinder case: inflow
    u = V∞(1 + ε·sin(2πy/y_max + 0.02·step)) with ε ramped from 0 to
    ``perturb_amp`` over ``perturb_ramp_steps`` (the vortex-shedding
    trigger), Neumann outflow, no-slip top and bottom walls. ``step`` is
    the state's 0-dim int32 device tensor, so no value leaves the device."""
    y = torch.as_tensor(np.asarray(y_coords), dtype=torch.float32, device=device)

    def apply(u, v, step, t=None):
        scale = (step / perturb_ramp_steps).clamp(max=1.0) * perturb_amp
        pert = scale * torch.sin(2.0 * np.pi * y / y_max + 0.02 * step)
        u[:, 0] = v_inf * (1.0 + pert)
        v[:, 0] = 0.0
        u[:, -1] = u[:, -2]
        v[:, -1] = v[:, -2]
        for f in (u, v):
            f[0, :] = 0.0
            f[-1, :] = 0.0
        return u, v

    return apply
