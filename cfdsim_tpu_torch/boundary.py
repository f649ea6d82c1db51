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
