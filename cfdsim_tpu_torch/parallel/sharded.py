"""Distributed red-black SOR (``cfdsim_tpu.parallel.sharded``: the explicit
half, ``rbsor_local`` and ``make_sharded_poisson``).

Each full sweep runs two halo exchanges, one per colour, so the black half
reads the freshly updated red values of the neighbouring blocks: the
Gauss–Seidel ordering of the single-device sweep, with the colours taken
from the *global* checkerboard and the Neumann ghosts from clamped global
edges. Plain torch: the RB-SOR kernels of ``ops/kernels`` solve one whole
grid and are not on this path.

The JAX module's GSPMD half (``shard_state``, ``make_sharded_step``) is not
ported: XLA's partitioner has no counterpart here.
"""

from __future__ import annotations

import torch

from cfdsim_tpu_torch.parallel.halo import clamp_global_edges, global_parity, halo_exchange_edges
from cfdsim_tpu_torch.parallel.mesh import GridMesh


def rbsor_local(phi_b, rhs_b, mesh: GridMesh, ax: float, ay: float, iters: int, omega: float,
                fluid_b=None, colours=None):
    """``iters`` distributed red-black SOR sweeps of the Neumann problem on
    this rank's block: one halo exchange per colour half-sweep (edges only:
    the 5-point sweep reads no corner), clamped global edges, colours by
    global parity. ``fluid_b`` (a local bool
    block) freezes φ inside embedded solids. ``colours`` = (red, black)
    masks built once by the caller (a step builds them when it is built)."""
    denom_inv = 1.0 / (2.0 * (ax + ay))
    if colours is None:
        colours = sweep_colours(tuple(phi_b.shape), mesh, fluid_b)
    phi = phi_b
    for _ in range(iters):
        for colour in colours:
            p = clamp_global_edges(halo_exchange_edges(phi, mesh, 1), mesh, 1)
            nb = ax * (p[1:-1, 2:] + p[1:-1, :-2]) + ay * (p[2:, 1:-1] + p[:-2, 1:-1])
            phi_star = (nb - rhs_b) * denom_inv
            phi = torch.where(colour, (1.0 - omega) * phi + omega * phi_star, phi)
    return phi


def sweep_colours(local_shape, mesh: GridMesh, fluid_b=None):
    """(red, black) update masks of a local block: the global checkerboard,
    less the solid cells where ``fluid_b`` is given."""
    red = global_parity(local_shape, mesh)
    black = ~red
    if fluid_b is not None:
        red, black = red & fluid_b, black & fluid_b
    return red, black


def make_sharded_poisson(mesh: GridMesh, dx: float, dy: float, iters: int,
                         omega: float = 1.7):
    """``solve(phi_b, rhs_b) -> φ_b``: :func:`rbsor_local` for the Neumann
    pressure problem on this rank's blocks."""
    ax = 1.0 / (dx * dx)
    ay = 1.0 / (dy * dy)

    def solve(phi_b, rhs_b):
        return rbsor_local(phi_b, rhs_b, mesh, ax, ay, iters, omega)

    return solve
