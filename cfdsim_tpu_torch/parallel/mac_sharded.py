"""The trimmed MAC state (``cfdsim_tpu.parallel.mac_sharded``: ``trim_state``,
``untrim_state``, ``shard_trimmed_state``).

MAC face arrays are (ny, nx+1) and (ny+1, nx): one axis never divides over
the mesh. The last boundary face of each component is a function of the
interior through ``MACBCs.set_normal`` (a wall or inflow value, or the
outflow copy), so the distributed state stores u[:, :-1] and v[:-1, :],
every field (ny, nx), and the boundary faces are re-derived. The JAX
module's GSPMD wrapper (``make_sharded_mac_step``) is not ported; the
explicit MAC step (``parallel/mac_explicit.py``) runs on the trimmed blocks.
"""

from __future__ import annotations

import torch.nn.functional as F

from cfdsim_tpu_torch.models.mac import MACBCs, MACState
from cfdsim_tpu_torch.parallel.mesh import GridMesh, block_state


def trim_state(state: MACState) -> MACState:
    """Full MAC state → the mesh-divisible trimmed state (the last boundary
    face of u and v dropped; ``set_normal`` re-derives them)."""
    return state._replace(u=state.u[:, :-1], v=state.v[:-1, :])


def untrim_state(tstate: MACState, bcs: MACBCs) -> MACState:
    """Trimmed state → full MAC state, the boundary faces re-imposed at the
    state's own step and time."""
    u = F.pad(tstate.u, (0, 1))
    v = F.pad(tstate.v, (0, 0, 0, 1))
    u, v = bcs.set_normal(u, v, tstate.step, tstate.t)
    return tstate._replace(u=u, v=v)


def shard_trimmed_state(tstate: MACState, mesh: GridMesh) -> MACState:
    """This rank's blocks of a trimmed state (its (ny, nx) fields cut over
    the mesh, t and step copied)."""
    return block_state(tstate, mesh)
