"""The trimmed MAC state and its step lift (``cfdsim_tpu.parallel.mac_sharded``).

MAC face arrays are (ny, nx+1) and (ny+1, nx): one axis never divides over
the mesh. The last boundary face of each component is a function of the
interior through ``MACBCs.set_normal`` (a wall or inflow value, or the
outflow copy), so the distributed state stores u[:, :-1] and v[:-1, :],
every field (ny, nx), and the boundary faces are re-derived.
:func:`make_sharded_mac_step` lifts a MAC step to the trimmed state
(``untrim → step → trim``, bit-exact); the explicit MAC steps
(``parallel/mac_explicit.py`` and its stretched and 3D twins) run on the
trimmed blocks, and ``parallel/sharded.py::make_sharded_step`` picks them.
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


def make_sharded_mac_step(step_fn, bcs: MACBCs, mesh: GridMesh | None = None):
    """Lift a MAC ``step(state, cfl) -> (state, metrics)`` to the trimmed
    state: ``tstep(tstate, cfl) -> (tstate, metrics)`` on (ny, nx) fields.
    Exact: the reconstruction is the ``set_normal`` write the step itself
    makes first. The step runs where its state lives, whole; ``mesh`` is
    the JAX signature's and unused (the blocks' explicit steps are
    ``make_sharded_step``'s)."""
    del mesh

    def tstep(tstate: MACState, cfl_scale):
        new_state, metrics = step_fn(untrim_state(tstate, bcs), cfl_scale)
        return trim_state(new_state), metrics

    tstep.device = getattr(step_fn, "device", None)
    tstep.reads_host = getattr(step_fn, "reads_host", True)
    return tstep