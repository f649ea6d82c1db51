"""Multi-rank domain decomposition on ``torch.distributed``
(``cfdsim_tpu.parallel``, its explicit half).

Each rank of a (py, px) mesh holds one block of every field and runs the
step on it, every collective placed by hand:

- ``mesh``: the rank grid (:func:`make_grid_mesh`, :func:`init_distributed`),
  the block helpers and the reductions over the mesh;
- ``halo``: the halo exchange (``batch_isend_irecv`` along a mesh axis,
  differentiable) and the global-index helpers;
- ``sharded``: distributed red-black SOR;
- ``transforms``: pencil all-to-all DCT, FDM (2D and 3D) and DST
  Helmholtz solves;
- ``explicit``: the collocated cavity and cylinder steps;
- ``mac_sharded``, ``mac_explicit``: the trimmed MAC state and the MAC
  cavity and cylinder steps;
- ``boussinesq_explicit``: the heated cavity and Rayleigh–Bénard;
- ``launch``: gloo ranks on the CPU (``spawn``), for tests and the dry run.

The JAX package's GSPMD half (``shard_state``, ``make_sharded_step``,
``make_sharded_mac_step``) has no counterpart here. Not ported yet: the
stretched and 3D MAC tiers, the ghost-cell IBM, the moving body, the
spectral and FEM tiers (ROADMAP.md item 22).
"""

from cfdsim_tpu_torch.parallel.boussinesq_explicit import (
    make_heated_cavity_explicit_step,
    shard_boussinesq_state,
    trim_boussinesq_state,
    untrim_boussinesq_state,
)
from cfdsim_tpu_torch.parallel.explicit import (
    make_cavity_explicit_step,
    make_cylinder_explicit_step,
    make_explicit_step,
)
from cfdsim_tpu_torch.parallel.halo import halo_exchange, make_sharded_stencil
from cfdsim_tpu_torch.parallel.mac_explicit import (
    make_cavity_mac_explicit_step,
    make_cylinder_mac_explicit_step,
    make_mac_explicit_step,
    trim_face_masks,
)
from cfdsim_tpu_torch.parallel.mac_sharded import (
    shard_trimmed_state,
    trim_state,
    untrim_state,
)
from cfdsim_tpu_torch.parallel.mesh import (
    GridMesh,
    block_state,
    gather_blocks,
    gather_state,
    init_distributed,
    local_block,
    make_grid_mesh,
)
from cfdsim_tpu_torch.parallel.sharded import make_sharded_poisson, rbsor_local
from cfdsim_tpu_torch.parallel.transforms import (
    dct_poisson3d_local,
    dct_poisson_local,
    dst_helmholtz_local,
    make_fdm_poisson3d_local,
    make_fdm_poisson_local,
)

__all__ = [
    "make_grid_mesh",
    "init_distributed",
    "GridMesh",
    "local_block",
    "gather_blocks",
    "block_state",
    "gather_state",
    "halo_exchange",
    "make_sharded_stencil",
    "rbsor_local",
    "make_sharded_poisson",
    "make_explicit_step",
    "make_cavity_explicit_step",
    "make_cylinder_explicit_step",
    "make_mac_explicit_step",
    "make_cavity_mac_explicit_step",
    "make_cylinder_mac_explicit_step",
    "trim_face_masks",
    "trim_state",
    "untrim_state",
    "shard_trimmed_state",
    "dct_poisson_local",
    "dst_helmholtz_local",
    "make_fdm_poisson_local",
    "make_fdm_poisson3d_local",
    "dct_poisson3d_local",
    "make_heated_cavity_explicit_step",
    "trim_boussinesq_state",
    "untrim_boussinesq_state",
    "shard_boussinesq_state",
]
