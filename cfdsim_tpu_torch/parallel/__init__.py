"""Multi-rank domain decomposition on ``torch.distributed``
(``cfdsim_tpu.parallel``, its explicit half).

Each rank of a (py, px) mesh holds one block of every field and runs the
step on it, every collective placed by hand:

- ``mesh``: the rank grid (:func:`make_grid_mesh`, :func:`init_distributed`),
  the block helpers and the reductions over the mesh;
- ``halo``: the halo exchange (``batch_isend_irecv`` along a mesh axis,
  differentiable) and the global-index helpers;
- ``sharded``: distributed red-black SOR;
- ``poisson2d_explicit``: every 2D pressure solve on blocks
  (``DistributedPoisson2D``; kernel B on windows for the unmasked
  Neumann sweeps);
- ``transforms``: pencil all-to-all DCT, FDM (2D and 3D) and DST
  Helmholtz solves;
- ``explicit``: the collocated cavity and cylinder steps;
- ``mac_sharded``, ``mac_explicit``: the trimmed MAC state and the MAC
  cavity, cylinder and moving-body steps;
- ``mac_stretched_explicit``: the stretched MAC cavity, cylinder and
  moving body;
- ``ibm_ghost_explicit``: a rank's ghost-cell IBM tables and the (moving)
  ghost forcing on blocks;
- ``mac3d_explicit``, ``mac_stretched3d_explicit``: the trimmed 3D state and
  the 3D MAC cavity, sphere (penalized or ghost-cell) and moving sphere, on
  the uniform and the stretched grid;
- ``transport3d_explicit``: the heated sphere (uniform and stretched);
- ``boussinesq_explicit``, ``boussinesq3d_explicit``: the heated cavity,
  Rayleigh–Bénard and the heated cube;
- ``spectral_ps_explicit``: the pseudo-spectral vorticity step, every FFT2
  a pencil pipeline;
- ``fem_explicit``: the unstructured FEM steps (monolithic, projection,
  steady Stokes) with element-partitioned assembly;
- ``compressible_explicit``, ``compressible3d_explicit``,
  ``spectral_explicit``, ``incompressible3d_explicit``: the tiers the JAX
  package shards only through GSPMD (the wedge and supersonic cavity, the
  3D blast, the stable-fluids Kolmogorov step, the 3D cavity with a
  distributed multigrid, DCT or SOR pressure solve);
- ``sharded``: the entry point (``shard_state``, ``make_sharded_step``,
  which maps a single-device step module to its explicit counterpart) and
  distributed red-black SOR; ``mac_sharded.make_sharded_mac_step`` lifts a
  MAC step to the trimmed state;
- ``launch``: gloo ranks on the CPU (``spawn``), for tests and the dry run.

The JAX package reaches its GSPMD path by placing the state and jitting
the single-device step; XLA's partitioner has no counterpart here, so
``make_sharded_step`` returns a step written on blocks, never the
single-device step run on every rank.
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
from cfdsim_tpu_torch.parallel.boussinesq3d_explicit import (
    make_heated_cube_explicit_step,
    shard_boussinesq3d_state,
    trim_boussinesq3d_state,
    untrim_boussinesq3d_state,
)
from cfdsim_tpu_torch.parallel.fem_explicit import (
    make_projection_step as make_fem_projection_explicit_step,
)
from cfdsim_tpu_torch.parallel.fem_explicit import make_sharded_ns_apply, solve_stokes_sharded
from cfdsim_tpu_torch.parallel.fem_explicit import make_step as make_fem_explicit_step
from cfdsim_tpu_torch.parallel.halo import halo_exchange, make_sharded_stencil
from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import (
    MovingGhostGeometry,
    ShardedGhostIBM3D,
    ShardedGhostSet,
    apply_ghost_forcing_local,
    moving_ghost_forcing_stack,
    moving_ghost_width_2d,
    partition_ghost_ibm3d,
)
from cfdsim_tpu_torch.parallel.mac3d_explicit import (
    MAC3DLocalBCs,
    cavity3d_bc_kit,
    cavity3d_local_bcs,
    external_flow3d_local_bcs,
    free_slip3d_local_bcs,
    make_cavity3d_mac_explicit_step,
    make_mac3d_explicit_step,
    make_moving_body_mac3d_explicit_step,
    make_sphere_ghost_mac3d_explicit_step,
    make_sphere_mac3d_explicit_step,
    shard_trimmed_state3d,
    trim_face_masks3d,
    trim_state3d,
    untrim_state3d,
)
from cfdsim_tpu_torch.parallel.mac_explicit import (
    make_cavity_mac_explicit_step,
    make_cylinder_mac_explicit_step,
    make_mac_explicit_step,
    make_moving_body_mac_explicit_step,
    trim_face_masks,
)
from cfdsim_tpu_torch.parallel.mac_stretched3d_explicit import (
    make_cavity3d_stretched_explicit_step,
    make_moving_body3d_stretched_explicit_step,
    make_sphere3d_stretched_explicit_step,
    make_sphere_ghost3d_stretched_explicit_step,
    make_stretched3d_explicit_step,
)
from cfdsim_tpu_torch.parallel.mac_stretched_explicit import (
    make_cavity_stretched_explicit_step,
    make_cylinder_stretched_explicit_step,
    make_moving_body_stretched_explicit_step,
    make_stretched_mac_explicit_step,
)
from cfdsim_tpu_torch.parallel.compressible3d_explicit import make_blast3d_explicit_step
from cfdsim_tpu_torch.parallel.compressible_explicit import make_compressible_explicit_step
from cfdsim_tpu_torch.parallel.incompressible3d_explicit import (
    DistributedPoisson3D,
    make_cavity3d_explicit_step,
)
from cfdsim_tpu_torch.parallel.mac_sharded import (
    make_sharded_mac_step,
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
from cfdsim_tpu_torch.parallel.poisson2d_explicit import DistributedPoisson2D
from cfdsim_tpu_torch.parallel.sharded import (
    make_sharded_poisson,
    make_sharded_step,
    rbsor_local,
    shard_state,
)
from cfdsim_tpu_torch.parallel.spectral_explicit import make_spectral_explicit_step
from cfdsim_tpu_torch.parallel.spectral_ps_explicit import (
    full_spectrum_state,
    half_spectrum_state,
    make_ps_explicit_step,
)
from cfdsim_tpu_torch.parallel.transforms import (
    dct_poisson3d_local,
    dct_poisson_local,
    dst_helmholtz_local,
    make_fdm_poisson3d_local,
    make_fdm_poisson_local,
)
from cfdsim_tpu_torch.parallel.transport3d_explicit import (
    make_heated_sphere_explicit_step,
    make_heated_sphere_stretched_explicit_step,
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
    "make_moving_body_mac_explicit_step",
    "make_stretched_mac_explicit_step",
    "make_cavity_stretched_explicit_step",
    "make_cylinder_stretched_explicit_step",
    "make_moving_body_stretched_explicit_step",
    "ShardedGhostSet",
    "ShardedGhostIBM3D",
    "partition_ghost_ibm3d",
    "apply_ghost_forcing_local",
    "moving_ghost_width_2d",
    "MovingGhostGeometry",
    "moving_ghost_forcing_stack",
    "MAC3DLocalBCs",
    "cavity3d_bc_kit",
    "cavity3d_local_bcs",
    "free_slip3d_local_bcs",
    "external_flow3d_local_bcs",
    "trim_state3d",
    "untrim_state3d",
    "shard_trimmed_state3d",
    "trim_face_masks3d",
    "make_mac3d_explicit_step",
    "make_cavity3d_mac_explicit_step",
    "make_sphere_mac3d_explicit_step",
    "make_sphere_ghost_mac3d_explicit_step",
    "make_moving_body_mac3d_explicit_step",
    "make_stretched3d_explicit_step",
    "make_cavity3d_stretched_explicit_step",
    "make_sphere3d_stretched_explicit_step",
    "make_sphere_ghost3d_stretched_explicit_step",
    "make_moving_body3d_stretched_explicit_step",
    "make_heated_sphere_explicit_step",
    "make_heated_sphere_stretched_explicit_step",
    "make_heated_cube_explicit_step",
    "trim_boussinesq3d_state",
    "untrim_boussinesq3d_state",
    "shard_boussinesq3d_state",
    "full_spectrum_state",
    "half_spectrum_state",
    "make_ps_explicit_step",
    "make_sharded_ns_apply",
    "make_fem_explicit_step",
    "make_fem_projection_explicit_step",
    "solve_stokes_sharded",
    "shard_state",
    "make_sharded_step",
    "make_sharded_mac_step",
    "make_compressible_explicit_step",
    "make_blast3d_explicit_step",
    "make_spectral_explicit_step",
    "make_cavity3d_explicit_step",
    "DistributedPoisson3D",
    "DistributedPoisson2D",
]
