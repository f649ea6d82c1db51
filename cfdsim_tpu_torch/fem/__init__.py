"""Unstructured finite-element tier (``cfdsim_tpu.fem``).

Meshing is a host-side graded-Delaunay generator (``fem/mesh.py``, a copy
of the JAX package's, so a seed gives the same mesh in both packages) run
once at set-up, with a gmsh ``.msh`` reader beside it (``fem/msh_io.py``).
Everything per step is a batched einsum pipeline over all elements at once
(``fem/assembly.py``): gather the element DOFs, contract against the
quadrature tables, sum into nodes in a fixed order; the operators are
matrix-free and fed to the Krylov solvers of ``solvers/krylov.py``. Both
spaces of the JAX package exist: equal-order P1-P1 with pressure
stabilization and Taylor-Hood P2-P1 (``fem/spaces.py``).
"""

from cfdsim_tpu_torch.fem.mesh import TriMesh, cylinder_mesh, rectangle_mesh
from cfdsim_tpu_torch.fem.spaces import FESpaces, build_spaces, dirichlet_values
from cfdsim_tpu_torch.fem.assembly import ElementOps, build_element_ops
from cfdsim_tpu_torch.fem.sample import SampleTable, build_sampler, sample_fields

__all__ = [
    "TriMesh",
    "cylinder_mesh",
    "rectangle_mesh",
    "FESpaces",
    "build_spaces",
    "dirichlet_values",
    "ElementOps",
    "build_element_ops",
    "SampleTable",
    "build_sampler",
    "sample_fields",
]
