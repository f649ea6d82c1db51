"""The FEM tier's host modules in the port (``fem/mesh.py``, ``fem/msh_io.py``,
``fem/spaces.py``, copies of the JAX package's) and its sampler
(``fem/sample.py``) against the JAX package on the same inputs.

The meshes, DOF maps, tags and Dirichlet lifts are compared for equal
arrays (the seeded lattice and scipy's Delaunay give the same mesh in both
packages); the sampler's float32 tables to 1e-6 of their largest entry and
its sampled fields to 1e-6 of max|u| (float32 einsums summed in another
order).
"""

import numpy as np
import pytest
import torch

from cfdsim_tpu.fem import mesh as j_mesh
from cfdsim_tpu.fem import msh_io as j_msh
from cfdsim_tpu.fem import sample as j_sample
from cfdsim_tpu.fem import spaces as j_spaces
from cfdsim_tpu_torch.fem import mesh as t_mesh
from cfdsim_tpu_torch.fem import msh_io as t_msh
from cfdsim_tpu_torch.fem import sample as t_sample
from cfdsim_tpu_torch.fem import spaces as t_spaces

SAMPLE_RTOL = 1e-6


def assert_meshes_equal(a, b):
    for name in ("points", "tris", "edges", "tri_edges", "boundary_edges"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert getattr(a, name).dtype == getattr(b, name).dtype, name
    assert a.tags.keys() == b.tags.keys()
    for tag in a.tags:
        np.testing.assert_array_equal(a.tags[tag], b.tags[tag], err_msg=tag)
    assert a.geometry == b.geometry


@pytest.fixture(scope="module")
def cylinder_meshes():
    kw = dict(h_far=0.35, h_near=0.06)
    return j_mesh.cylinder_mesh(**kw), t_mesh.cylinder_mesh(**kw)


def test_cylinder_mesh_equal(cylinder_meshes):
    """The graded Delaunay cylinder mesh (seeded lattice, smoothing,
    re-triangulation) is the same mesh in both packages."""
    a, b = cylinder_meshes
    assert b.n_tris > 500
    assert_meshes_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(wake_box=(3.0, 6.0, -0.8, 0.8), h_wake=0.15,
                                             seed=3, smooth_iters=2)])
def test_cylinder_mesh_options_equal(kw):
    args = dict(h_far=0.5, h_near=0.12, **kw)
    assert_meshes_equal(j_mesh.cylinder_mesh(**args), t_mesh.cylinder_mesh(**args))


@pytest.mark.parametrize("crisscross", [False, True])
def test_rectangle_mesh_equal(crisscross):
    args = (7, 5, (0.0, 2.0), (-1.0, 1.0), crisscross)
    assert_meshes_equal(j_mesh.rectangle_mesh(*args), t_mesh.rectangle_mesh(*args))


@pytest.mark.parametrize("kind", ["p1p1", "p2p1"])
@pytest.mark.parametrize("tags", [None, ("inlet", "outlet", "walls", "cylinder")])
def test_spaces_and_lift_equal(cylinder_meshes, kind, tags):
    """DOF layout, Dirichlet mask and tag nodes (P2 midside nodes projected
    on the circle) and the lift of a parabolic inlet are equal arrays."""
    ma, mb = cylinder_meshes
    a = j_spaces.build_spaces(ma, kind, dirichlet_tags=tags)
    b = t_spaces.build_spaces(mb, kind, dirichlet_tags=tags)
    assert (a.kind, a.n_u, a.n_p, a.nloc_u) == (b.kind, b.n_u, b.n_p, b.nloc_u)
    for name in ("u_points", "elem_u", "elem_p", "dirichlet_mask"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a.dirichlet_tag_nodes.keys() == b.dirichlet_tag_nodes.keys()
    for tag in a.dirichlet_tag_nodes:
        np.testing.assert_array_equal(a.dirichlet_tag_nodes[tag], b.dirichlet_tag_nodes[tag])
    fns = {"inlet": lambda x, y: (1.0 - y * y / 4.0, 0 * y), "walls": lambda x, y: (0 * x, 0 * y)}
    np.testing.assert_array_equal(j_spaces.dirichlet_values(a, fns),
                                  t_spaces.dirichlet_values(b, fns))


def test_spaces_reject_unknown_kind(cylinder_meshes):
    with pytest.raises(ValueError, match="unknown FE space"):
        t_spaces.build_spaces(cylinder_meshes[1], "p3p2")


# the synthetic gmsh 4.1 document of tests/test_msh_io.py: a unit square,
# 4 nodes with sparse tags, 2 triangles, inlet/outlet/walls groups
TINY_MSH = """\
$MeshFormat
4.1 0 8
$EndMeshFormat
$PhysicalNames
4
1 1 "inlet"
1 2 "outlet"
1 3 "walls"
2 4 "domain"
$EndPhysicalNames
$Entities
4 4 1 0
1 0 0 0 0
2 1 0 0 0
3 1 1 0 0
4 0 1 0 0
1 0 0 0 0 1 0 1 3 2 1 -2
2 1 0 0 1 1 0 1 2 2 2 -3
3 0 1 0 1 1 0 1 3 2 3 -4
4 0 0 0 0 1 0 1 1 2 4 -1
1 0 0 0 1 1 0 1 4 4 1 2 3 4
$EndEntities
$Nodes
2 4 10 21
0 1 0 2
10
11
0 0 0
1 0 0
0 2 0 2
20
21
1 1 0
0 1 0
$EndNodes
$Elements
5 7 1 7
1 1 1 1
1 10 11
1 2 1 1
2 11 20
1 3 1 1
3 20 21
1 4 1 1
4 21 10
2 1 2 2
5 10 11 20
6 10 20 21
$EndElements
"""


def test_tiny_msh_parses_as_in_jax(tmp_path):
    """tests/test_msh_io.py:81: sparse tags remapped dense, CCW triangles,
    corner precedence inlet > walls > outlet; the same TriMesh as the JAX
    reader's (geometry included, its source path aside)."""
    path = tmp_path / "tiny.msh"
    path.write_text(TINY_MSH)
    m = t_msh.read_msh(path)
    assert m.n_points == 4 and m.n_tris == 2 and (m.areas() > 0).all()
    assert len(m.tags["inlet"]) == 2 and len(m.tags["walls"]) == 2
    assert len(m.tags["outlet"]) == 0
    assert m.geometry["bbox"] == (0.0, 1.0, 0.0, 1.0)
    assert_meshes_equal(j_msh.read_msh(path), m)


def test_msh_rejects_legacy_format(tmp_path):
    path = tmp_path / "legacy.msh"
    path.write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="4.x"):
        t_msh.read_msh(path)


@pytest.mark.parametrize("kind", ["p1p1", "p2p1"])
def test_sampler_matches_jax(cylinder_meshes, kind):
    """Grid and point samplers: gather indices and the validity mask equal,
    basis tables within 1e-6 of their max, and the sampled u, v, speed,
    vorticity and p within 1e-6 of each field's max (NaN where the JAX
    package has NaN: inside the cylinder)."""
    ma, mb = cylinder_meshes
    a = j_spaces.build_spaces(ma, kind)
    b = t_spaces.build_spaces(mb, kind)
    xs, ys = np.linspace(-0.5, 7.5, 21), np.linspace(-1.5, 1.5, 13)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((a.n_u, 2)).astype(np.float32)
    p = rng.standard_normal(a.n_p).astype(np.float32)
    pts = np.stack([rng.uniform(-1, 8, 9), rng.uniform(-2, 2, 9)], axis=1)
    for ta, tb in ((j_sample.build_sampler(a, xs, ys), t_sample.build_sampler(b, xs, ys,
                                                                             device="cpu")),
                   (j_sample.point_sampler(a, pts), t_sample.point_sampler(b, pts,
                                                                           device="cpu"))):
        assert ta.shape == tb.shape
        for name in ("idx", "idx_p", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(ta, name)),
                                          getattr(tb, name).numpy(), err_msg=name)
        for name in ("N", "Np", "G"):
            want = np.asarray(getattr(ta, name))
            np.testing.assert_allclose(getattr(tb, name).numpy(), want, rtol=0,
                                       atol=SAMPLE_RTOL * np.abs(want).max(), err_msg=name)
        fa = j_sample.sample_fields(ta, u, p)
        fb = t_sample.sample_fields(tb, torch.from_numpy(u), torch.from_numpy(p))
        assert fa.keys() == fb.keys()
        for name in fa:
            want = np.asarray(fa[name])
            np.testing.assert_allclose(fb[name].numpy(), want, rtol=0,
                                       atol=SAMPLE_RTOL * np.nanmax(np.abs(want)),
                                       err_msg=name)


def test_sampler_exact_gradient_vorticity():
    """tests/test_fem.py:301: a rigid rotation u = (−ωy, ωx) has vorticity
    2ω at every sample point (the per-sample Jacobian inversion)."""
    mesh = t_mesh.rectangle_mesh(6, 5, (-1.0, 1.0), (-1.0, 1.0))
    sp = t_spaces.build_spaces(mesh, "p1p1")
    omega = 0.75
    u = np.stack([-omega * sp.u_points[:, 1], omega * sp.u_points[:, 0]], axis=1)
    tab = t_sample.build_sampler(sp, np.linspace(-0.9, 0.9, 7), np.linspace(-0.9, 0.9, 5),
                                 device="cpu")
    f = t_sample.sample_fields(tab, torch.tensor(u, dtype=torch.float32))
    np.testing.assert_allclose(f["vorticity"].numpy(), 2 * omega, rtol=1e-5)
    np.testing.assert_allclose(f["u"].numpy(),
                               -omega * np.linspace(-0.9, 0.9, 5)[:, None] * np.ones((1, 7)),
                               atol=1e-6)
