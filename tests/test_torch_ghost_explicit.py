"""The ghost-cell IBM on gloo ranks (``cfdsim_tpu_torch/parallel/ibm_ghost_explicit.py``
and the 3D steps that use it) against the JAX package's single-device
apply and steps and the port's own, from the same seeded numpy inputs: the
twins of every row of tests/test_ghost_explicit.py with their grids, step
counts and tolerances (on a 2×2 mesh of 4 ranks), its Smagorinsky and
dynamic LES rows (:371) included; and the partition's own contracts: each
rank's table holds its ghost faces in the global table's order, unpadded,
and the partition refuses a body on a dropped boundary face or a halo
wider than a block.

One group of ranks runs every case; the case table and runners are
tests/test_torch_mac3d_explicit.py's. JAX is imported inside the tests.
"""

import numpy as np
import pytest
import torch
from test_torch_mac3d_explicit import (
    CASES,
    TOPOLOGY,
    _cs2_engaged,
    _fake_mesh,
    check_twins,
    run_jax_single,
    spawn_beside,
)

GHOST_CASES = [k for k in CASES if k.startswith("ghost_")]
SPHERE = dict(nx=32, ny=16, nz=16, center=(2.0, 2.0, 2.0), radius=0.5)


def _faces():
    g = dict(x=8.0, y=4.0, z=4.0)
    return tuple(np.arange(SPHERE[f"n{a}"] + 1) * (g[a] / SPHERE[f"n{a}"]) for a in "xyz")


def _apply_inputs():
    """The raw apply's inputs: random face fields (the JAX test's seed 3)."""
    nx, ny, nz = SPHERE["nx"], SPHERE["ny"], SPHERE["nz"]
    rng = np.random.default_rng(3)
    return (rng.standard_normal((nz, ny, nx + 1)).astype(np.float32),
            rng.standard_normal((nz, ny + 1, nx)).astype(np.float32),
            rng.standard_normal((nz + 1, ny, nx)).astype(np.float32))


def _ghost_ranks(mesh):
    from test_torch_mac3d_explicit import _ranks

    from cfdsim_tpu_torch.ibm_ghost import sphere_ghost_ibm
    from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import (
        apply_ghost_forcing_local,
        partition_ghost_ibm3d,
    )
    from cfdsim_tpu_torch.parallel.mesh import gather_blocks, local_block

    out = _ranks(mesh, GHOST_CASES)
    ghost = sphere_ghost_ibm(*_faces(), SPHERE["center"], SPHERE["radius"], device="cpu")
    tables, width = partition_ghost_ibm3d(ghost, SPHERE["nx"], SPHERE["ny"], SPHERE["nz"], mesh)
    u, v, w = _apply_inputs()
    trimmed = (u[:, :, :-1], v[:, :-1, :], w[:-1])
    for comp, field, gs in zip("uvw", trimmed, tables):
        o, d = apply_ghost_forcing_local(local_block(field, mesh), gs, mesh, width, 0.7)
        out[f"apply_{comp}"] = gather_blocks(o, mesh).numpy()
        out[f"apply_d{comp}"] = gather_blocks(d, mesh).numpy()
    out["width"] = width
    return out


@pytest.fixture(scope="module")
def results():
    return spawn_beside(_ghost_ranks,
                        local=lambda: {name: run_jax_single(name) for name in GHOST_CASES})


def test_apply_ghost_forcing_local_matches_global(results):
    """The raw apply on each component == the single-device apply on the
    whole array (the JAX package's and the port's), to 5e-7."""
    import jax.numpy as jnp
    from cfdsim_tpu.ibm_ghost import apply_ghost_forcing as jax_apply
    from cfdsim_tpu.ibm_ghost import sphere_ghost_ibm as jax_sphere_ghost_ibm

    from cfdsim_tpu_torch.ibm_ghost import apply_ghost_forcing, sphere_ghost_ibm

    ranks = results["ranks"]
    faces = _faces()
    jghost = jax_sphere_ghost_ibm(*faces, SPHERE["center"], SPHERE["radius"])
    ghost = sphere_ghost_ibm(*faces, SPHERE["center"], SPHERE["radius"], device="cpu")
    crop = (np.s_[:, :, :-1], np.s_[:, :-1, :], np.s_[:-1])
    for comp, field, sl in zip("uvw", _apply_inputs(), crop):
        ref, dref = jax_apply(jnp.asarray(field), getattr(jghost, comp), jnp.float32(0.7))
        port, dport = apply_ghost_forcing(torch.as_tensor(field), getattr(ghost, comp), 0.7)
        for want in (np.asarray(ref), port.numpy()):
            np.testing.assert_allclose(ranks[f"apply_{comp}"], want[sl], rtol=0, atol=5e-7)
        for want in (np.asarray(dref), dport.numpy()):
            np.testing.assert_allclose(ranks[f"apply_d{comp}"], want[sl], rtol=0, atol=5e-7)
    assert ranks["width"] >= 1


def test_sphere_ghost_explicit_matches_single_device(results):
    """External-flow BCs, the ghost forcing and the 3D DCT projection, forces
    included."""
    got = check_twins(results, "ghost_sphere", 2e-5, 2e-4, fx=(1e-4, 1e-6), fy=(1e-4, 1e-6),
                      fz=(1e-4, 1e-6), max_vel=(1e-5, 0.0))
    assert got["metrics"]["fx"] > 0.0


def test_sphere_ghost_stretched_explicit_matches_single_device(results):
    """Nonuniform probe stencils, volume-weighted forces, area-weighted
    outflow."""
    got = check_twins(results, "ghost_sphere_stretched", 3e-5, 3e-4, fx=(2e-4, 1e-6),
                      fy=(2e-4, 1e-6), fz=(2e-4, 1e-6))
    assert got["metrics"]["fx"] > 0.0


@pytest.mark.parametrize("name,atol", [("ghost_heated_sphere", 2e-5),
                                       ("ghost_heated_sphere_stretched", 3e-5)])
def test_heated_sphere_ghost_explicit_matches_single_device(results, name, atol):
    """The ghost forcing of momentum and of θ (the cell-centred set cut with
    the same width), the Nusselt number included."""
    got = check_twins(results, name, atol, rtol_dt=1e-5, nusselt=(2e-4, 0.0), fx=(2e-4, 1e-6),
                      theta_max=(1e-4, 0.0))
    assert got["metrics"]["nusselt"] != 0.0


def test_sphere_ghost_dynamic_les_explicit_matches_single_device(results):
    """The dynamic contraction leaves the body out through this rank's block
    of the ghost sets' solid cells (C_s² equal to partial-sum rounding)."""
    assert _cs2_engaged("ghost_dynamic") > 1e-5
    check_twins(results, "ghost_dynamic", 5e-5, 5e-4, rtol_dt=1e-5, fx=(2e-4, 1e-6))


@pytest.mark.parametrize("les_model", ["smagorinsky", "dynamic"])
def test_sphere_ghost_stretched_les_explicit_matches_single_device(results, les_model):
    """The Re = 3900 configuration's tiers together: the stretched grid, the
    ghost-cell wall and LES (static and dynamic)."""
    check_twins(results, f"ghost_stretched_les_{les_model}", 5e-5, 5e-4, rtol_dt=1e-5,
                fx=(3e-4, 1e-6))


def test_partition_keeps_each_ghost_face_once_in_global_order():
    """Every rank's table holds exactly its own ghost faces, in the global
    table's order and unpadded; together the ranks hold every face once,
    with its probe weights and factor."""
    from cfdsim_tpu_torch.ibm_ghost import sphere_ghost_ibm
    from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import partition_ghost_ibm3d

    nx, ny, nz = SPHERE["nx"], SPHERE["ny"], SPHERE["nz"]
    ghost = sphere_ghost_ibm(*_faces(), SPHERE["center"], SPHERE["radius"], device="cpu")
    widths = set()
    for comp in "uvw":
        full = getattr(ghost, comp)
        want = [(int(z), int(y), int(x), tuple(w.tolist()), float(s))
                for z, y, x, w, s in zip(full.gz, full.gy, full.gx, full.pw, full.scale)]
        held = 0
        for rank in range(4):
            mesh = _fake_mesh(*TOPOLOGY)
            mesh.rank, (mesh.iy, mesh.ix) = rank, divmod(rank, TOPOLOGY[1])
            tables, width = partition_ghost_ibm3d(ghost, nx, ny, nz, mesh)
            widths.add(width)
            gs = getattr(tables, comp)
            y0, x0 = mesh.iy * ny // 2, mesh.ix * nx // 2
            rows = [(int(z), int(y) + y0, int(x) + x0, tuple(w.tolist()), float(s))
                    for z, y, x, w, s in zip(gs.gz, gs.gy, gs.gx, gs.pw, gs.scale)]
            mine = [r for r in want
                    if (r[1] // (ny // 2), r[2] // (nx // 2)) == (mesh.iy, mesh.ix)]
            assert rows == mine
            held += len(rows)
        assert held == len(want) > 0
    assert len(widths) == 1


@pytest.mark.parametrize("case", ["dropped_x_face", "halo_wider_than_block"])
def test_partition_refusals(case):
    """A body on a dropped boundary face, or probes that need a halo wider
    than a block (ibm_ghost_explicit.py:123-127, :212)."""
    from cfdsim_tpu_torch.ibm_ghost import sphere_ghost_ibm
    from cfdsim_tpu_torch.parallel.ibm_ghost_explicit import partition_ghost_ibm3d

    nx, ny, nz = SPHERE["nx"], SPHERE["ny"], SPHERE["nz"]
    if case == "dropped_x_face":
        ghost = sphere_ghost_ibm(*_faces(), (7.9, 2.0, 2.0), 0.5, device="cpu")
        mesh, match = _fake_mesh(*TOPOLOGY), "dropped x boundary face"
    else:
        ghost = sphere_ghost_ibm(*_faces(), SPHERE["center"], SPHERE["radius"], device="cpu")
        mesh, match = _fake_mesh(16, 1), "halo width"
    with pytest.raises(ValueError, match=match):
        partition_ghost_ibm3d(ghost, nx, ny, nz, mesh)
