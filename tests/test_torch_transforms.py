"""The pencil transforms of ``cfdsim_tpu_torch/parallel/transforms.py`` on a
2×2 mesh of gloo ranks against the JAX package's single-device solvers
(the twins of tests/test_transforms.py, whose tolerances they keep; the
JAX tests use a 2×4 mesh of 8 virtual devices, the port one group of 4
ranks per module). One case also runs the JAX package's own distributed
solve on a 2×2 mesh of 4 of its virtual devices; and a gradient through the
pencil all-to-alls matches the single-device solve's.

One group of ranks runs every case (``_transform_ranks``) and rank 0
returns the gathered results. JAX is imported inside the tests: the ranks
import this module for their function and need torch alone.
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)


def _inputs():
    from cfdsim_tpu_torch.models.mac_stretched import wall_clustered_faces

    rhs2 = np.random.default_rng(2).standard_normal((32, 64)).astype(np.float32)
    return {
        "dct2": np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32),
        "roundtrip": np.random.default_rng(1).standard_normal((32, 32)).astype(np.float32),
        "poisson": rhs2 - rhs2.mean(),
        "helmholtz": np.random.default_rng(3).standard_normal((32, 64)).astype(np.float32),
        "fdm": np.random.default_rng(4).standard_normal((32, 64)).astype(np.float32),
        "hx": np.diff(wall_clustered_faces(64, 1.0, beta=1.7)),
        "hy": np.diff(wall_clustered_faces(32, 1.0, beta=1.3)),
        "poisson3d": np.random.default_rng(5).standard_normal((8, 16, 16)).astype(np.float32),
        "weights": np.random.default_rng(6).standard_normal((32, 64)).astype(np.float32),
    }


def _transform_ranks(mesh, x):
    from cfdsim_tpu_torch.parallel.mesh import gather_blocks, local_block
    from cfdsim_tpu_torch.parallel.transforms import (
        dct2_local,
        dct_poisson3d_local,
        dct_poisson_local,
        dst_helmholtz_local,
        idct2_local,
        make_fdm_poisson_local,
    )

    def run(fn, a):
        return gather_blocks(fn(local_block(a, mesh)), mesh).numpy()

    out = {
        "dct2": run(lambda b: dct2_local(b, mesh), x["dct2"]),
        "roundtrip": run(lambda b: idct2_local(dct2_local(b, mesh), mesh), x["roundtrip"]),
        "poisson": run(lambda b: dct_poisson_local(b, 0.1, 0.2, mesh), x["poisson"]),
        "helmholtz": run(lambda b: dst_helmholtz_local(b, 0.037, 0.1, 0.2, mesh),
                         x["helmholtz"]),
        "fdm": run(make_fdm_poisson_local(x["hx"], x["hy"], mesh), x["fdm"]),
        "poisson3d": run(lambda b: dct_poisson3d_local(b, 0.1, 0.2, 0.3, mesh),
                         x["poisson3d"]),
    }
    # a gradient through the six pencil all-to-alls
    rhs = local_block(x["poisson"], mesh).requires_grad_()
    (dct_poisson_local(rhs, 0.1, 0.2, mesh) * local_block(x["weights"], mesh)).sum().backward()
    out["poisson_grad"] = gather_blocks(rhs.grad, mesh).numpy()
    # 8×6 on 2×2: blocks of 3 columns, not divisible by py = 2
    try:
        dct2_local(local_block(np.zeros((8, 6), np.float32), mesh), mesh)
        out["pencil_error"] = None
    except ValueError as e:
        out["pencil_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def results():
    from cfdsim_tpu_torch.parallel.launch import spawn

    x = _inputs()
    return x, spawn(_transform_ranks, 4, TOPOLOGY, x, device="cpu")


def test_distributed_dct2_matches(results):
    import jax.numpy as jnp
    from cfdsim_tpu.solvers.poisson import _dct_fwd

    x, got = results
    want = np.asarray(_dct_fwd(_dct_fwd(jnp.asarray(x["dct2"]), axis=0), axis=1))
    np.testing.assert_allclose(got["dct2"], want, rtol=1e-5, atol=1e-4)


def test_distributed_idct2_inverts(results):
    x, got = results
    np.testing.assert_allclose(got["roundtrip"], x["roundtrip"], rtol=1e-5, atol=1e-5)


def test_distributed_dct_poisson_matches_single_device(results):
    import jax.numpy as jnp
    from cfdsim_tpu.solvers.poisson import lap_neumann, solve_poisson_neumann_dct

    x, got = results
    want = np.asarray(solve_poisson_neumann_dct(jnp.asarray(x["poisson"]), 0.1, 0.2))
    np.testing.assert_allclose(got["poisson"], want, rtol=0, atol=1e-5)
    # and it solves the clamped-edge problem
    res = np.asarray(lap_neumann(jnp.asarray(got["poisson"]), 0.1, 0.2)) - x["poisson"]
    assert np.abs(res - res.mean()).max() < 1e-3


def test_distributed_dct_poisson_matches_jax_on_a_2x2_mesh(results):
    """The JAX package's own pencil solve on a 2×2 mesh of 4 virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from cfdsim_tpu.parallel.mesh import make_grid_mesh
    from cfdsim_tpu.parallel.transforms import dct_poisson_local

    x, got = results
    mesh = make_grid_mesh(4, topology=TOPOLOGY)
    f = jax.shard_map(lambda b: dct_poisson_local(b, 0.1, 0.2, *TOPOLOGY), mesh=mesh,
                      in_specs=P("y", "x"), out_specs=P("y", "x"))
    xs = jax.device_put(jnp.asarray(x["poisson"]), NamedSharding(mesh, P("y", "x")))
    np.testing.assert_allclose(got["poisson"], np.asarray(jax.jit(f)(xs)), rtol=0, atol=1e-5)


def test_distributed_dct_poisson_gradient_matches_single_device(results):
    """The all-to-alls transpose: d Σ w·φ(rhs) / d rhs across the ranks equals
    the single-device solve's gradient."""
    from cfdsim_tpu_torch.solvers.poisson import solve_poisson_neumann_dct

    x, got = results
    rhs = torch.from_numpy(x["poisson"]).requires_grad_()
    (solve_poisson_neumann_dct(rhs, 0.1, 0.2) * torch.from_numpy(x["weights"])).sum().backward()
    want = rhs.grad.numpy()
    assert np.abs(got["poisson_grad"] - want).max() <= 1e-5 * np.abs(want).max()


def test_distributed_dst_helmholtz_matches_single_device(results):
    import jax.numpy as jnp
    from cfdsim_tpu.solvers.helmholtz import solve_helmholtz_dirichlet

    x, got = results
    b = x["helmholtz"]
    want = np.asarray(solve_helmholtz_dirichlet(jnp.asarray(b), 0.037, 0.1, 0.2))
    np.testing.assert_allclose(got["helmholtz"], want, rtol=0, atol=1e-5)
    # the boundary frame is kept exactly
    np.testing.assert_array_equal(got["helmholtz"][0, :], b[0, :])
    np.testing.assert_array_equal(got["helmholtz"][:, -1], b[:, -1])


def test_distributed_fdm_matches_single_device(results):
    import jax.numpy as jnp
    from cfdsim_tpu.solvers.fdm import make_fdm_solver

    x, got = results
    want = np.asarray(make_fdm_solver(x["hx"], x["hy"])(jnp.asarray(x["fdm"])))
    np.testing.assert_allclose(got["fdm"], want, rtol=0, atol=1e-6)


def test_distributed_dct_poisson3d_matches_single_device(results):
    import jax.numpy as jnp
    from cfdsim_tpu.solvers.poisson3d import Poisson3DConfig, solve_poisson_3d

    x, got = results
    rhs = jnp.asarray(x["poisson3d"])
    want = np.asarray(solve_poisson_3d(jnp.zeros_like(rhs), rhs, 0.1, 0.2, 0.3,
                                       Poisson3DConfig(method="dct")))
    np.testing.assert_allclose(got["poisson3d"], want, rtol=0, atol=1e-5)


def test_pencil_shape_validation(results):
    from cfdsim_tpu_torch.parallel.transforms import _check_pencil

    _, got = results
    assert got["pencil_error"] is not None and "pencil" in got["pencil_error"]
    # the JAX test's input: 8×12 on a 2×4 mesh gives blocks of 4×3, whose 3
    # columns do not divide over py = 2
    with pytest.raises(ValueError, match="pencil"):
        _check_pencil((8 // 2, 12 // 4), 2, 4)
    _check_pencil((4, 4), 2, 2)
