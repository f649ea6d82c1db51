"""The rank grid, halo exchange and distributed red-black SOR of
``cfdsim_tpu_torch/parallel`` on 4 gloo ranks (the explicit rows of
tests/test_parallel.py:28-62 and the trimmed-state round trip of :175,
with their tolerances), and the layer's own contracts: the exchange equals
windows of the zero-padded global field, its backward is the transpose,
the reductions and the global-index helpers; the dry run on gloo ranks, and
spawn refusing more NCCL ranks than cards.

One group of ranks runs every case (``_parallel_ranks``), on a 2×2 mesh
and, for the mesh checks, on 1×4 and 4×1 meshes of the same group. JAX is
imported inside the tests: the ranks import this module for their
function and need torch alone.
"""

import numpy as np
import pytest
import torch

TOPOLOGY = (2, 2)
STENCIL = dict(dx=0.1, dy=0.2)


def _inputs():
    rhs = np.random.default_rng(1).standard_normal((32, 64)).astype(np.float32)
    rng = np.random.default_rng(7)
    return {
        "phi": np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32),
        "rhs": rhs - rhs.mean(),
        "fields": rng.standard_normal((3, 16, 24)).astype(np.float32),
        "cotangent_w1": rng.standard_normal((4, 8 + 2, 12 + 2)).astype(np.float32),
        "cotangent_w2": rng.standard_normal((4, 8 + 4, 12 + 4)).astype(np.float32),
        "values": rng.standard_normal(4).astype(np.float32),
    }


def _parallel_ranks(mesh, x):
    from cfdsim_tpu_torch.ops.stencil import laplacian
    from cfdsim_tpu_torch.parallel.halo import (
        clamp_global_edges,
        global_interior_mask,
        global_parity,
        halo_exchange,
        make_sharded_stencil,
    )
    from cfdsim_tpu_torch.parallel.mesh import (
        gather_blocks,
        local_block,
        make_grid_mesh,
        pmax,
        psum,
    )
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_poisson

    out = {"meshes": []}
    for topo in ((1, 4), (4, 1)):
        m = make_grid_mesh(topo)
        out["meshes"].append(gather_blocks(torch.tensor(
            [[[m.rank, m.iy, m.ix, m.py, m.px]]], dtype=torch.float32), m).numpy())
    out["meshes"].append(gather_blocks(torch.tensor(
        [[[mesh.rank, mesh.iy, mesh.ix, mesh.py, mesh.px]]], dtype=torch.float32),
        mesh).numpy())
    try:
        mesh.check(torch.empty(0, device="meta"))
        out["check"] = None
    except ValueError as e:
        out["check"] = str(e)

    dx, dy = STENCIL["dx"], STENCIL["dy"]
    lap = make_sharded_stencil(lambda p: laplacian(p, dx, dy), mesh, n_in=1, width=1)
    out["stencil"] = gather_blocks(lap(local_block(x["phi"], mesh)), mesh).numpy()
    solve = make_sharded_poisson(mesh, 1.0 / 32, 1.0 / 32, iters=40, omega=1.7)
    rhs_b = local_block(x["rhs"], mesh)
    out["rbsor"] = gather_blocks(solve(torch.zeros_like(rhs_b), rhs_b), mesh).numpy()

    # the exchange, its clamp, and its transpose, on a stack of 3 fields
    fields = local_block(x["fields"], mesh)
    for w in (1, 2):
        blk = fields.clone().requires_grad_()
        padded = halo_exchange(blk, mesh, w)
        out[f"halo{w}"] = gather_blocks(padded.detach()[None], mesh).numpy()
        out[f"clamped{w}"] = gather_blocks(clamp_global_edges(padded.detach(), mesh, w)[None],
                                           mesh).numpy()
        cot = torch.from_numpy(x[f"cotangent_w{w}"][mesh.rank])
        (padded * cot).sum().backward()
        out[f"halo_grad{w}"] = gather_blocks(blk.grad, mesh).numpy()
    shape = tuple(fields.shape[-2:])
    out["parity"] = gather_blocks(global_parity(shape, mesh), mesh).numpy()
    out["interior2"] = gather_blocks(global_interior_mask(shape, mesh, 2), mesh).numpy()

    # the reductions over the mesh, and the max's gradient
    v = torch.tensor(x["values"][mesh.rank]).requires_grad_()
    s, m = psum(v, mesh), pmax(v, mesh)
    (2.0 * s + 3.0 * m).backward()
    out["reductions"] = gather_blocks(torch.stack([s, m, v.grad]).detach()[:, None, None],
                                      mesh).numpy()
    return out


@pytest.fixture(scope="module")
def results():
    from cfdsim_tpu_torch.parallel.launch import spawn

    x = _inputs()
    return x, spawn(_parallel_ranks, 4, TOPOLOGY, x, device="cpu")


def test_mesh_shapes(results):
    from cfdsim_tpu_torch.parallel.mesh import _factor_2d

    _, got = results
    rows_1x4, rows_4x1, rows_2x2 = (g.reshape(-1, 5) for g in got["meshes"])
    # gathered in mesh order: rank r at (r // px, r % px)
    for rows, (py, px) in ((rows_1x4, (1, 4)), (rows_4x1, (4, 1)), (rows_2x2, (2, 2))):
        want = [[r, r // px, r % px, py, px] for r in range(4)]
        np.testing.assert_array_equal(rows, want)
    assert _factor_2d(4) == (2, 2) and _factor_2d(8) == (2, 4) and _factor_2d(6) == (2, 3)
    assert got["check"] is not None and "gloo" in got["check"]


def test_sharded_stencil_matches_single_device(results):
    import jax.numpy as jnp
    from cfdsim_tpu.ops.stencil import laplacian

    x, got = results
    want = np.asarray(laplacian(jnp.asarray(x["phi"]), **STENCIL))
    np.testing.assert_allclose(got["stencil"], want, rtol=1e-5, atol=1e-5)


def test_sharded_stencil_matches_jax_on_a_2x2_mesh(results):
    """The JAX package's own sharded stencil on 4 of its virtual devices."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.ops.stencil import laplacian
    from cfdsim_tpu.parallel.halo import make_sharded_stencil
    from cfdsim_tpu.parallel.mesh import field_sharding, make_grid_mesh

    x, got = results
    mesh = make_grid_mesh(4, topology=TOPOLOGY)
    op = make_sharded_stencil(lambda p: laplacian(p, **STENCIL), mesh, n_in=1, width=1)
    want = np.asarray(op(jax.device_put(jnp.asarray(x["phi"]), field_sharding(mesh))))
    np.testing.assert_allclose(got["stencil"], want, rtol=1e-5, atol=1e-5)


def test_sharded_rbsor_matches_single_device(results):
    import jax.numpy as jnp
    from cfdsim_tpu.solvers.poisson import PoissonConfig, solve_poisson

    x, got = results
    rhs = jnp.asarray(x["rhs"])
    h = 1.0 / 32
    want = np.asarray(solve_poisson(jnp.zeros_like(rhs), rhs, h, h,
                                    PoissonConfig(method="rbsor", iters=40, omega=1.7)))
    np.testing.assert_allclose(got["rbsor"], want, rtol=1e-4, atol=1e-4)


def _windows(fields, w, clamp):
    """Every rank's padded block cut from the global stack: zero halos past
    the global edges (edge copies with ``clamp``)."""
    mode = "edge" if clamp else "constant"
    g = np.pad(fields, ((0, 0), (w, w), (w, w)), mode=mode)
    ny_l, nx_l = fields.shape[1] // 2, fields.shape[2] // 2
    return {(iy, ix): g[:, iy * ny_l:iy * ny_l + ny_l + 2 * w, ix * nx_l:ix * nx_l + nx_l + 2 * w]
            for iy in range(2) for ix in range(2)}


def _blocks(gathered, w, ny_l, nx_l):
    """Split a gathered array of padded blocks back into the blocks."""
    a = gathered[0]
    hy, hx = ny_l + 2 * w, nx_l + 2 * w
    return {(iy, ix): a[:, iy * hy:(iy + 1) * hy, ix * hx:(ix + 1) * hx]
            for iy in range(2) for ix in range(2)}


@pytest.mark.parametrize("w", [1, 2])
def test_halo_exchange_is_a_window_of_the_padded_field(results, w):
    x, got = results
    for clamp, key in ((False, f"halo{w}"), (True, f"clamped{w}")):
        want = _windows(x["fields"], w, clamp)
        have = _blocks(got[key], w, 8, 12)
        for k in want:
            np.testing.assert_array_equal(have[k], want[k], err_msg=f"{key} block {k}")


@pytest.mark.parametrize("w", [1, 2])
def test_halo_exchange_backward_is_its_transpose(results, w):
    """d Σ(padded · c)/d block: each rank's cotangent window added back into
    the global field at the window's place (the zero halos take nothing)."""
    x, got = results
    fields = x["fields"]
    g = np.zeros((3, fields.shape[1] + 2 * w, fields.shape[2] + 2 * w), np.float64)
    ny_l, nx_l = 8, 12
    for r in range(4):
        iy, ix = divmod(r, 2)
        cot = x[f"cotangent_w{w}"][r][None]  # the same window for the 3 fields
        g[:, iy * ny_l:iy * ny_l + ny_l + 2 * w, ix * nx_l:ix * nx_l + nx_l + 2 * w] += cot
    want = g[:, w:-w, w:-w]
    np.testing.assert_allclose(got[f"halo_grad{w}"], want, rtol=0, atol=1e-5)


def test_global_index_helpers(results):
    _, got = results
    i, j = np.meshgrid(np.arange(16), np.arange(24), indexing="ij")
    np.testing.assert_array_equal(got["parity"], (i + j) % 2 == 0)
    np.testing.assert_array_equal(got["interior2"], (i >= 2) & (i < 14) & (j >= 2) & (j < 22))


def test_reductions_and_the_max_gradient(results):
    x, got = results
    rows = got["reductions"]  # (psum, pmax, gradient) × the 2×2 ranks
    v = x["values"]
    np.testing.assert_allclose(rows[0], np.full((2, 2), v.sum()), rtol=1e-6)
    np.testing.assert_array_equal(rows[1], np.full((2, 2), v.max()))
    # every rank's 2·psum gives each input 2·4; the max's 3 from each of the
    # 4 ranks goes to the winner
    want = np.full(4, 8.0)
    want[np.argmax(v)] += 12.0
    np.testing.assert_allclose(rows[2].reshape(4), want, rtol=1e-6)


def test_mac_trimmed_roundtrip_bitwise_exact():
    """The trimmed state loses nothing: padding + set_normal rebuilds the
    dropped boundary faces exactly, and stepping through the trimmed state
    is bit-equal to stepping the full one (tests/test_parallel.py:175)."""
    from cfdsim_tpu_torch.cases import lid_cavity_mac
    from cfdsim_tpu_torch.parallel.mac_sharded import trim_state, untrim_state

    case = lid_cavity_mac(n=32, Re=100.0, device="cpu")
    bcs = case.extras["bcs"]
    t = trim_state(case.state)
    ref = case.state
    for _ in range(5):
        t = trim_state(case.step(untrim_state(t, bcs), 1.0)[0])
        ref, _ = case.step(ref, 1.0)
    full = untrim_state(t, bcs)
    assert torch.equal(full.u, ref.u) and torch.equal(full.v, ref.v)
    assert torch.equal(full.p, ref.p)


def test_boussinesq_trimmed_roundtrip_bitwise_exact():
    """The closed box's dropped boundary faces are zero, so untrimming the
    trimmed Boussinesq state rebuilds it exactly, after steps as at rest."""
    from cfdsim_tpu_torch.cases import heated_cavity
    from cfdsim_tpu_torch.parallel.boussinesq_explicit import (
        trim_boussinesq_state,
        untrim_boussinesq_state,
    )

    case = heated_cavity(n=16, Ra=1e4, device="cpu")
    s = case.state
    for _ in range(3):
        s, _ = case.step(s, 1.0)
        back = untrim_boussinesq_state(trim_boussinesq_state(s))
        assert all(torch.equal(a, b) for a, b in zip(back, s))


def test_dryrun_on_gloo_ranks(capsys):
    """``python -m cfdsim_tpu_torch.parallel.dryrun --ranks 4 --device cpu``:
    every check within its tolerance on a 2×2 gloo mesh, the FEM and
    pseudo-spectral steps (JAX dry-run steps 7, 7b, 8) and the GSPMD steps'
    counterparts through ``make_sharded_step`` (steps 1, 3, 6e, with the
    Kolmogorov and blast tiers) included."""
    import json

    from cfdsim_tpu_torch.parallel.dryrun import main

    assert main(["--ranks", "4", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["check"] for r in rows[:-1]] == [
        "rbsor_solve", "cavity_step", "mac_cavity_step", "heated_cavity_step",
        "moving_body_step", "cavity3d_mac_step", "cavity3d_mac_tvd_les_step",
        "cavity3d_mac_dynamic_les_step", "sphere_step", "heated_sphere_step",
        "sphere_stretched_step", "sphere_stretched_dynamic_les_step",
        "heated_sphere_stretched_step", "sphere_ghost_step", "heated_sphere_stretched_ghost_step",
        "moving_sphere_step", "moving_body_stretched_step", "moving_sphere_ghost_step",
        "moving_body_stretched_ghost_step", "moving_sphere_stretched_step", "heated_cube_step",
        "fem_step", "fem_projection_step", "ps_step", "gspmd_cavity_step",
        "gspmd_cavity3d_step", "gspmd_wedge_step", "gspmd_kolmogorov_step",
        "gspmd_blast3d_step"]
    assert all(r["ok"] for r in rows[:-1])
    assert rows[-1] == {"dryrun_ok": True, "ranks": 4, "mesh": [2, 2], "device": "cpu"}


def test_spawn_refuses_more_nccl_ranks_than_cards():
    from cfdsim_tpu_torch.parallel.launch import spawn

    with pytest.raises(RuntimeError, match="CUDA devices"):
        spawn(print, torch.cuda.device_count() + 1, device="cuda")
    with pytest.raises(ValueError, match="not 'meta'"):
        spawn(print, 1, device="meta")
