"""The RB-SOR kernels of the port (``ops/kernels/poisson_rb.py``): their
plain versions against the JAX package's Pallas kernels (interpret mode),
the early exit, the routing, the size plans of kernel A (cluster or
cooperative route) and kernel B (tiles and load route), and on a card the
kernels on each route against the plain versions.

Tolerances:
- kernel A's plain version vs ``rbsor_pallas``: atol 1e-6, the band of
  tests/test_pallas.py:28. Both run the same float32 operations in the same
  order; XLA may contract a pair into one FMA (observed ≤ 6e-9).
- kernel B's plain version vs ``rbsor_pallas_blocked``: atol 5e-6, the band
  of tests/test_pallas.py:69-70 (the plain version runs the global sweeps
  the blocked passes are defined to equal; observed ≤ 1.4e-6).
- the early exit at 48²: the same number of chunks, and φ within
  EARLY_EXIT_RTOL·max|φ|. Under jit, XLA's CPU backend contracts a·b + c
  into one FMA (about a quarter of float32 a·b + c results differ from the
  twice-rounded form), while the port rounds every operation; over the 500
  sweeps of this solve those last-bit differences grow to ~1e-5 relative
  (observed 1.0e-5), where 30 sweeps stay at ~4e-7.
- on the card: kernels and plain versions spell out every rounding, so they
  are held to atol 1e-6 and reported bit for bit by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.ops.pallas.poisson_rb import rbsor_pallas, rbsor_pallas_blocked
from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig
from cfdsim_tpu.solvers.poisson import poisson_residual as j_residual
from cfdsim_tpu.solvers.poisson import solve_poisson as j_solve
from cfdsim_tpu_torch.ops.kernels import poisson_rb as rb
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, solve_poisson

ATOL_A = 1e-6
ATOL_B = 5e-6
EARLY_EXIT_RTOL = 2e-5
BLOCKED_CASES = [(64, 48, 16, 3, 10), (72, 32, 32, 8, 9)]  # tests/test_pallas.py:61


def _problem(shape=(32, 48), seed=0):
    """The problem of tests/test_pallas.py:12-17, plus a solid block."""
    rhs = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    rhs -= rhs.mean()
    solid = np.zeros(shape, dtype=bool)
    solid[10:14, 20:24] = True
    return np.zeros_like(rhs), rhs, 1.0 / 32, solid


@pytest.mark.parametrize("bc, masked", [("neumann", False), ("dirichlet", False),
                                        ("neumann", True), ("dirichlet", True)])
def test_plain_rbsor_matches_pallas(bc, masked):
    phi0, rhs, h, solid = _problem()
    mask = solid if masked else None
    want = rbsor_pallas(jnp.asarray(phi0), jnp.asarray(rhs), h, h, iters=30, omega=1.7, bc=bc,
                        solid_mask=None if mask is None else jnp.asarray(mask), interpret=True)
    got = rb.rbsor_ref(torch.from_numpy(phi0), torch.from_numpy(rhs), h, h, iters=30,
                       omega=1.7, bc=bc, solid_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_A)
    if masked:
        assert np.all(got.numpy()[solid] == 0.0)


@pytest.mark.parametrize("ny, nx, rows, k, iters", BLOCKED_CASES)
def test_plain_blocked_matches_pallas(ny, nx, rows, k, iters):
    rng = np.random.RandomState(7)
    rhs = rng.randn(ny, nx).astype(np.float32)
    phi0 = rng.randn(ny, nx).astype(np.float32)
    want = rbsor_pallas_blocked(jnp.asarray(phi0), jnp.asarray(rhs), 0.02, 0.03, iters=iters,
                                omega=1.7, rows_per_block=rows, sweeps_per_pass=k,
                                interpret=True)
    got = rb.rbsor_blocked_ref(torch.from_numpy(phi0), torch.from_numpy(rhs), 0.02, 0.03,
                               iters=iters, omega=1.7, rows_per_block=rows, sweeps_per_pass=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL_B)


def _jax_chunks(rhs, h, cfg):
    """The JAX package's early exit, chunk by chunk: (φ, chunks run)."""
    p = jnp.zeros(rhs.shape, jnp.float32)
    for n in range(1, max(1, cfg.iters // cfg.check_every) + 1):
        p = rbsor_pallas(p, jnp.asarray(rhs), h, h, iters=cfg.check_every, omega=cfg.omega,
                         interpret=True)
        if not float(j_residual(p, jnp.asarray(rhs), h, h)) > cfg.tol:
            break
    return p, n


def test_rbsor_pallas_early_exit_matches_jax():
    n = 48
    rhs = np.random.RandomState(1).randn(n, n).astype(np.float32)
    rhs -= rhs.mean()
    kw = dict(method="rbsor_pallas", iters=4000, tol=1e-3, check_every=50, omega=1.7)
    want = np.asarray(j_solve(jnp.zeros((n, n), jnp.float32), jnp.asarray(rhs), 1.0 / n,
                              1.0 / n, JConfig(**kw)))
    _, jax_chunks = _jax_chunks(rhs, 1.0 / n, JConfig(**kw))
    chunks = torch.zeros((), dtype=torch.int32)
    got = rb.rbsor(torch.zeros(n, n), torch.from_numpy(rhs), 1.0 / n, 1.0 / n, iters=4000,
                   omega=1.7, tol=1e-3, check_every=50, chunks_run=chunks)
    assert np.abs(got.numpy() - want).max() <= EARLY_EXIT_RTOL * np.abs(want).max()
    assert int(chunks) == jax_chunks < 4000 // 50
    # and through the solver, which counts its chunks in a buffer
    got2 = solve_poisson(torch.zeros(n, n), torch.from_numpy(rhs), 1.0 / n, 1.0 / n,
                         PoissonConfig(**kw))
    assert torch.equal(got2, got)


def test_early_exit_without_convergence_runs_every_chunk():
    phi0, rhs, h, _ = _problem()
    chunks = torch.zeros((), dtype=torch.int32)
    got = rb.rbsor(torch.from_numpy(phi0), torch.from_numpy(rhs), h, h, iters=30, omega=1.7,
                   tol=1e-30, check_every=8, chunks_run=chunks)
    assert int(chunks) == 30 // 8
    want = rb.rbsor_ref(torch.from_numpy(phi0), torch.from_numpy(rhs), h, h, iters=24)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bc, masked, blocked", [
    ("neumann", False, True), ("neumann", True, False), ("dirichlet", False, False),
], ids=["neumann-unmasked", "neumann-masked", "dirichlet"])
def test_routing_above_max_elems(monkeypatch, bc, masked, blocked):
    calls = []
    monkeypatch.setattr(rb, "MAX_ELEMS", 16)
    monkeypatch.setattr(rb, "rbsor_blocked", lambda *a, **k: calls.append("B") or a[0])
    monkeypatch.setattr(rb, "rbsor", lambda *a, **k: calls.append("A") or a[0])
    phi = torch.zeros(5, 5)  # 25 cells > MAX_ELEMS
    rb.rbsor_routed(phi, phi, 0.1, 0.1, iters=2, bc=bc,
                    solid_mask=torch.zeros(5, 5, dtype=torch.bool) if masked else None)
    rb.rbsor_routed(torch.zeros(4, 4), torch.zeros(4, 4), 0.1, 0.1, iters=2, bc=bc)
    assert calls == ["B" if blocked else "A", "A"]


def test_cpu_tensors_take_the_plain_versions():
    phi0, rhs, h, solid = _problem()
    tp, tr, ts = (torch.from_numpy(a) for a in (phi0, rhs, solid))
    for k in rb.KERNELS:
        k.reset_launches()
    assert torch.equal(rb.rbsor(tp, tr, h, h, 10, 1.7, "neumann", ts),
                       rb.rbsor_ref(tp, tr, h, h, 10, 1.7, "neumann", ts))
    assert torch.equal(rb.rbsor_blocked(tp, tr, h, h, 10, 1.7, 16, 3),
                       rb.rbsor_blocked_ref(tp, tr, h, h, 10, 1.7, 16, 3))
    assert all(k.launches == 0 for k in rb.KERNELS)


def test_non_cpu_non_cuda_tensors_raise():
    t = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rb.rbsor(t, t, 0.1, 0.1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rb.rbsor_blocked(t, t, 0.1, 0.1)


def test_plain_versions_equal_the_streaming_solver():
    """Kernel A's sweep order differs from the streaming solver's neighbour
    sum only in association, so both converge to the same answer."""
    phi0, rhs, h, _ = _problem()
    stream = solve_poisson(torch.from_numpy(phi0), torch.from_numpy(rhs), h, h,
                           PoissonConfig(method="rbsor", iters=30))
    kernel = solve_poisson(torch.from_numpy(phi0), torch.from_numpy(rhs), h, h,
                           PoissonConfig(method="rbsor_pallas", iters=30))
    np.testing.assert_allclose(kernel.numpy(), stream.numpy(), rtol=0, atol=ATOL_A)


# kernel A's plan on a card that schedules clusters of 16 (the H100), the
# tiled route not considered (no SM count): (shape, max cluster, sweeps or
# None for the size alone) -> (route, cluster size). Bands above LARGE_BAND
# cells take the cluster only for a solve of at least CLUSTER_MIN_SWEEPS sweeps
PLAN_CASES = [
    ((32, 48), 16, None, "cluster", 1),  # the test_pallas problem: one CTA
    ((37, 129), 16, None, "cluster", 2),
    ((128, 256), 16, None, "cluster", 8),
    ((180, 600), 16, None, "cluster", 16),  # the ref-parity cylinder
    ((512, 512), 16, None, "cluster", 16),  # the largest multigrid level of mg:2 at 1024²
    ((512, 512), 8, None, "cooperative", 0),  # ... needs 16
    ((360, 1200), 16, None, "cooperative", 0),  # the cylinder at twice its resolution
    ((768, 768), 16, None, "cooperative", 0),
    ((4, 4), 16, None, "cluster", 1),  # the coarsest multigrid level
    ((3, 4000), 16, None, "cooperative", 0),  # a row wider than 1024 column pairs
    ((512, 512), 16, 2, "cooperative", 0),  # the multigrid's 512² smoothing call
    ((512, 512), 16, 31, "cooperative", 0),
    ((512, 512), 16, 32, "cluster", 16),
    ((180, 600), 16, 2, "cluster", 16),  # 7,200 cells per band
    ((180, 600), 16, 1500, "cluster", 16),  # ... without the SM count (no tiled route)
    ((256, 256), 16, 2, "cluster", 16),  # the multigrid's 256² level
    ((360, 1200), 16, 1500, "cooperative", 0),  # over capacity at any sweeps
]


@pytest.mark.parametrize(
    "shape, most, sweeps, route, cluster", PLAN_CASES,
    ids=[f"{s[0]}x{s[1]}-max{m}" + (f"-{n}sweeps" if n else "") for s, m, n, _, _ in PLAN_CASES])
def test_plan_rbsor_routes_by_size(shape, most, sweeps, route, cluster):
    plan = rb.plan_rbsor(shape, most, sweeps=sweeps)
    assert (plan.route, plan.cluster) == (route, cluster)
    if route == "cooperative":
        assert plan == rb.RbsorPlan("cooperative")
        return
    assert plan == rb.plan_rbsor(shape, most)  # the sweeps choose the route, not the cluster
    ny, nx = shape
    pairs_per_row = -(-((nx + 1) // 2) // 32) * 32  # column pairs rounded up to a warp
    assert plan.rows_per_cta == -(-ny // cluster)
    assert plan.rows_per_thread in rb.ROWS_PER_THREAD
    assert plan.threads % pairs_per_row == 0 and plan.threads <= rb.CLUSTER_THREADS
    assert plan.threads // pairs_per_row * plan.rows_per_thread >= plan.rows_per_cta
    assert plan.smem_bytes <= rb.SMEM_LIMIT


# the tiled route on a card of 132 SMs (the H100): (shape, sweeps) -> route.
# Long solves on large grids spread over the card, early exits checked
# every sweep included; the multigrid's 2-sweep levels, short solves and
# small grids keep the cluster or cooperative route
TILED_PLAN_CASES = [
    ((180, 600), 1500, "tiled"),  # the ref-parity cylinder's solve
    ((240, 720), 1500, "tiled"),  # cylinder_mac's pressure grid
    ((360, 1200), 1500, "tiled"),  # the cylinder at twice its resolution: above the cluster
    ((180, 600), 50, "tiled"),  # one 50-sweep chunk
    ((512, 512), 2, "cooperative"),  # the multigrid's 512² smoothing call
    ((256, 256), 2, "cluster"),  # ... and its 256² level
    ((8, 8), 2, "cluster"),  # ... and its 8² level
    ((180, 600), 2, "cluster"),  # a short solve
    ((180, 600), rb.TILED_MIN_SWEEPS - 1, "cluster"),
    ((48, 48), 4000, "cluster"),  # a small grid, however long the solve
]


@pytest.mark.parametrize(
    "shape, sweeps, route", TILED_PLAN_CASES,
    ids=[f"{s[0]}x{s[1]}-{n}sweeps" for s, n, _ in TILED_PLAN_CASES])
def test_plan_rbsor_takes_the_tiled_route_for_long_solves(shape, sweeps, route):
    plan = rb.plan_rbsor(shape, 16, sweeps=sweeps, sms=132)
    assert plan.route == route
    if route != "tiled":
        assert plan == rb.plan_rbsor(shape, 16, sweeps=sweeps)  # as without the SM count
        return
    ny, nx = shape
    k = plan.sweeps_per_pass
    assert plan == rb.tile_plan(shape, 132)
    assert plan.tile_cols + 4 * k == rb.TILE_WIDTH and plan.tile_cols % 2 == 0
    tiles_x, tiles_y = -(-nx // plan.tile_cols), -(-ny // plan.rows_per_cta)
    assert plan.tiles == tiles_x * tiles_y <= 132
    # each tile's 2K halo reaches only the 8 tiles around it
    assert plan.rows_per_cta >= 2 * k and plan.tile_cols >= 2 * k
    staged = plan.rows_per_cta + 4 * k
    assert plan.rows_per_thread in rb.TILE_ROWS_PER_THREAD
    assert plan.threads == rb.TILE_WIDTH // 2 * -(-staged // plan.rows_per_thread) <= 1024
    assert plan.smem_bytes == 4 * ((staged + 2) * rb.TILE_WIDTH + 32) <= rb.SMEM_LIMIT


def test_tile_plan_refuses_grids_beyond_the_card():
    assert rb.tile_plan((180, 600), 10) is None  # 14 columns of tiles on 10 SMs
    assert rb.tile_plan((1024, 1024), 132) is None  # 171-row tiles: over 1024 threads
    assert rb.plan_rbsor((1024, 1024), 16, sweeps=1500, sms=132).route == "cooperative"


def test_plan_rbsor_needs_the_shared_memory_it_names():
    plan = rb.plan_rbsor((180, 600), 16)
    assert rb.plan_rbsor((180, 600), 16, smem_limit=plan.smem_bytes) == plan
    # a cluster of 16 is the largest: with less shared memory the grid
    # goes to the cooperative kernel
    assert rb.plan_rbsor((180, 600), 16, smem_limit=plan.smem_bytes - 1).route == "cooperative"


@pytest.mark.parametrize("shape, sweeps, rows, want", [
    ((1024, 1024), 2, None, ("tma", 32)),
    ((1024, 1024), 8, None, ("tma", 64)),
    ((1000, 1030), 2, None, ("cp_async", 32)),
    ((65, 33), 2, None, ("cp_async", 32)),
    ((64, 48), 3, 16, ("tma", 16)),
    ((72, 32), 8, 32, ("tma", 32)),
])
def test_plan_blocked_picks_the_load_route_by_pitch(shape, sweeps, rows, want):
    plan = rb.plan_blocked(shape, sweeps, rows)
    assert (plan.route, plan.tile_rows) == want
    halo_cols = -(-2 * sweeps // 4) * 4  # 2K rounded up to 16 bytes
    staged = (plan.tile_rows + 4 * sweeps) * (plan.tile_cols + 2 * halo_cols)
    # φ and rhs, each rounded up to 128 bytes, and one mbarrier
    assert plan.smem_bytes == 2 * (-(-staged // 32) * 32) * 4 + 8
    assert plan.smem_bytes <= rb.SMEM_LIMIT
    assert (plan.tile_cols + 2 * halo_cols) % 4 == 0  # a TMA box row is whole 16-byte words


@pytest.mark.parametrize("sweeps, rows", [(40, None), (2, 300)])
def test_plan_blocked_refuses_tiles_beyond_a_tma_box(sweeps, rows):
    with pytest.raises(ValueError, match="per dimension"):
        rb.plan_blocked((1024, 1024), sweeps, rows)


def _cuda(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


def _cylinder_solid(shape):
    from cfdsim_tpu_torch.grid import Grid
    from cfdsim_tpu_torch.ibm import cylinder_masks

    solid, _ = cylinder_masks(Grid(nx=shape[1], ny=shape[0], x_max=20.0, y_max=4.0), (4.0, 2.0),
                              0.5)
    return solid


ROUTE_KERNELS = {"cluster": rb.KERNEL_A, "cooperative": rb.KERNEL_A_COOP,
                 "tiled": rb.KERNEL_A_TILED}


def _forced_plan(shape, route):
    """Kernel A's plan on the card for ``route``, whatever the sweeps: the
    cluster the size alone gives."""
    if route == "cooperative":
        return rb.RbsorPlan("cooperative")
    if route == "tiled":
        return rb.tile_plan(shape, rb.card_sms("cuda"))
    return rb.plan_rbsor(shape, rb.max_cluster("cuda"))


def _early_exit_on_card(shape, route, tol, check):
    """The cylinder's masked problem (h = 1/ny) solved for up to 4000
    sweeps to ``tol``, checked every ``check`` sweeps, on ``route`` and by
    the plain twin: (kernel φ, plain φ, chunks each, the route's launches)."""
    rhs = np.random.RandomState(1).randn(*shape).astype(np.float32)
    rhs = _cuda(rhs - rhs.mean())
    h = 1.0 / shape[0]
    mask = _cuda(_cylinder_solid(shape))
    counts = [torch.zeros((), dtype=torch.int32, device="cuda") for _ in range(2)]
    kernel = ROUTE_KERNELS[route]
    before = kernel.launches
    got = torch.zeros(shape, device="cuda")
    rb.solve_a(got, rhs, mask.float(), _forced_plan(shape, route), h, h, 4000, 1.7, "neumann",
               tol, check, counts[0])
    want = rb.rbsor_ref(torch.zeros(shape, device="cuda"), rhs, h, h, 4000, 1.7, "neumann", mask,
                        tol=tol, check_every=check, chunks_run=counts[1])
    torch.cuda.synchronize()
    return got, want, [int(c) for c in counts], kernel.launches - before


def _three_chunk_tol(shape, check):
    """The residual the plain twin has after 3 chunks of ``check`` sweeps on
    the cylinder's masked problem."""
    rhs = np.random.RandomState(1).randn(*shape).astype(np.float32)
    rhs = _cuda(rhs - rhs.mean())
    h = 1.0 / shape[0]
    mask = _cuda(_cylinder_solid(shape))
    three = rb.rbsor_ref(torch.zeros(shape, device="cuda"), rhs, h, h, 3 * check, 1.7, "neumann",
                         mask)
    return float(rb.poisson_residual(three, rhs, h, h, mask, "neumann"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, route", [
    ((128, 256), "cluster"), ((180, 600), "cluster"), ((360, 1200), "cooperative"),
    ((37, 129), "cluster"), ((512, 512), "cluster"),
    ((180, 600), "tiled"), ((240, 720), "tiled"), ((360, 1200), "tiled"),
], ids=["cluster8", "cluster16", "cooperative", "cluster2", "cluster16-8rows", "tiled-180x600",
        "tiled-240x720", "tiled-360x1200"])
def test_kernel_a_routes_match_plain_on_card(shape, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    phi0, rhs, h, _ = _problem(shape)
    mask = _cuda(_cylinder_solid(shape))
    plan = _forced_plan(shape, route)
    kernel = ROUTE_KERNELS[route]
    before = kernel.launches
    got = _cuda(phi0)
    rb.solve_a(got, _cuda(rhs), mask.float(), plan, h, h, 30, 1.7)
    want = rb.rbsor_ref(_cuda(phi0), _cuda(rhs), h, h, 30, 1.7, "neumann", mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ny, nx", [(1000, 1030), (65, 33), (64, 48)],
                         ids=["cp_async-even", "cp_async-odd", "tma"])
def test_kernel_b_load_routes_match_plain_on_card(ny, nx):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(7)
    rhs, phi0 = _cuda(rng.randn(ny, nx).astype(np.float32)), _cuda(rng.randn(ny, nx).astype(np.float32))
    got = rb.rbsor_blocked(phi0, rhs, 0.02, 0.03, 5, 1.7, None, 2)
    plain = rb.rbsor_blocked_ref(phi0, rhs, 0.02, 0.03, 5, 1.7, None, 2)
    torch.cuda.synchronize()
    assert float((got - plain).abs().max()) <= ATOL_B


@pytest.mark.cuda
def test_cluster_early_exit_is_one_launch_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n = 48
    rhs = np.random.RandomState(1).randn(n, n).astype(np.float32)
    rhs -= rhs.mean()
    counts = [torch.zeros((), dtype=torch.int32, device="cuda") for _ in range(2)]
    before = rb.KERNEL_A.launches
    got = rb.rbsor(torch.zeros(n, n, device="cuda"), _cuda(rhs), 1.0 / n, 1.0 / n, 4000, 1.7,
                   tol=1e-3, check_every=50, chunks_run=counts[0])
    want = rb.rbsor_ref(torch.zeros(n, n, device="cuda"), _cuda(rhs), 1.0 / n, 1.0 / n, 4000,
                        1.7, tol=1e-3, check_every=50, chunks_run=counts[1])
    torch.cuda.synchronize()
    assert rb.KERNEL_A.launches == before + 1
    assert int(counts[0]) == int(counts[1]) < 80
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["cluster", "tiled"])
def test_cluster_early_exit_checked_every_sweep_on_card(route):
    """A residual check after every sweep. On a cluster of 16 a CTA may
    finish the next chunk before a distant CTA has read this chunk's
    residual, so the chunks' residual slots alternate; on the tiled route
    every chunk is one 1-sweep pass, an exchange, a reduction and a grid
    sync, and the slots rotate by chunk % 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape = (180, 600)
    if route == "cluster":
        assert _forced_plan(shape, route).cluster == 16
    got, want, chunks, launches = _early_exit_on_card(shape, route, _three_chunk_tol(shape, 1), 1)
    assert launches == 1
    assert chunks[0] == chunks[1] < 4000
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, route", [
    ((180, 600), "cluster"), ((180, 600), "tiled"), ((360, 1200), "cooperative"),
    ((360, 1200), "tiled"), ((240, 720), "tiled"),
])
def test_early_exit_after_three_chunks_on_card(shape, route):
    """The cylinder's masked problem checked every 50 sweeps, to the
    residual the plain twin has after 3 chunks, on each route of kernel A:
    the same chunks and the same bits. The cluster and tiled routes run the
    whole solve in one launch; the cooperative route launches every chunk
    (those after the exit return at once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    got, want, chunks, launches = _early_exit_on_card(shape, route, _three_chunk_tol(shape, 50),
                                                      50)
    assert launches == (4000 // 50 if route == "cooperative" else 1)
    assert chunks[0] == chunks[1] < 4000 // 50
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 48), (37, 129)])
@pytest.mark.parametrize("bc, masked", [("neumann", False), ("dirichlet", False),
                                        ("neumann", True)])
def test_kernel_a_matches_plain_on_card(shape, bc, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    phi0, rhs, h, solid = _problem(shape)
    mask = _cuda(solid) if masked else None
    # one launch on the route the plan takes: a cluster at (32, 48), the
    # tiled route at (37, 129) (its cluster of 2 is held to the twin by
    # test_kernel_a_routes_match_plain_on_card)
    plan = rb.plan_rbsor(shape, rb.max_cluster("cuda"), sweeps=30, sms=rb.card_sms("cuda"))
    kernel = ROUTE_KERNELS[plan.route]
    before = kernel.launches
    got = rb.rbsor(_cuda(phi0), _cuda(rhs), h, h, 30, 1.7, bc, mask)
    want = rb.rbsor_ref(_cuda(phi0), _cuda(rhs), h, h, 30, 1.7, bc, mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert float((got - want).abs().max()) <= ATOL_A


@pytest.mark.cuda
@pytest.mark.parametrize("ny, nx, rows, k, iters", BLOCKED_CASES)
def test_kernel_b_matches_a_and_plain_on_card(ny, nx, rows, k, iters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(7)
    rhs, phi0 = _cuda(rng.randn(ny, nx).astype(np.float32)), _cuda(rng.randn(ny, nx).astype(np.float32))
    got = rb.rbsor_blocked(phi0, rhs, 0.02, 0.03, iters, 1.7, rows, k)
    a = rb.rbsor(phi0, rhs, 0.02, 0.03, iters, 1.7)
    plain = rb.rbsor_blocked_ref(phi0, rhs, 0.02, 0.03, iters, 1.7, rows, k)
    torch.cuda.synchronize()
    assert float((got - a).abs().max()) <= ATOL_B
    assert float((got - plain).abs().max()) <= ATOL_B


@pytest.mark.cuda
def test_kernel_early_exit_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n = 48
    rhs = np.random.RandomState(1).randn(n, n).astype(np.float32)
    rhs -= rhs.mean()
    counts = [torch.zeros((), dtype=torch.int32, device="cuda") for _ in range(2)]
    outs = [fn(torch.zeros(n, n, device="cuda"), _cuda(rhs), 1.0 / n, 1.0 / n, 4000, 1.7,
               tol=1e-3, check_every=50, chunks_run=c)
            for fn, c in zip((rb.rbsor, rb.rbsor_ref), counts)]
    torch.cuda.synchronize()
    assert int(counts[0]) == int(counts[1]) < 80
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-6 * float(outs[1].abs().max())


def _stitched_window_sweeps(phi, rhs, split, k, iters, h):
    """``iters`` sweeps of the whole grid done as the distributed solve does
    them (``parallel/poisson2d_explicit.py``): each block of a (py, px)
    split padded by 2K lines on the sides that face another block, K plain
    blocked sweeps on that window with its origin's colour parity, the
    block cropped and the blocks stitched back, pass after pass."""
    ny, nx = phi.shape
    py, px = split
    by, bx = ny // py, nx // px
    for done in range(0, iters, k):
        sweeps = min(k, iters - done)
        out = torch.empty_like(phi)
        for iy in range(py):
            for ix in range(px):
                y0 = iy * by - (2 * k if iy > 0 else 0)
                x0 = ix * bx - (2 * k if ix > 0 else 0)
                y1 = (iy + 1) * by + (2 * k if iy < py - 1 else 0)
                x1 = (ix + 1) * bx + (2 * k if ix < px - 1 else 0)
                got = rb.rbsor_blocked(phi[y0:y1, x0:x1].contiguous(),
                                       rhs[y0:y1, x0:x1].contiguous(), h, h, iters=sweeps,
                                       omega=1.7, sweeps_per_pass=sweeps,
                                       parity0=(y0 + x0) & 1)
                oy, ox = iy * by - y0, ix * bx - x0
                out[iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx] = got[oy:oy + by, ox:ox + bx]
        phi = out
    return phi


@pytest.mark.parametrize("shape, split, k, iters", [
    ((42, 38), (2, 2), 2, 6),  # blocks 21×19: odd window origins, parity0 = 1
    ((42, 38), (2, 2), 3, 7),  # a remainder pass
    ((48, 36), (3, 2), 4, 8),  # 16×18 blocks, K = 4 (2K = 8 of 16)
    ((30, 44), (1, 4), 5, 10),  # 11-column blocks, 2K = 10
])
def test_windowed_plain_sweeps_stitch_to_global_sweeps(shape, split, k, iters):
    """The windows of a split, swept with the plain twin and the window's
    parity0, stitch back to ``rbsor_ref`` on the whole grid bit for bit."""
    rng = np.random.default_rng(11)
    phi0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    want = rb.rbsor_ref(phi0, rhs, 0.05, 0.05, iters=iters, omega=1.7)
    got = _stitched_window_sweeps(phi0, rhs, split, k, iters, 0.05)
    assert torch.equal(got, want)


def test_parity_offset_swaps_the_colours():
    """parity0 = 1 makes the array's (0, 0) cell black: the colours of an
    array shifted by one column."""
    red0, black0 = rb._colours((6, 9), "neumann", None, "cpu")
    red1, black1 = rb._colours((6, 9), "neumann", None, "cpu", parity0=1)
    assert torch.equal(red1, black0) and torch.equal(black1, red0)
    t = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="parity0"):
        rb.rbsor_blocked(t, t, 0.1, 0.1, 2, parity0=2)


def _span_distance(idx, lo, hi):
    """Each index's distance from the span [lo, hi) (``span_distance`` in
    ``csrc/rbsor.cu``)."""
    return torch.where(idx < lo, lo - idx, torch.where(idx >= hi, idx - hi + 1, 0))


def _tiled_schedule(phi, rhs, h, plan, iters, bc="neumann", mask=None, tol=0.0,
                    check_every=8, omega=1.7):
    """The tiled route's schedule (``csrc/rbsor.cu::tiled::rbsor_kernel``)
    in plain torch. Each tile keeps its own window: its owned cells and 2K
    more a side, clipped at the domain. A pass of k sweeps runs 2k
    half-sweeps on every window, half-sweep t updating only the window's
    live cells (not frozen, and not on a rim the domain does not clamp) in
    the rows within 2k − 1 − t of the owned ones. The exchange gathers the
    owned cells and refreshes each window's cells within 2K of its tile;
    the rest of a window is never refreshed. A chunk's last pass takes what
    is left; after each chunk but the last, an exchange and the early exit
    on the residual of the owned cells. Returns (φ, chunks run)."""
    ny, nx = phi.shape
    k, halo = plan.sweeps_per_pass, 2 * plan.sweeps_per_pass
    tr, tc = plan.rows_per_cta, plan.tile_cols
    ax, ay, denom_inv = rb._coeffs(h, h)
    check = max(1, check_every)
    sweeps, chunks = (check, max(1, iters // check)) if tol > 0.0 else (iters, 1)
    gi, gj = torch.arange(ny)[:, None], torch.arange(nx)[None, :]
    red = (gi + gj) % 2 == 0
    frozen = torch.zeros((ny, nx), dtype=torch.bool) if mask is None else mask.clone()
    if bc == "dirichlet":
        frozen |= (gi == 0) | (gi == ny - 1) | (gj == 0) | (gj == nx - 1)
    tiles = []
    for oi0 in range(0, ny, tr):
        for oj0 in range(0, nx, tc):
            y0, x0 = max(oi0 - halo, 0), max(oj0 - halo, 0)
            y1, x1 = min(y0 + tr + 2 * halo, ny), min(x0 + tc + 2 * halo, nx)
            rows, cols = torch.arange(y0, y1)[:, None], torch.arange(x0, x1)[None, :]
            di = _span_distance(rows, oi0, min(oi0 + tr, ny))
            dj = _span_distance(cols, oj0, min(oj0 + tc, nx))
            whole = (((rows > y0) | (rows == 0)) & ((rows < y1 - 1) | (rows == ny - 1))
                     & ((cols > x0) | (cols == 0)) & ((cols < x1 - 1) | (cols == nx - 1)))
            live = whole & ~frozen[y0:y1, x0:x1]
            own = (di == 0) & (dj == 0)
            tiles.append(dict(at=(slice(y0, y1), slice(x0, x1)), win=phi[y0:y1, x0:x1].clone(),
                              rhs=rhs[y0:y1, x0:x1], di=di.clamp(max=15), own=own,
                              get=~own & (di <= halo) & (dj <= halo),
                              colours=(red[y0:y1, x0:x1] & live, ~red[y0:y1, x0:x1] & live)))
    assert len(tiles) == plan.tiles
    phi = phi.clone()

    def gather():
        for t in tiles:
            phi[t["at"]] = torch.where(t["own"], t["win"], phi[t["at"]])

    def exchange():
        gather()
        for t in tiles:
            t["win"] = torch.where(t["get"], phi[t["at"]], t["win"])

    fresh = True
    for chunk in range(chunks):
        swept = 0
        while swept < sweeps:
            kp = min(k, sweeps - swept)
            if not fresh:
                exchange()
            fresh = False
            for t in tiles:
                w = t["win"]
                for hs in range(2 * kp):
                    on = t["colours"][hs & 1] & (t["di"] <= 2 * kp - 1 - hs)
                    star = (rb._nbsum(w, ax, ay) - t["rhs"]) * denom_inv
                    w = torch.where(on, (1.0 - omega) * w + omega * star, w)
                t["win"] = w
            swept += kp
        if chunk + 1 == chunks:
            break
        exchange()
        fresh = True
        if not bool(rb.poisson_residual(phi, rhs, h, h, mask, bc) > tol):
            return phi, chunk + 1
    gather()
    return phi, chunks


@pytest.mark.parametrize("shape, sms, k, bc, masked, iters, check", [
    ((40, 130), 12, 2, "neumann", True, 12, 0),  # 4 × 3 tiles, the last column 18 wide
    ((40, 130), 12, 2, "dirichlet", False, 12, 0),
    ((37, 131), 9, 3, "neumann", True, 11, 0),  # ragged tiles, odd origins, a 2-sweep tail
    ((37, 131), 9, 3, "dirichlet", True, 11, 0),
    ((40, 130), 12, 2, "neumann", True, 400, 5),  # early exit, chunks of 2 + 2 + 1 sweeps
    ((37, 131), 9, 3, "dirichlet", False, 400, 4),
], ids=["neumann-masked", "dirichlet", "ragged-tail", "ragged-dirichlet-masked",
        "early-exit", "early-exit-dirichlet"])
def test_tiled_schedule_equals_global_sweeps(shape, sms, k, bc, masked, iters, check):
    """The tiled route's passes with their 2K halos, row-limited
    half-sweeps and exchanged rims, in plain torch on the plan's own tiles,
    give ``rbsor_ref``'s bits; with an
    early exit (a tol the plain solve reaches after 3 chunks) the same
    chunks run."""
    rng = np.random.default_rng(5)
    phi0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    rhs = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    mask = None
    if masked:
        mask = torch.zeros(shape, dtype=torch.bool)
        mask[10:17, 50:61] = True  # across a tile boundary
    plan = rb.tile_plan(shape, sms, sweeps_per_pass=k)
    assert plan.tiles > 4
    tol = 0.0
    if check:
        three = rb.rbsor_ref(phi0, rhs, 0.05, 0.05, 3 * check, 1.7, bc, mask)
        tol = float(rb.poisson_residual(three, rhs, 0.05, 0.05, mask, bc))
    count = torch.zeros((), dtype=torch.int32)
    want = rb.rbsor_ref(phi0, rhs, 0.05, 0.05, iters, 1.7, bc, mask, tol, check or 8, count)
    got, chunks = _tiled_schedule(phi0, rhs, 0.05, plan, iters, bc, mask, tol, check or 8)
    assert torch.equal(got, want)
    assert chunks == (int(count) if check else 1) == (3 if check else 1)
