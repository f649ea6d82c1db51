"""Gradients through the port's time loop (``tests/test_differentiability.py``),
each held against ``jax.grad`` of the JAX package on the same inputs.

- 8 unrolled steps of ``lid_cavity(n=24, Re=100, jacobi 8)``, checkpointed
  per step (``torch.utils.checkpoint``, non-reentrant, where the JAX
  package uses ``jax.checkpoint``): within 1e-5 of max|g| (measured
  5.1e-7);
- 5 steps against the central finite difference (eps 1e-2, within 5%) and
  against ``jax.grad``;
- 4 steps of the explicit MAC step on a 2×2 gloo mesh (16², rbsor 20
  sweeps, fixed dt, metrics off): against ``jax.grad`` of the JAX package's
  explicit step on a 2×2 mesh of 4 of its 8 virtual CPU devices and against
  the port's single-device gradient, within 1e-5 of max|g|;
- the adjoint example (``cfdsim_tpu_torch/examples/adjoint_forcing.py``) at
  the JAX test's scale (n = 24, 60 steps, 30 iterations, lr 0.15): error
  under 0.2, its first gradient within 1e-5 of max|g| from the JAX example's;
- the captured chunk refuses a state, or a step whose forcing, that
  requires grad before it captures anything, and the two kernel wrappers refuse tensors that require grad
  (the kernels have no backward, as the Pallas kernels have none).

JAX is imported inside the tests: the spawned ranks import this module for
their function and need torch alone.
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from cfdsim_tpu_torch.cases import lid_cavity, lid_cavity_mac
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

GRAD_RTOL = 1e-5  # of max|g|
FD_RTOL = 0.05  # tests/test_differentiability.py:54
ADJOINT_ERR = 0.2  # tests/test_differentiability.py:109
MAC_STEPS = 4


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _port_case():
    return lid_cavity(n=24, Re=100.0, poisson=PoissonConfig(method="jacobi", iters=8),
                      device="cpu")


def _jax_case():
    from cfdsim_tpu.cases import lid_cavity as j_lid_cavity
    from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig

    return j_lid_cavity(n=24, Re=100.0, poisson=JConfig(method="jacobi", iters=8))


def _port_loss(case, u0, steps, remat):
    state = case.state._replace(u=u0)

    def body(s):
        return case.step(s, 1.0)[0]

    for _ in range(steps):
        state = checkpoint(body, state, use_reentrant=False) if remat else body(state)
    return torch.mean(state.u ** 2)


def test_gradient_through_unrolled_steps():
    import jax
    import jax.numpy as jnp

    jcase = _jax_case()

    def loss(u0):
        def body(s, _):
            return jcase.step(s, jnp.float32(1.0))[0], None

        final, _ = jax.lax.scan(jax.checkpoint(body), jcase.state._replace(u=u0), None,
                                length=8)
        return jnp.mean(final.u ** 2)

    want = np.asarray(jax.jit(jax.grad(loss))(jcase.state.u))
    case = _port_case()
    u0 = case.state.u.clone().requires_grad_()
    _port_loss(case, u0, 8, remat=True).backward()
    got = u0.grad.numpy()
    assert np.all(np.isfinite(got))
    assert np.abs(got).max() > 0.0  # the gradient flows
    assert _rel(got, want) <= GRAD_RTOL


def test_gradient_matches_finite_difference():
    import jax
    import jax.numpy as jnp

    jcase = _jax_case()

    def jloss(scale):
        def body(s, _):
            return jcase.step(s, jnp.float32(1.0))[0], None

        final, _ = jax.lax.scan(body, jcase.state._replace(u=jcase.state.u + scale), None,
                                length=5)
        return jnp.mean(final.u ** 2)

    want = float(jax.grad(jloss)(jnp.float32(0.0)))
    case = _port_case()

    def loss(scale):
        return _port_loss(case, case.state.u + scale, 5, remat=False)

    scale = torch.zeros((), requires_grad=True)
    loss(scale).backward()
    g = float(scale.grad)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(loss(torch.tensor(eps))) - float(loss(torch.tensor(-eps)))) / (2 * eps)
    assert abs(g - fd) < FD_RTOL * max(abs(fd), 1e-6), f"grad {g} vs fd {fd}"
    assert abs(g - want) <= GRAD_RTOL * abs(want)


# --- the sharded MAC step on 4 gloo ranks ----------------------------------

def _mac_case():
    return lid_cavity_mac(n=16, Re=100.0, poisson=PoissonConfig(method="rbsor", iters=20),
                          adaptive_dt=False, dt_base=1e-3, compute_metrics=False, device="cpu")


def _sharded_mac_gradient(mesh):
    """Every rank: d mean(u_N²)/d u0 on its trimmed block, gathered."""
    from cfdsim_tpu_torch.parallel import (
        gather_blocks,
        make_cavity_mac_explicit_step,
        shard_trimmed_state,
        trim_state,
    )

    case = _mac_case()
    step = make_cavity_mac_explicit_step(case.cfg, mesh)
    t0 = shard_trimmed_state(trim_state(case.state), mesh)
    u0 = t0.u.clone().requires_grad_()
    s = t0._replace(u=u0)
    for _ in range(MAC_STEPS):
        s, _ = step(s, 1.0)
    # each rank's share of the global mean; the backward's exchanges carry
    # the cotangents across the blocks
    (torch.sum(s.u ** 2) / (16 * 16)).backward()
    return {"grad": gather_blocks(u0.grad, mesh).numpy()}


@pytest.fixture(scope="module")
def sharded_mac_grad():
    from cfdsim_tpu_torch.parallel.launch import spawn

    return spawn(_sharded_mac_gradient, 4, (2, 2), device="cpu")


def test_gradient_through_sharded_mac_step(sharded_mac_grad):
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.cases import lid_cavity_mac as j_lid_cavity_mac
    from cfdsim_tpu.parallel.mac_explicit import make_cavity_mac_explicit_step
    from cfdsim_tpu.parallel.mac_sharded import shard_trimmed_state, trim_state
    from cfdsim_tpu.parallel.mesh import make_grid_mesh
    from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig

    mesh = make_grid_mesh(4, topology=(2, 2))
    jcase = j_lid_cavity_mac(n=16, Re=100.0, poisson=JConfig(method="rbsor", iters=20),
                             adaptive_dt=False, dt_base=1e-3, compute_metrics=False)
    jstep = make_cavity_mac_explicit_step(jcase.cfg, mesh)
    t0 = shard_trimmed_state(trim_state(jcase.state), mesh)

    def loss(u0):
        def body(st, _):
            return jstep(st, jnp.float32(1.0))[0], None

        final, _ = jax.lax.scan(body, t0._replace(u=u0), None, length=MAC_STEPS)
        return jnp.mean(final.u ** 2)

    want = np.asarray(jax.jit(jax.grad(loss))(t0.u))
    got = sharded_mac_grad["grad"]
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0.0
    assert _rel(got, want) <= GRAD_RTOL

    # the port's single-device step on the full faces
    case = _mac_case()
    u0 = case.state.u[:, :-1].clone().requires_grad_()
    s = case.state._replace(u=torch.nn.functional.pad(u0, (0, 1)))
    for _ in range(MAC_STEPS):
        s, _ = case.step(s, 1.0)
    torch.mean(s.u[:, :-1] ** 2).backward()
    assert _rel(got, u0.grad.numpy()) <= GRAD_RTOL


# --- the adjoint example ----------------------------------------------------

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of small ops: a thread team only stalls
    yield
    torch.set_num_threads(n)


def test_adjoint_recovers_forcing_coefficients(one_thread):
    from cfdsim_tpu_torch.examples.adjoint_forcing import main

    err = main(n=24, n_steps=60, iters=30, lr=0.15, verbose=False, device="cpu")
    assert err < ADJOINT_ERR


def test_adjoint_first_gradient_matches_jax(one_thread):
    """The gradient at c = 0 of the example's loss against ``jax.grad`` of the
    JAX example's (its ``simulate`` rebuilt here from the JAX package's MAC
    module: the JAX example keeps it inside ``main``)."""
    import jax
    import jax.numpy as jnp
    from cfdsim_tpu.grid import Grid as JGrid
    from cfdsim_tpu.models import mac as jmac
    from cfdsim_tpu.solvers.poisson import PoissonConfig as JConfig
    from cfdsim_tpu_torch.examples.adjoint_forcing import C_TRUE, make_problem

    n, n_steps = 24, 60
    cfg = jmac.MACConfig(grid=JGrid(nx=n, ny=n, x_max=np.pi, y_max=np.pi, centering="cell"),
                         nu=0.02, adaptive_dt=False, dt_base=2e-3,
                         poisson=JConfig(method="dct"))
    bcs = jmac.free_slip_bcs()
    yu = (np.arange(n) + 0.5) * (np.pi / n)
    modes = jnp.asarray(np.stack([np.sin((k + 1) * yu) for k in range(4)]), jnp.float32)

    def simulate(c):
        fu = jnp.einsum("k,ky->y", c, modes)[:, None] * jnp.ones((n, n + 1), jnp.float32)
        step = jmac.make_step(cfg, bcs, forcing=(fu, jnp.zeros((n + 1, n), jnp.float32)))

        def body(s, _):
            return step(s, jnp.float32(1.0))[0], None

        s_n, _ = jax.lax.scan(jax.checkpoint(body), jmac.init_state(cfg), None, length=n_steps)
        return s_n.u, s_n.v

    u_obs, v_obs = jax.jit(simulate)(jnp.asarray(C_TRUE, jnp.float32))

    def jloss(c):
        u, v = simulate(c)
        return jnp.mean((u - u_obs) ** 2) + jnp.mean((v - v_obs) ** 2)

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.zeros(4, jnp.float32)))
    loss = make_problem(n, n_steps, device="cpu").loss
    c = torch.zeros(4, requires_grad=True)
    loss(c).backward()
    assert _rel(c.grad.numpy(), want) <= GRAD_RTOL


# --- what refuses a gradient ----------------------------------------------

def test_graph_chunk_refuses_a_state_that_requires_grad(monkeypatch):
    from cfdsim_tpu_torch.models.incompressible import Chunk
    from cfdsim_tpu_torch.utils import graphs

    built = []

    class NoCapture:
        def __init__(self, *args, **kwargs):
            built.append(args)

    monkeypatch.setattr(graphs, "CapturedProgram", NoCapture)
    case = lid_cavity(n=8, device="cpu")
    chunk = Chunk(case.step, 4, "cpu", mode="graph", reason="built directly")
    state = case.state._replace(u=case.state.u.clone().requires_grad_())
    with pytest.raises(ValueError, match="loop route"):
        chunk(state, 1.0)
    cfl = torch.ones((), requires_grad=True)
    with pytest.raises(ValueError, match="loop route"):
        chunk(case.state, cfl)
    assert chunk.program is None and built == []


def test_graph_chunk_refuses_a_step_whose_forcing_requires_grad(monkeypatch):
    """The adjoint example's step carries the control in its forcing buffer
    while its state starts from rest."""
    from cfdsim_tpu_torch.examples.adjoint_forcing import make_problem
    from cfdsim_tpu_torch.models import mac
    from cfdsim_tpu_torch.models.incompressible import Chunk
    from cfdsim_tpu_torch.utils import graphs

    built = []

    class NoCapture:
        def __init__(self, *args, **kwargs):
            built.append(args)

    monkeypatch.setattr(graphs, "CapturedProgram", NoCapture)
    step = make_problem(8, 1, device="cpu").step(torch.zeros(4, requires_grad=True))
    assert step.force_u.requires_grad
    chunk = Chunk(step, 4, "cpu", mode="graph", reason="built directly")
    state = mac.init_state(step.cfg, device="cpu")
    assert not any(x.requires_grad for x in state)
    with pytest.raises(ValueError, match="loop route"):
        chunk(state, 1.0)
    assert chunk.program is None and built == []


def test_loop_chunk_differentiates_and_collectives_take_the_loop():
    from cfdsim_tpu_torch.models.incompressible import chunk_route, make_chunk

    case = _port_case()
    chunk = make_chunk(case.cfg, case.step, 3)
    assert chunk.mode == "loop"
    u0 = case.state.u.clone().requires_grad_()
    state, _ = chunk(case.state._replace(u=u0), 1.0)
    torch.mean(state.u ** 2).backward()
    assert float(u0.grad.abs().max()) > 0.0
    mode, reason = chunk_route("cuda", False, collectives=True)
    assert mode == "loop" and "collectives" in reason
    assert chunk_route("cuda", False)[0] == "graph"


def test_predictor_kernel_wrapper_refuses_grad():
    from cfdsim_tpu_torch.ops.kernels.predictor import _check_cuda_args

    u = torch.zeros(8, 8, requires_grad=True)
    v = torch.zeros(8, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        _check_cuda_args(u, v, torch.tensor(1e-3))
    with pytest.raises(RuntimeError, match="no backward"):
        _check_cuda_args(v, u, torch.tensor(1e-3))


def test_rbsor_kernel_wrapper_refuses_grad():
    from cfdsim_tpu_torch.ops.kernels.poisson_rb import _field

    t = torch.zeros(8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _field("phi", t, t.device, (8, 8))
    assert _field("phi", t.detach(), t.device, (8, 8)).shape == (8, 8)
