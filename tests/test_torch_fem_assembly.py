"""The FEM assembly (``fem/assembly.py``) and the two-level pressure
preconditioner (``fem/multilevel.py``) of the port against the JAX package
on the same seeded inputs, on P1-P1 and Taylor-Hood P2-P1.

Tolerances: every ``apply_*``, diagonal and lumped mass within 1e-6 of the
output's max|y| (float32 einsums contracted in another order, and the
port's fixed-order scatter against ``segment_sum``); the coarse operator's
inverse within 1e-5 of its max (float64 on the host, cast to float32; its
input tables agree to float32 rounding); the aggregation equal. The
scatter gives the same bits on two runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdsim_tpu.fem.assembly as JA
import cfdsim_tpu.fem.multilevel as JM
import cfdsim_tpu.models.fem as JF
import cfdsim_tpu_torch.fem.assembly as TA
import cfdsim_tpu_torch.fem.multilevel as TM
import cfdsim_tpu_torch.models.fem as TF
from cfdsim_tpu.fem.mesh import cylinder_mesh as j_cylinder_mesh
from cfdsim_tpu.fem.spaces import build_spaces as j_build_spaces
from cfdsim_tpu_torch.fem.mesh import cylinder_mesh
from cfdsim_tpu_torch.fem.spaces import build_spaces

RTOL = 1e-6
KC_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """An FEM solve is thousands of small ops. Where the test workers share
    the cores, each op's OpenMP team waits on descheduled threads (measured
    ~8 ms an op at full load against ~10 µs alone), so this module's torch
    runs on one thread; the setting is put back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["p1p1", "p2p1"])
def pair(request):
    """(JAX ops, port ops, seeded inputs as numpy) on a 582-triangle cylinder mesh."""
    kw = dict(h_far=0.5, h_near=0.12)
    jo = JA.build_element_ops(j_build_spaces(j_cylinder_mesh(**kw), request.param))
    to = TA.build_element_ops(build_spaces(cylinder_mesh(**kw), request.param), device="cpu")
    rng = np.random.default_rng(11)
    nt, nq = to.wq.shape
    data = dict(u=rng.standard_normal((to.n_u, 2)), p=rng.standard_normal(to.n_p),
                a=rng.standard_normal((to.n_u, 2)), tau=0.01 + 0.1 * rng.random(nt),
                fq=rng.standard_normal((nt, nq, 2)))
    return jo, to, {k: v.astype(np.float32) for k, v in data.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


# name → f(assembly module, ops, inputs): the same call in both packages
OPERATORS = {
    "ns_transient": lambda A, o, x: A.apply_ns(o, x["u"], x["p"], 0.01, 20.0, x["a"], x["tau"]),
    "ns_stokes": lambda A, o, x: A.apply_ns(o, x["u"], x["p"], 0.1, None, None, None),
    "pspg_operator": lambda A, o, x: A.apply_pspg(o, x["tau"], u=x["u"], p=x["p"], inv_dt=20.0,
                                                  adv_u=0.5 * x["a"]),
    "pspg_rhs": lambda A, o, x: A.apply_pspg(o, x["tau"], u=x["u"], inv_dt=20.0,
                                             adv_u=-0.5 * x["a"], fq=x["fq"]),
    "pspg_force": lambda A, o, x: A.apply_pspg(o, x["tau"], fq=x["fq"]),
    "mass_u": lambda A, o, x: A.apply_mass_u(o, x["u"]),
    "diag_transient": lambda A, o, x: A.operator_diag(o, 0.01, 20.0, x["tau"]),
    "diag_steady": lambda A, o, x: A.operator_diag(o, 0.1, None, None),
    "diag_no_tau": lambda A, o, x: A.operator_diag(o, 0.01, 20.0, None),
    "momentum_block": lambda A, o, x: A.apply_momentum_block(o, x["u"], 0.01, 20.0),
    "pressure_schur": lambda A, o, x: A.apply_pressure_schur(o, x["p"], 0.01, x["tau"]),
    "pressure_schur_mass": lambda A, o, x: A.apply_pressure_schur(o, x["p"], 0.01, None),
    "momentum_conv": lambda A, o, x: A.apply_momentum_conv(o, x["u"], 0.01, 20.0, x["a"]),
    "momentum_conv_explicit": lambda A, o, x: A.apply_momentum_conv(o, x["u"], 0.005, None,
                                                                    0.5 * x["a"]),
    "su_tau": lambda A, o, x: A.su_tau(o, x["a"], 0.01, 20.0),
    "su_tau_steady": lambda A, o, x: A.su_tau(o, x["a"], 0.01, None),
    "su": lambda A, o, x: A.apply_su(o, x["u"], x["a"], x["tau"]),
    "grad_p": lambda A, o, x: A.apply_grad_p(o, x["p"]),
    "div_u": lambda A, o, x: A.apply_div_u(o, x["u"]),
    "stiffness_p": lambda A, o, x: A.apply_stiffness_p(o, x["p"]),
    "stiffness_p_diag": lambda A, o, x: A.stiffness_p_diag(o),
    "lumped_mass_u": lambda A, o, x: A.lumped_mass_u(o),
    "mass_p_diag": lambda A, o, x: A.mass_p_diag(o),
    "interpolate_u": lambda A, o, x: A.interpolate_u(o, x["u"]),
    "l2_norm": lambda A, o, x: A.l2_norm(o, A.interpolate_u(o, x["u"])[1]),
}


def _assert_close(got, want, rtol, label):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, label
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max(), err_msg=label)


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_matches_jax(pair, name):
    jo, to, data = pair
    f = OPERATORS[name]
    _assert_close(f(TA, to, _torch(data)), f(JA, jo, _jax(data)), RTOL, name)


def test_tables_match_jax(pair):
    """The basis and geometry tables: the same float64 numbers cast once."""
    jo, to, _ = pair
    for name in ("Nu", "Np", "Gu", "Gp", "wq", "xq", "h_e"):
        np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(to.elem_u.numpy(), np.asarray(jo.elem_u))
    np.testing.assert_array_equal(to.dir_mask.numpy(), np.asarray(jo.dir_mask))


def test_scatter_is_deterministic(pair):
    """Two assemblies of the same element values give the same bits, and
    they equal a float64 scatter-add to float32 rounding; every element
    slot is in the table exactly once."""
    _, to, data = pair
    vals = torch.einsum("eq,ql,eqd->eld", to.wq, to.Nu, torch.from_numpy(data["fq"]))
    a = TA.assemble(vals, to.scatter_u)
    b = TA.assemble(vals.clone(), to.scatter_u)
    assert torch.equal(a, b)
    ref = np.zeros((to.n_u, 2))
    np.add.at(ref, to.elem_u.numpy().ravel(), vals.double().numpy().reshape(-1, 2))
    np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=RTOL * np.abs(ref).max())
    slots = to.scatter_u.numpy().ravel()
    slots = np.sort(slots[slots < vals.shape[0] * vals.shape[1]])
    np.testing.assert_array_equal(slots, np.arange(vals.shape[0] * vals.shape[1]))


@pytest.mark.parametrize("max_coarse", [4096, 40])
def test_pressure_coarse_matches_jax(pair, max_coarse):
    """The aggregation (one level, and re-aggregated below 40 unknowns) is
    the same map; K_c⁻¹ within 1e-5 of its max; the coarse correction and
    the three pressure preconditioners within 1e-6 of their output."""
    jo, to, data = pair
    out = np.arange(5)  # a few pressure-Dirichlet nodes
    jl = JM.build_pressure_coarse(jo, out, max_coarse)
    tl = TM.build_pressure_coarse(to, out, max_coarse)
    np.testing.assert_array_equal(tl.agg.numpy(), np.asarray(jl.agg))
    kc = np.asarray(jl.Kc_inv)
    np.testing.assert_allclose(tl.Kc_inv.numpy(), kc, rtol=0, atol=KC_RTOL * np.abs(kc).max())
    r = data["p"]
    _assert_close(TM.coarse_correct(tl, torch.from_numpy(r)), JM.coarse_correct(jl, r), RTOL,
                  "coarse_correct")
    inv_d = 1.0 / (1.0 + np.abs(r))
    for kind in ("2level", "2level_v", "jacobi"):
        jm = JM.make_pressure_pc(jl, jnp.asarray(inv_d), Ap=lambda q: JA.apply_stiffness_p(jo, q),
                                 kind=kind)
        tm = TM.make_pressure_pc(tl, torch.from_numpy(inv_d),
                                 Ap=lambda q: TA.apply_stiffness_p(to, q), kind=kind)
        _assert_close(tm(torch.from_numpy(r)), jm(jnp.asarray(r)), RTOL, kind)
    with pytest.raises(ValueError, match="unknown pressure pc"):
        TM.make_pressure_pc(tl, torch.from_numpy(inv_d), kind="amg")


def test_schur_coarse_matches_jax(pair):
    """The monolithic preconditioner's Schur-proxy hierarchy
    (``build_schur_coarse``) and the block preconditioner it feeds, with and
    without inner Jacobi sweeps."""
    jo, to, data = pair
    kind = to.kind
    kw = dict(nu=0.01, dt=0.05, space=kind, theta=0.5)
    jl = JF.build_schur_coarse(jo, JF.FEMConfig(**kw))
    tl = TF.build_schur_coarse(to, TF.FEMConfig(**kw))
    np.testing.assert_array_equal(tl.agg.numpy(), np.asarray(jl.agg))
    kc = np.asarray(jl.Kc_inv)
    np.testing.assert_allclose(tl.Kc_inv.numpy(), kc, rtol=0, atol=KC_RTOL * np.abs(kc).max())
    assert TF.build_schur_coarse(to, TF.FEMConfig(**kw), steady=True) is None
    for sweeps in (0, 2):
        cfg_j, cfg_t = JF.FEMConfig(**kw, pc_sweeps=sweeps), TF.FEMConfig(**kw, pc_sweeps=sweeps)
        mj = JF._preconditioner(jo, cfg_j, 20.0, JF._tau(jo, cfg_j), jl)
        mt = TF._preconditioner(to, cfg_t, 20.0, TF._tau(to, cfg_t), tl)
        x = (data["u"], data["p"])
        _assert_close(mt(tuple(map(torch.from_numpy, x))), mj(tuple(map(jnp.asarray, x))), RTOL,
                      f"preconditioner, {sweeps} sweeps")
