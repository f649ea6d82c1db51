"""The port's collocated cavity as a whole against the JAX package: step
parity from a carried-over state, the 48² golden, the runner, the CLI, and
that the port never loads JAX.

Tolerances:
- step parity: atol 1e-5 on every state field and StepMetrics entry (the
  band of tests/test_pallas.py:144-145), except ``poisson_res``. That is the
  max of |∇²φ − rhs|, the rounding noise of the FFT solve amplified by ∇²;
  its size depends on the FFT's summation order, which differs between the
  frameworks (observed ≤ 1.5e-4 relative), so it is held to 1e-2 relative:
  the same noise level, far from the gap a metric of the wrong array makes.
- golden: RTOL 2e-5 under the rule of tests/test_goldens.py:112-124.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import lid_cavity as j_lid_cavity
from cfdsim_tpu.models.incompressible import IncompressibleState as JState
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build, lid_cavity
from cfdsim_tpu_torch.convert import state_from_numpy, state_to_numpy
from cfdsim_tpu_torch.runner import RunnerConfig, Simulation

REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "goldens.json").read_text())["cavity_collocated_48"]
STEP_ATOL = 1e-5
POISSON_RES_RTOL = 1e-2
GOLDEN_RTOL = 2e-5


def _advanced_jax_state(n=32, steps=20):
    """A developed (non-trivial) JAX cavity state to carry across."""
    case = j_lid_cavity(n=n, Re=100.0)
    step = jax.jit(case.step)
    s = case.state
    for _ in range(steps):
        s, _ = step(s, jnp.float32(1.0))
    return s


@pytest.mark.parametrize("fused", [False, True])
def test_five_steps_match_jax(fused):
    s0 = _advanced_jax_state()
    j_case = j_lid_cavity(n=32, Re=100.0, fused_predictor=fused)
    t_case = lid_cavity(n=32, Re=100.0, fused_predictor=fused, device="cpu")
    js = s0
    ts = state_from_numpy(*(np.asarray(getattr(s0, k)) for k in JState._fields), "cpu")
    j_step = jax.jit(j_case.step)
    for _ in range(5):
        js, jm = j_step(js, jnp.float32(1.0))
        ts, tm = t_case.step(ts, torch.tensor(1.0))
        for name in jm._fields:
            want, got = float(getattr(jm, name)), float(getattr(tm, name))
            tol = POISSON_RES_RTOL * abs(want) if name == "poisson_res" else STEP_ATOL
            assert abs(got - want) <= tol, (name, got, want)
    out = state_to_numpy(ts)
    for name in ("u", "v", "p", "t"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(js, name)),
                                   rtol=0, atol=STEP_ATOL, err_msg=name)
    assert int(out["step"]) == int(js.step) == 25


def test_state_round_trips_through_numpy():
    rng = np.random.default_rng(3)
    u, v, p = (rng.standard_normal((8, 12)).astype(np.float32) for _ in range(3))
    s = state_from_numpy(u, v, p, 0.25, 7, "cpu")
    assert s.t.dtype == torch.float32 and s.step.dtype == torch.int32
    back = state_to_numpy(s)
    for name, a in zip("uvp", (u, v, p)):
        assert np.array_equal(back[name], a)
    assert back["t"] == np.float32(0.25) and back["step"] == 7
    # and into the JAX package's state type
    js = JState(**{k: jnp.asarray(back[k]) for k in JState._fields})
    assert np.array_equal(np.asarray(js.u), u)


@pytest.mark.parametrize("fused", [False, True])
def test_golden_cavity_collocated_48(fused):
    case = build("cavity", n=48, Re=100.0, fused_predictor=fused, device="cpu")
    s = case.state
    for _ in range(300):
        s, _ = case.step(s, 1.0)
    _, m = case.step(s, 1.0)
    sig = {}
    for name in ("u", "v", "p"):
        f = getattr(s, name)
        sig[f"l2_{name}"] = float(torch.sqrt(torch.mean(f * f)))
        sig[f"max_{name}"] = float(f.abs().max())
    for name in ("energy", "max_vel", "fx", "fy", "vort_max"):
        sig[name] = float(getattr(m, name))
    scale = max(abs(v) for v in GOLDEN.values())
    atol = 1e-6 * scale
    for key, want in GOLDEN.items():
        tol = GOLDEN_RTOL * abs(want) if abs(want) > atol else atol
        assert abs(sig[key] - want) <= tol, (key, sig[key], want)


def test_runner_two_chunks():
    case = lid_cavity(n=32, Re=100.0, device="cpu")
    cfg = RunnerConfig(t_final=1e9, max_steps=20, chunk_steps=10,
                       max_velocity=case.cfg.max_velocity, div_threshold=50.0)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells)
    state, report = sim.run()
    assert report["final_step"] == int(state.step) == 20
    assert report["stopped_reason"] == ""
    assert len(sim.metrics_history) == 2
    assert report["final_time"] == pytest.approx(float(state.t))
    assert sim.metrics_history[-1]["max_vel"] == pytest.approx(1.0)
    assert torch.isfinite(state.u).all()


def test_runner_refuses_snapshots():
    """With ``snapshot_interval=0`` the runner takes no snapshot, whatever
    ``snapshot_fn`` it was given; with an interval it takes one at the start
    and one per interval, between chunks."""
    case = lid_cavity(n=16, Re=100.0, device="cpu")
    for interval, want in ((0, []), (4, [0, 4, 8])):
        taken = []
        cfg = RunnerConfig(t_final=1e9, max_steps=8, chunk_steps=2, snapshot_interval=interval)
        Simulation(case.step, case.state, cfg, case.grid.n_cells,
                   snapshot_fn=lambda state, step, t: taken.append(step)).run()
        assert taken == want


def test_cli_run_cavity(tmp_path, capsys):
    report = cli.main(["run", "cavity", "--n", "32", "--t-final", "0.05",
                       "--chunk-steps", "5", "--device", "cpu", "--out", str(tmp_path)])
    assert report["final_time"] >= 0.05 and report["stopped_reason"] == ""
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert (tmp_path / "logs" / "cfdsim_tpu_torch.log").exists()


def test_cli_two_runs_in_one_process_log_into_their_own_out(tmp_path):
    """The second run's log goes to its own ``--out``, not the first's."""
    for name in ("first", "second"):
        cli.main(["run", "cavity", "--n", "16", "--max-steps", "2", "--chunk-steps", "2",
                  "--device", "cpu", "--out", str(tmp_path / name)])
    for name in ("first", "second"):
        log = tmp_path / name / "logs" / "cfdsim_tpu_torch.log"
        assert log.exists() and log.stat().st_size > 0
    handlers = logging.getLogger("cfdsim_tpu_torch").handlers
    assert sum(isinstance(h, logging.FileHandler) for h in handlers) == 1


@pytest.mark.parametrize("argv, why", [
    (["run", "cavity", "--n", "16", "--device", "cpu", "--resume"], "no snapshot file"),
    (["render", "no_such_snapshots.h5", "frames"], "no snapshot file"),
    (["run", "cavity", "--n", "16", "--device", "cuda:0"], "CUDA is not available"),
    (["bench", "--n", "16", "--device", "cpu"], "measures a CUDA device"),
    (["bench", "--sweep", "--device", "cpu"], "measures a CUDA device"),
], ids=["resume", "snapshots", "cuda-absent", "bench-cpu", "sweep-cpu"])
def test_cli_refuses(argv, why, tmp_path):
    if "cuda:0" in argv and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = ["--out", str(tmp_path)] if argv[0] == "run" else []
    with pytest.raises(SystemExit, match=why):
        cli.main(argv + out)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cfdsim_tpu_torch\n"
        "for m in pkgutil.walk_packages(cfdsim_tpu_torch.__path__, 'cfdsim_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'cfdsim_tpu.')) or k == 'cfdsim_tpu')\n"
        "print(len(list(pkgutil.walk_packages(cfdsim_tpu_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
