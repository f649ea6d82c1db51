"""Snapshot I/O of the port (``io_/hdf5.py``, ``io_/native.py``), the
runner's snapshot cadence, resume and ``run_on_device``, on the CPU; and
the snapshot files crossing between the two packages.

Everything here is exact: a float32 field survives a snapshot bit for bit,
and a resumed run repeats the uninterrupted one bit for bit (the twins of
tests/test_runner_io.py:40,95,122 and tests/test_native_io.py:27,68,93,126).
``run_on_device`` is held to the JAX package's ``lax.while_loop`` run at the
cavity's step band (atol 1e-5) and to its exact step count.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfdsim_tpu import io_ as jio
from cfdsim_tpu import runner as jrunner
from cfdsim_tpu.cases import build as j_build
from cfdsim_tpu_torch.cases import lid_cavity, transport
from cfdsim_tpu_torch.io_ import (
    SnapshotWriter,
    list_steps,
    load_latest,
    load_step,
    restore,
)
from cfdsim_tpu_torch.io_.native import (
    NativeSnapshotWriter,
    csnap_steps,
    csnap_to_hdf5,
    read_csnap,
)
from cfdsim_tpu_torch.models.incompressible import init_state
from cfdsim_tpu_torch.runner import RunnerConfig, Simulation, run_on_device
from cfdsim_tpu_torch.utils.tree import leaves, named_leaves

STEP_ATOL = 1e-5


def _flow_snapshot(writer):
    def snapshot(state, step, t):
        writer.save(step, t, u=state.u, v=state.v, p=state.p)

    return snapshot


def test_simulation_snapshots_to_t_final(tmp_path):
    """tests/test_runner_io.py:14 with the port's runner and writer."""
    case = lid_cavity(n=32, Re=100.0, device="cpu")
    cfg = RunnerConfig(t_final=0.5, chunk_steps=20, snapshot_interval=40, max_velocity=5.0,
                       div_threshold=50.0)
    sim = Simulation(case.step, case.state, cfg, case.grid.n_cells,
                     _flow_snapshot(SnapshotWriter(tmp_path / "cavity.h5")))
    state, report = sim.run()
    assert float(state.t) >= 0.5 and report["stopped_reason"] == ""
    steps = list_steps(tmp_path / "cavity.h5")
    assert steps == list(range(0, steps[-1] + 1, 40)) and len(steps) >= 2
    fields, t = load_step(tmp_path / "cavity.h5", steps[-1])
    assert set(fields) == {"u", "v", "p"} and np.isfinite(fields["u"]).all()
    assert fields["u"].dtype == np.float32


def test_resume_from_snapshot(tmp_path):
    """tests/test_runner_io.py:40."""
    case = lid_cavity(n=32, Re=100.0, device="cpu")
    cfg = RunnerConfig(t_final=0.3, chunk_steps=20, snapshot_interval=20, div_threshold=50.0)
    Simulation(case.step, case.state, cfg, case.grid.n_cells,
               _flow_snapshot(SnapshotWriter(tmp_path / "c.h5"))).run()
    fields, step, t = load_latest(tmp_path / "c.h5")
    resumed = init_state(case.cfg, u0=fields["u"], v0=fields["v"], p0=fields["p"], device="cpu")
    resumed = resumed._replace(t=torch.tensor(np.float32(t)), step=torch.tensor(np.int32(step)))
    cfg2 = RunnerConfig(t_final=0.6, chunk_steps=20, div_threshold=50.0)
    state2, _ = Simulation(case.step, resumed, cfg2, case.grid.n_cells).run()
    assert float(state2.t) >= 0.6 and int(state2.step) > step


@pytest.mark.parametrize("io", ["hdf5", "native"])
def test_resume_is_bit_exact(tmp_path, io):
    """tests/test_runner_io.py:95, through either writer; ``restore`` reads
    the .csnap container directly."""
    case = lid_cavity(n=24, Re=100.0, device="cpu")
    s = case.state
    for _ in range(10):
        s, _ = case.step(s, 1.0)
    path = tmp_path / ("ck.csnap" if io == "native" else "ck.h5")
    w = NativeSnapshotWriter(path) if io == "native" else SnapshotWriter(path)
    w.save(int(s.step), float(s.t), u=s.u, v=s.v, p=s.p)
    if io == "native":
        w.close()
    s_cont = s
    s_res = restore(case.state, path)
    assert s_res.t.dtype == torch.float32 and s_res.step.dtype == torch.int32
    for (name, a), b in zip(named_leaves(s_res), leaves(s)):
        assert torch.equal(a, b), name
    for _ in range(5):
        s_cont, _ = case.step(s_cont, 1.0)
        s_res, _ = case.step(s_res, 1.0)
    for (name, a), b in zip(named_leaves(s_res), leaves(s_cont)):
        assert torch.equal(a, b), name


def test_snapshot_writer_skips_duplicates(tmp_path):
    """tests/test_runner_io.py:122."""
    w = SnapshotWriter(tmp_path / "d.h5")
    a = torch.ones(4, 4)
    w.save(0, 0.0, u=a)
    w.save(0, 99.0, u=a * 2)
    fields, t = load_step(tmp_path / "d.h5", 0)
    assert t == 0.0
    np.testing.assert_allclose(fields["u"], 1.0)


def test_restore_nested_coupled_state(tmp_path):
    """tests/test_transport_viz.py:114."""
    case = transport(n=24, Re=100.0, device="cpu")
    st = case.state
    for _ in range(20):
        st, _ = case.step(st, 1.0)
    SnapshotWriter(tmp_path / "t.h5").save(int(st.step), float(st.t), u=st.flow.u,
                                          v=st.flow.v, p=st.flow.p, theta=st.theta)
    restored = restore(case.state, tmp_path / "t.h5")
    for (name, a), b in zip(named_leaves(restored), leaves(st)):
        assert torch.equal(a, b), name
    SnapshotWriter(tmp_path / "x.h5").save(0, 0.0, rho=torch.ones(2, 2))
    with pytest.raises(KeyError, match="no snapshot dataset"):
        restore(case.state, tmp_path / "x.h5")
    NativeSnapshotWriter(tmp_path / "e.csnap").close()  # a container with no record
    with pytest.raises(FileNotFoundError, match="no snapshots"):
        load_latest(tmp_path / "e.csnap")


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_snapshot_files_cross_the_packages(tmp_path, direction):
    """A file one package wrote restores in the other to the same arrays."""
    kw = dict(n=24, Re=100.0)
    j_case, t_case = j_build("transport", **kw), transport(device="cpu", **kw)
    rng = np.random.default_rng(2)
    arrays = {k: rng.standard_normal((24, 24)).astype(np.float32)
              for k in ("u", "v", "p", "theta")}
    path = tmp_path / "x.h5"
    if direction == "jax-to-torch":
        jio.SnapshotWriter(path).save(120, 0.375, **{k: jnp.asarray(a) for k, a in
                                                     arrays.items()})
        got = restore(t_case.state, path)
        out = {"u": got.flow.u, "v": got.flow.v, "p": got.flow.p, "theta": got.theta}
        out = {k: v.numpy() for k, v in out.items()}
    else:
        SnapshotWriter(path).save(120, 0.375, **{k: torch.from_numpy(a) for k, a in
                                                 arrays.items()})
        got = jio.restore(j_case.state, path)
        out = {"u": got.flow.u, "v": got.flow.v, "p": got.flow.p, "theta": got.theta}
        out = {k: np.asarray(v) for k, v in out.items()}
    for k, a in arrays.items():
        assert np.array_equal(out[k], a) and out[k].dtype == np.float32, k
    assert int(got.step) == 120 and float(got.t) == 0.375
    assert jio.list_steps(path) == list_steps(path) == [120]


def test_native_roundtrip_exact(tmp_path):
    """tests/test_native_io.py:27, fed tensors and arrays."""
    p = tmp_path / "a.csnap"
    rng = np.random.default_rng(0)
    u = rng.standard_normal((48, 64)).astype(np.float32)
    v = rng.standard_normal((48, 64)).astype(np.float64)
    with NativeSnapshotWriter(p) as w:
        w.save(0, 0.0, u=torch.from_numpy(u), v=v)
        w.save(100, 1.5, u=torch.from_numpy(u) * 2)
        w.flush()
    recs = read_csnap(p)
    assert [r["name"] for r in recs] == ["u", "v", "u"]
    np.testing.assert_array_equal(recs[0]["array"], u)
    np.testing.assert_array_equal(recs[1]["array"], v)
    assert recs[1]["array"].dtype == np.float64
    steps = csnap_steps(p)
    assert set(steps) == {0, 100} and steps[100][1] == 1.5
    assert load_latest(p)[1:] == (100, 1.5)


def test_native_library_is_built_outside_the_jax_packages_directory():
    from cfdsim_tpu_torch.io_ import native

    native._build_lib()
    built = list(native._BUILD_DIR.glob("libcsnap-*.so"))
    assert built and native._BUILD_DIR.parts[-2:] == ("build", "cfdsim_tpu_torch")
    assert native._SRC.parts[-2:] == ("native", "csnap.cc")


def test_native_hdf5_conversion(tmp_path):
    """tests/test_native_io.py:68."""
    p = tmp_path / "c.csnap"
    with NativeSnapshotWriter(p) as w:
        w.save(0, 0.25, u=np.ones((8, 8), np.float32))
        w.flush()
    h5 = csnap_to_hdf5(p, tmp_path / "c.h5")
    assert list_steps(h5) == [0]
    fields, t = load_step(h5, 0)
    assert t == 0.25
    np.testing.assert_array_equal(fields["u"], 1.0)


def test_read_csnap_truncated_tail(tmp_path):
    """tests/test_native_io.py:93."""
    w = NativeSnapshotWriter(tmp_path / "t.csnap")
    w.save(0, 0.0, u=np.ones((8, 8), np.float32))
    w.save(1, 0.5, u=np.full((8, 8), 2.0, np.float32))
    w.flush()
    w.close()
    raw = (tmp_path / "t.csnap").read_bytes()
    (tmp_path / "t.csnap").write_bytes(raw[:-7])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        recs = read_csnap(tmp_path / "t.csnap")
    assert len(recs) == 1 and recs[0]["step"] == 0
    assert any("truncated" in str(c.message) for c in caught)
    with pytest.raises(IOError):
        read_csnap(tmp_path / "t.csnap", strict=True)
    (tmp_path / "bad.csnap").write_bytes(b"not a container")
    with pytest.raises(ValueError, match="not a csnap file"):
        read_csnap(tmp_path / "bad.csnap")


def test_reopen_existing_container_no_duplicate_magic(tmp_path):
    """tests/test_native_io.py:126."""
    for step in (0, 1):
        w = NativeSnapshotWriter(tmp_path / "r.csnap")
        w.save(step, float(step), u=np.full((4, 4), step, np.float32))
        w.flush()
        w.close()
    assert [r["step"] for r in read_csnap(tmp_path / "r.csnap")] == [0, 1]


def test_runner_snapshots_a_coupled_state_between_chunks(tmp_path):
    """The snapshot reads the runner's own state: what it saved at a step
    is what a run that stops at that step ends in."""
    case = transport(n=16, device="cpu")
    saved = {}

    def snapshot(state, step, t):
        saved[step] = ([x.clone() for x in leaves(state)], t)

    cfg = RunnerConfig(t_final=1e9, max_steps=12, chunk_steps=4, snapshot_interval=8)
    final, _ = Simulation(case.step, case.state, cfg, case.grid.n_cells, snapshot).run()
    assert sorted(saved) == [0, 8]
    cfg8 = RunnerConfig(t_final=1e9, max_steps=8, chunk_steps=4)
    at8, _ = Simulation(case.step, case.state, cfg8, case.grid.n_cells).run()
    for a, b in zip(saved[8][0], leaves(at8)):
        assert torch.equal(a, b)
    assert saved[8][1] == float(at8.t) and int(final.step) == 12


def test_runner_progress_and_memory_log():
    import logging

    records = []
    log = logging.getLogger("cfdsim_tpu_torch.test_progress")  # a logger of the test's own
    log.setLevel(logging.INFO)
    log.propagate = False
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    case = lid_cavity(n=16, device="cpu")
    cfg = RunnerConfig(t_final=1e9, max_steps=4, chunk_steps=2, log_every_chunks=1,
                       progress=True, log_memory=True)
    try:
        Simulation(case.step, case.state, cfg, case.grid.n_cells, logger=log).run()
    finally:
        log.removeHandler(handler)
    assert sum("host memory usage" in r.getMessage() for r in records) == 2


def test_runner_health_fn_overrides_the_default_check():
    from cfdsim_tpu_torch.monitor import HealthReport

    case = lid_cavity(n=16, device="cpu")
    seen = []

    def health(metrics, step):
        seen.append((step, metrics.dt.shape))
        return HealthReport(step < 4, "told to stop")

    cfg = RunnerConfig(t_final=1e9, max_steps=20, chunk_steps=2)
    _, report = Simulation(case.step, case.state, cfg, case.grid.n_cells,
                           health_fn=health).run()
    assert seen == [(2, (2,)), (4, (2,))] and report["stopped_reason"] == "unhealthy: told to stop"


@pytest.mark.parametrize("kw, t_final, max_steps", [
    (dict(n=24, Re=100.0), 0.2, 10_000_000),
    (dict(n=24, Re=100.0), 1e9, 13),
    (dict(n=24, Re=100.0), 0.0, 10_000_000),
], ids=["t-final", "max-steps", "already-over"])
def test_run_on_device_matches_the_while_loop(kw, t_final, max_steps):
    """Chunks of steps that stop advancing on the device end where the JAX
    package's ``lax.while_loop`` ends, step for step, whatever the chunk
    length; the returned metrics are the last advancing step's."""
    j_case, t_case = j_build("cavity", **kw), lid_cavity(device="cpu", **kw)
    js, jm = jrunner.run_on_device(j_case.step, j_case.state, t_final, max_steps)
    ts, tm = run_on_device(t_case.step, t_case.state, t_final, max_steps, chunk_steps=7)
    assert int(ts.step) == int(js.step) and float(ts.t) == pytest.approx(float(js.t), abs=1e-6)
    for k in ("u", "v"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(js, k)), rtol=0,
                                   atol=STEP_ATOL)
    assert float(tm.dt) == pytest.approx(float(jm.dt), rel=1e-6)
    assert float(tm.energy) == pytest.approx(float(jm.energy), rel=5e-5, abs=1e-12)
    # and equals the plain loop of the port, bit for bit
    s, n = t_case.state, 0
    while float(s.t) < np.float32(t_final) and n < max_steps:
        s, m = t_case.step(s, 1.0)
        n += 1
    assert torch.equal(s.u, ts.u) and torch.equal(s.t, ts.t) and n == int(ts.step)
    if n:
        assert float(m.energy) == float(tm.energy)
