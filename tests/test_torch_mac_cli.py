"""The staggered tiers through the port's pipeline on the CPU: ``make_chunk``
on every new case against stepping by hand (bit for bit: the loop route
runs the same ops), and the command line's ``run`` of ``cavity_mac`` with
snapshots, ``--resume`` through both writers, and ``render``. A MAC state's
fields have three shapes, (ny, nx+1), (ny+1, nx) and (ny, nx)."""

import numpy as np
import pytest
import torch

from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import build
from cfdsim_tpu_torch.io_ import list_steps, load_step, restore
from cfdsim_tpu_torch.io_.native import csnap_steps
from cfdsim_tpu_torch.models.incompressible import StepMetrics, make_chunk
from cfdsim_tpu_torch.models.mac import MACState

NEW_CASES = {
    "cavity_mac": dict(n=16),
    "cavity_mac_incremental_rk2": dict(n=16, projection="incremental", time_scheme="rk2"),
    "cavity_stretched": dict(n=16),
    "cylinder_mac": dict(nx=48, ny=16),
    "cylinder_oscillating": dict(nx=32, ny=16),
    "cylinder_oscillating_stretched": dict(nx=32, ny=16, stretched=True),
    "cylinder_stretched": dict(nx=32, ny=16),
}


def _build(name, kw):
    case_name = next(c for c in ("cavity_mac", "cavity_stretched", "cylinder_mac",
                                 "cylinder_oscillating", "cylinder_stretched")
                     if name.startswith(c))
    return build(case_name, device="cpu", **kw)


@pytest.mark.parametrize("name", sorted(NEW_CASES))
def test_chunk_equals_step_calls_bit_for_bit(name):
    case = _build(name, NEW_CASES[name])
    n = 4
    chunk = make_chunk(case.cfg, case.step, n)
    assert chunk.mode == "loop"
    state, stacked = chunk(case.state, 1.0)
    s, rows = case.state, []
    for _ in range(n):
        s, m = case.step(s, torch.tensor(1.0))
        rows.append(m)
    want = StepMetrics(*(torch.stack(col) for col in zip(*rows)))
    assert isinstance(state, MACState) and int(state.step) == n
    for k in state._fields:
        assert torch.equal(getattr(state, k), getattr(s, k)), k
    for k in want._fields:
        assert torch.equal(getattr(stacked, k), getattr(want, k)), k
    assert stacked.dt.shape == (n,)


@pytest.mark.parametrize("io", ["hdf5", "native"])
def test_run_resume_bit_exact(tmp_path, io):
    common = ["--n", "24", "--Re", "400", "--chunk-steps", "10", "--snapshot-interval", "10",
              "--device", "cpu", "--io", io]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", "cavity_mac", "--max-steps", "20", "--out", str(out_a), *common])
    report = cli.main(["run", "cavity_mac", "--max-steps", "40", "--out", str(out_a), "--resume",
                       *common])
    assert report["final_step"] == 40 and report["total_steps"] == 20
    cli.main(["run", "cavity_mac", "--max-steps", "40", "--out", str(out_b), *common])
    file = "snapshots.csnap" if io == "native" else "snapshots.h5"
    if io == "native":
        a, b = csnap_steps(out_a / file), csnap_steps(out_b / file)
    else:
        a = {s: load_step(out_a / file, s) for s in list_steps(out_a / file)}
        b = {s: load_step(out_b / file, s) for s in list_steps(out_b / file)}
    assert sorted(a) == sorted(b) == [0, 10, 20, 30, 40]
    for step in a:
        assert {k: v.shape for k, v in a[step][0].items()} == {
            "u": (24, 25), "v": (25, 24), "p": (24, 24)}
        for name in ("u", "v", "p"):
            np.testing.assert_array_equal(a[step][0][name], b[step][0][name])
        assert a[step][1] == b[step][1]

    # the restored state is the state the run had at its snapshot: the same
    # steps taken by hand from the case's initial state
    case = build("cavity_mac", n=24, Re=400.0, device="cpu")
    s = case.state
    for _ in range(40):
        s, _ = case.step(s, 1.0)
    back = restore(case.state, out_a / file)
    assert isinstance(back, MACState)
    for k in back._fields:
        assert torch.equal(getattr(back, k), getattr(s, k)), k


def test_render_averages_the_staggered_faces(tmp_path, capsys):
    out = tmp_path / "run"
    cli.main(["run", "cylinder_mac", "--nx", "48", "--ny", "16", "--max-steps", "4",
              "--chunk-steps", "2", "--snapshot-interval", "2", "--device", "cpu",
              "--out", str(out)])
    cli.main(["render", str(out / "snapshots.h5"), str(out / "frames")])
    counts = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"velocity": 3' in counts
    assert len(list((out / "frames" / "velocity_frames").glob("*.png"))) == 3
