"""The port's sharded example drivers (``cfdsim_tpu_torch/examples/
sharded_mac_tiers.py``, ``sharded_8192.py``, ``sharded_scaling.py``) on
two gloo ranks at a tiny size: each runs its group through
``parallel/launch.py::spawn`` and writes ``report.json`` (the steps across
both mesh axes are the other distributed tests' subject).

Tolerances: each staggered tier within the dry run's float32 bounds of its
single-device step after 2 steps (1e-5 in 2D, 2e-5 in 3D; measured 5e-8,
0 and 8e-8); the 64² MAC cavity passes the JAX driver's own gate (finite,
div_post under 3e-4·(n/512)², max speed under 1.05); the explicit
collocated cavity on a 1×2 mesh within 1e-5 of the single-device one
(measured 0).
"""

import json

import numpy as np


def report_of(out):
    return json.loads((out / "report.json").read_text())


def test_sharded_mac_tiers_on_gloo_ranks(tmp_path):
    from cfdsim_tpu_torch.examples import sharded_mac_tiers as drv

    rep = drv.main(["--device", "cpu", "--ranks", "2", "--steps", "2", "--out", str(tmp_path)])
    assert rep["mesh"] == [1, 2] and rep["backend"] == "gloo"
    rows = {r["tier"]: r for r in rep["rows"]}
    assert list(rows) == ["2D MAC (DCT)", "2D stretched (FDM)", "3D MAC (3D DCT)"]
    for name, atol in (("2D MAC (DCT)", 1e-5), ("2D stretched (FDM)", 1e-5),
                       ("3D MAC (3D DCT)", 2e-5)):
        assert rows[name]["max_abs_err"] <= atol and rows[name]["ranks"] == 2
        assert 0.0 <= rows[name]["div_post"] < 1e-3
    assert report_of(tmp_path) == rep


def test_sharded_8192_gate_at_a_small_n(tmp_path):
    from cfdsim_tpu_torch.examples import sharded_8192 as drv

    res = drv.main(["--n", "64", "--steps", "2", "--device", "cpu", "--ranks", "2",
                    "--out", str(tmp_path)])
    assert res["ok"] and res["ranks"] == 2 and res["steps"] == 2
    assert res["metric"] == "sharded_64sq_demo" and np.isfinite(res["energy"])
    assert report_of(tmp_path)["ok"]


def test_sharded_scaling_on_a_two_rank_mesh(tmp_path):
    from cfdsim_tpu_torch.examples import sharded_scaling as drv

    rep = drv.main(["--n", "32", "--steps", "2", "--device", "cpu", "--ranks", "2",
                    "--out", str(tmp_path)])
    assert [r["config"] for r in rep["rows"]] == ["single-device", "mesh 1x2"]
    assert rep["rows"][1]["max_abs_du"] <= 1e-5
    assert all(r["seconds"] > 0 for r in rep["rows"])
    assert report_of(tmp_path)["rows"][1]["config"] == "mesh 1x2"
