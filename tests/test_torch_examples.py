"""The port's example drivers of the cylinder, wedge and convection
workflows (``cfdsim_tpu_torch/examples/``): each runs at a tiny size on the
CPU and writes what it claims (its snapshot container, ``report.json``,
and, for the drivers run with ``--render``, the frames); the shedding
probe and the ghost-cylinder forces are held against the JAX package's
functions of the same name (``examples/cylinder_shedding.py::run_shedding``,
``examples/cylinder_ghost_forces.py::run``) on the same grid and steps.

Tolerances, from the measured worst: the shedding probe series (40
samples, 200 steps of the 60×18 cylinder) within 1e-5 of its largest
|v| (measured 3e-6: float32 sums of the same steps in another order),
the sample times to 1e-6 relative; the ghost cylinder (220 steps of the
48×16 MAC cylinder): mean Cd and St within 1e-4 relative (measured 0 and
4e-7), the Cl amplitude, 8e-4 here, within 1e-6 absolute (measured 1.3e-7).
"""

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cfdsim_tpu_torch.io_.native import csnap_steps

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny grids: thousands of small ops, which the test workers' shared
    cores slow down with OpenMP teams (tests/test_torch_fem.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class JaxProxy:
    """The ``jax`` module, for a JAX driver that imports it at module level
    (install it as the driver module's ``jax``): each function the driver
    jits keeps its outputs in ``outputs`` (the series a driver's scan
    returns and does not keep). ``wrap(n_call, jitted, *args)``, where
    given, is called in place of the jitted function: it may run it and
    change what it returns, or return synthetic values without running it
    (series fed to the driver's own analysis)."""

    def __init__(self, wrap=None):
        import jax

        self._jax, self.wrap, self.outputs = jax, wrap, []

    def __getattr__(self, name):
        return getattr(self._jax, name)

    def jit(self, fn, **kw):
        jitted = self._jax.jit(fn, **kw)

        def call(*args):
            out = (jitted(*args) if self.wrap is None
                   else self.wrap(len(self.outputs), jitted, *args))
            self.outputs.append(out)
            return out

        return call


def report_of(out: Path) -> dict:
    return json.loads((out / "report.json").read_text())


def test_cylinder_reference_v5_ref_parity_render(tmp_path):
    """--ref-parity (the masked RB-SOR through kernel A's wrapper, its plain
    version on the CPU), native snapshots every 2 steps, frames, the energy
    plot and the video."""
    from cfdsim_tpu_torch.examples import cylinder_reference_v5 as drv

    out = tmp_path / "v5"
    assert drv.main(["--device", "cpu", "--nx", "60", "--ny", "18", "--ref-parity",
                     "--max-steps", "4", "--chunk-steps", "2", "--snapshot-interval", "2",
                     "--out", str(out), "--render"]) == 0
    rep = report_of(out)
    assert rep["run_report"]["final_step"] == 4 and rep["run_report"]["stopped_reason"] == ""
    steps = csnap_steps(out / "snapshots.csnap")
    assert sorted(steps) == [0, 2, 4]
    fields, t = steps[4]
    assert set(fields) == {"u", "v", "p"} and fields["u"].shape == (18, 60)
    assert np.isfinite(fields["u"]).all() and t == pytest.approx(
        rep["run_report"]["final_time"], rel=1e-6)
    for kind in ("velocity", "vorticity"):
        assert len(list((out / "frames" / f"{kind}_frames").glob("*.png"))) == 3
    assert (out / "energy_history.png").is_file()
    assert (out / "cylinder.gif").is_file() or (out / "cylinder.mp4").is_file()


def test_cylinder_reference_v5_without_render_writes_no_frames(tmp_path):
    from cfdsim_tpu_torch.examples import cylinder_reference_v5 as drv

    out = tmp_path / "v5"
    assert drv.main(["--device", "cpu", "--nx", "40", "--ny", "12", "--max-steps", "3",
                     "--chunk-steps", "3", "--snapshot-interval", "3", "--io", "hdf5",
                     "--out", str(out)]) == 0
    assert (out / "snapshots.h5").is_file() and not (out / "frames").exists()
    assert report_of(out)["run_report"]["final_step"] == 3


SHEDDING = dict(Re=150.0, t_final=0.05, nx=60, ny=18, sample_every=5)


def test_cylinder_shedding_matches_jax(tmp_path):
    from cfdsim_tpu_torch.examples import cylinder_shedding as drv

    out = tmp_path / "shedding"
    drv.main([str(SHEDDING["Re"]), "--t-final", str(SHEDDING["t_final"]), "--nx", "60",
              "--ny", "18", "--sample-every", "5", "--device", "cpu", "--out", str(out)])
    rep = report_of(out)
    times, probe = np.asarray(rep["times"]), np.asarray(rep["probe"])
    j_times, j_probe, _ = jax_example("cylinder_shedding").run_shedding(**SHEDDING,
                                                                         verbose=False)
    assert probe.shape == j_probe.shape == (40,)
    np.testing.assert_allclose(times, j_times, rtol=1e-6)
    np.testing.assert_allclose(probe, j_probe, rtol=0, atol=1e-5 * np.abs(j_probe).max())
    assert np.isfinite(rep["St"]) and rep["probe_amplitude"] >= 0.0
    (step, (fields, _)), = csnap_steps(out / "snapshots.csnap").items()
    assert step == 200 and fields["v"].shape == (18, 60)


def test_wedge_shock_hdf5_render(tmp_path):
    from cfdsim_tpu_torch.examples import wedge_shock as drv
    from cfdsim_tpu_torch.io_ import list_steps, load_step

    out = tmp_path / "wedge"
    assert drv.main(["--device", "cpu", "--nx", "40", "--ny", "20", "--t-final", "0.3",
                     "--io", "hdf5", "--out", str(out), "--render"]) == 0
    rep = report_of(out)
    assert rep["run_report"]["stopped_reason"] == ""
    assert all(np.isfinite(rep[k]) for k in ("beta_deg", "p2_p1", "rho2_rho1"))
    steps = list_steps(out / "snapshots.h5")
    data, _ = load_step(out / "snapshots.h5", steps[-1])
    assert data["U"].shape == (4, 20, 40)
    for kind in ("density", "velocity"):
        assert list((out / "frames" / f"{kind}_frames").glob("*.png"))


def test_natural_convection_all_three_benchmarks(tmp_path):
    from cfdsim_tpu_torch.examples import natural_convection as drv

    out = tmp_path / "convection"
    rep = drv.main(["1e4", "--cube", "--device", "cpu", "--n", "16", "--rb-ny", "8",
                    "--cube-n", "8", "--chunk", "5", "--t-scale", "0.005", "--out", str(out)])
    assert report_of(out) == json.loads(json.dumps(rep, default=str))
    assert np.isfinite(rep["heated_cavity"]["nu_hot_wall"]) and rep["heated_cavity"]["n"] == 16
    assert [r["Ra"] for r in rep["rayleigh_benard"]] == [1200.0, 3000.0]
    assert np.isfinite(rep["heated_cube"]["nu_hot_wall"])
    (fields, _), = csnap_steps(out / "snapshots.csnap").values()
    assert set(fields) >= {"u", "v", "p", "theta"}


def test_cylinder_accuracy_tiers_three_tiers(tmp_path):
    from cfdsim_tpu_torch.examples import cylinder_accuracy_tiers as drv

    out = tmp_path / "tiers"
    rep = drv.main(["150", "0.3", "--grid-scale", "0.1", "--chunk-steps", "20",
                    "--device", "cpu", "--out", str(out)])
    assert list(rep["tiers"]) == ["uniform_mac", "stretched_mac", "collocated"]
    for name, row in rep["tiers"].items():
        assert np.isfinite(row["St"]) and np.isfinite(row["mean_CD"])
        assert (out / name / "snapshots.csnap").is_file()
    assert report_of(out)["tiers"]["uniform_mac"]["cells"] == 72 * 24


GHOST = dict(re=100.0, ibm="ghost", nx=48, ny=16, t_final=1.0, t_tail=0.3, chunk_steps=20)


def test_cylinder_ghost_forces_matches_jax(tmp_path):
    from cfdsim_tpu_torch.examples import cylinder_ghost_forces as drv

    out = tmp_path / "ghost"
    res = drv.main(["--re", "100", "--ibm", "ghost", "--nx", "48", "--ny", "16", "--t", "1.0",
                    "--t-tail", "0.3", "--chunk-steps", "20", "--device", "cpu",
                    "--out", str(out)])
    want = jax_example("cylinder_ghost_forces").run(**GHOST, verbose=False)
    np.testing.assert_allclose(res["cd"], want["cd"], rtol=1e-4)
    np.testing.assert_allclose(res["cl_amp"], want["cl_amp"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["st"], want["st"], rtol=1e-4)
    rep = report_of(out)
    assert len(rep["t"]) == len(rep["cd_series"]) == 220
    (fields, _), = csnap_steps(out / "snapshots.csnap").values()
    assert fields["u"].shape == (16, 49)


def test_cylinder_oscillating_fit_runs(tmp_path):
    from cfdsim_tpu_torch.examples import cylinder_oscillating_fit as drv

    out = tmp_path / "oscillating"
    res = drv.main(["--device", "cpu", "--nx", "48", "--ny", "24", "--periods", "1.1",
                    "--chunk-steps", "50", "--out", str(out)])
    assert all(np.isfinite(res[k]) for k in ("cd", "cm", "rel_res"))
    rep = report_of(out)
    assert rep["t"][-1] >= 1.1 * 5.0 and len(rep["fx"]) == len(rep["t"])
    assert (out / "snapshots.csnap").is_file()


DRIVERS = ["cylinder_reference_v5", "cylinder_shedding", "wedge_shock", "natural_convection",
           "cylinder_accuracy_tiers", "cylinder_ghost_forces", "cylinder_oscillating_fit",
           "sharded_mac_tiers", "sharded_8192", "sharded_scaling", "sphere_wake", "tgv3d_les",
           "sphere_les_re3900", "kolmogorov_spectrum", "cavity_rossiter",
           "cavity_accuracy_1024", "cylinder_fem", "schafer_turek_2d2"]


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_defaults_to_cuda_and_refuses_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    module = importlib.import_module(f"cfdsim_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        module.main([])
