"""The command line of the port on the CPU: run → render → video → thin,
``--resume`` bit-exact through both writers, and every registered case
building and stepping (the twins of tests/test_cli.py:29,67,128), called
in-process through ``__main__.main``. The render steps need matplotlib,
Pillow and h5py, which the test environment has.
"""

import json

import numpy as np
import pytest
import torch

from cfdsim_tpu.cases import CASES as J_CASES
from cfdsim_tpu_torch import __main__ as cli
from cfdsim_tpu_torch.cases import CASES, build
from cfdsim_tpu_torch.io_ import list_steps, load_step
from cfdsim_tpu_torch.io_.native import csnap_steps
from cfdsim_tpu_torch.utils.tree import leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The FEM cases' Stokes solves are thousands of small ops. Where the test workers share
    the cores, each op's OpenMP team waits on descheduled threads (measured
    ~8 ms an op at full load against ~10 µs alone), so this module's torch
    runs on one thread; the setting is put back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_list_cases(capsys):
    cli.main(["list"])
    out = capsys.readouterr().out
    for name in ("cavity", "channel", "cylinder", "transport", "cavity_mac", "cavity_stretched",
                 "cylinder_mac", "cylinder_oscillating", "cylinder_stretched", "heated_cavity",
                 "rayleigh_benard", "cavity3d", "cavity3d_mac", "cavity3d_stretched", "sphere",
                 "sphere_stretched", "heated_sphere", "heated_sphere_stretched", "heated_cube",
                 "wedge", "cavity_supersonic", "blast3d", "kolmogorov", "kolmogorov_ps",
                 "cylinder_fem", "cavity_fem", "schafer_turek_fem"):
        assert name in out


def test_run_render_video_thin(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:29."""
    out = tmp_path / "run"
    report = cli.main(["run", "cavity", "--n", "24", "--t-final", "0.2", "--chunk-steps", "10",
                       "--snapshot-interval", "10", "--out", str(out), "--poisson", "jacobi:4",
                       "--device", "cpu"])
    assert report["final_time"] >= 0.2 and (out / "snapshots.h5").exists()
    assert _last_json(capsys) == report

    cli.main(["render", str(out / "snapshots.h5"), str(out / "frames")])
    assert _last_json(capsys)["velocity"] >= 2

    cli.main(["video", str(out / "frames" / "velocity_frames"), str(out / "movie.gif"),
              "--duration", "1"])
    assert (out / "movie.gif").exists()

    # without --yes and with no terminal the interactive confirm refuses to delete
    monkeypatch.setattr("sys.stdin", open("/dev/null"))
    cli.main(["thin", str(out / "frames" / "velocity_frames"), "--keep-every", "2"])
    assert _last_json(capsys)["aborted"] is True
    cli.main(["thin", str(out / "frames" / "velocity_frames"), "--keep-every", "2", "--yes"])
    assert _last_json(capsys)["deleted"] >= 0


def test_run_with_render_flag_writes_frames(tmp_path, capsys):
    """The acceptance command at a smaller size: snapshots.h5 and frames,
    with the temperature field for the coupled case."""
    out = tmp_path / "t"
    cli.main(["run", "transport", "--n", "16", "--device", "cpu", "--snapshot-interval", "4",
              "--chunk-steps", "4", "--max-steps", "8", "--render", "--out", str(out)])
    assert list_steps(out / "snapshots.h5") == [0, 4, 8]
    assert set(load_step(out / "snapshots.h5", 8)[0]) == {"u", "v", "p", "theta"}
    for field in ("velocity", "vorticity", "temperature"):
        assert len(list((out / "frames" / f"{field}_frames").glob("*.png"))) == 3


def test_unknown_case_errors(tmp_path):
    with pytest.raises(KeyError, match="unknown case"):
        cli.main(["run", "definitely_not_a_case", "--device", "cpu", "--out", str(tmp_path)])


SPHERE = dict(nx=16, ny=8, nz=8, domain=(4.0, 2.0, 2.0), center=(1.0, 1.0, 1.0))
TINY = {
    "cavity": dict(n=16),
    "channel": dict(nx=32, ny=16),
    "cylinder": dict(nx=48, ny=24),
    "transport": dict(n=16),
    "cavity_mac": dict(n=16),
    "cavity_stretched": dict(n=16),
    "cylinder_mac": dict(nx=48, ny=16),
    "cylinder_oscillating": dict(nx=32, ny=16),
    "cylinder_stretched": dict(nx=32, ny=16),
    "heated_cavity": dict(n=16),
    "rayleigh_benard": dict(ny=8),
    "cavity3d": dict(n=8),
    "cavity3d_mac": dict(n=8),
    "cavity3d_stretched": dict(n=8),
    "sphere": SPHERE,
    "sphere_stretched": SPHERE,
    "heated_sphere": SPHERE,
    "heated_sphere_stretched": SPHERE,
    "heated_cube": dict(n=8),
    "wedge": dict(nx=24, ny=12),
    "cavity_supersonic": dict(nx=24, ny=12),
    "blast3d": dict(n=8),
    "kolmogorov": dict(ny=16),
    "kolmogorov_ps": dict(ny=16, noise=0.1),
    "cylinder_fem": dict(h_far=0.6, h_near=0.15, viz_shape=(8, 8)),
    "cavity_fem": dict(n=6, viz_shape=(8, 8)),
    "schafer_turek_fem": dict(h_near=0.03, h_far=0.1, viz_shape=(8, 16)),
}
# the options each tier has: the collocated cases take implicit diffusion
# and LES together; on the MAC tiers the cavity takes each alone, the
# oscillating cylinder also runs on the stretched grid
VARIANTS = {name: [{}, dict(diffusion="implicit"), dict(use_les=True),
                   dict(use_les=True, diffusion="implicit")]
            for name in ("cavity", "channel", "cylinder", "transport")}
VARIANTS.update(cavity_mac=[{}, dict(diffusion="implicit"), dict(use_les=True)],
                cylinder_mac=[{}, dict(ibm_scheme="ghost")],
                cylinder_oscillating=[{}, dict(stretched=True), dict(ibm_scheme="ghost"),
                                      dict(stretched=True, ibm_scheme="ghost")],
                heated_cavity=[{}, dict(theta_scheme="upwind"), dict(poisson="mg:2")],
                cavity3d=[{}, dict(poisson="dct")],
                cavity3d_mac=[{}, dict(use_les=True, scheme="tvd", time_scheme="rk2"),
                              dict(use_les=True, les_model="dynamic")],
                cavity3d_stretched=[{}, dict(use_les=True, les_model="dynamic")],
                sphere=[{}, dict(ibm_scheme="ghost"), dict(use_les=True, les_model="dynamic"),
                        dict(perturb=0.05)],
                sphere_stretched=[{}, dict(ibm_scheme="ghost", use_les=True,
                                           les_model="dynamic")],
                heated_sphere=[{}, dict(ibm_scheme="ghost", theta_scheme="tvd")],
                heated_sphere_stretched=[{}, dict(ibm_scheme="ghost", theta_scheme="tvd")],
                heated_cube=[{}, dict(theta_scheme="upwind")],
                wedge=[{}, dict(wall_treatment="ghost", reconstruction="muscl"),
                       dict(frame="wedge_aligned", time_order=2), dict(flux="roe_ref")],
                cavity_supersonic=[{}, dict(real_geometry=True, flux="roe")],
                blast3d=[{}, dict(flux="rusanov", reconstruction="none")],
                kolmogorov=[{}, dict(advection="bfecc", linear_friction=0.1)],
                kolmogorov_ps=[{}, dict(linear_friction=0.2)],
                cylinder_fem=[{}, dict(scheme="projection", rotational=1.0),
                              dict(stab="pspg", precision="fp64")],
                cavity_fem=[{}, dict(stab="pspg", theta=0.5)],
                schafer_turek_fem=[{}, dict(scheme="projection")])


def test_every_registered_case_builds_and_steps():
    """tests/test_cli.py:67, for the cases the port registers, each also
    with the options its tier has: every one is a case of the JAX package."""
    assert set(TINY) == set(CASES), "update the tiny-shape table"
    assert set(CASES) <= set(J_CASES)
    for name, kw in TINY.items():
        for extra in VARIANTS.get(name, [{}]):
            case = build(name, device="cpu", **kw, **extra)
            state, metrics = case.step(case.state, 1.0)
            assert all(bool(torch.isfinite(x).all()) for x in leaves(state)), (name, extra)
            assert float(metrics.dt) > 0
    for scheme in ("tvd", "supg", "upwind"):
        case = build("cylinder", device="cpu", scheme=scheme, **TINY["cylinder"])
        state, _ = case.step(case.state, 1.0)
        assert bool(torch.isfinite(state.u).all()), scheme


@pytest.mark.parametrize("io", ["hdf5", "native"])
@pytest.mark.parametrize("case", ["cavity", "transport"])
def test_run_resume_bit_exact(tmp_path, io, case):
    """tests/test_cli.py:128: kill-and-resume through the command line
    matches an uninterrupted run bit for bit, through either writer."""
    common = ["--n", "32", "--chunk-steps", "20", "--snapshot-interval", "20", "--poisson",
              "jacobi:8", "--device", "cpu", "--io", io]
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    cli.main(["run", case, "--t-final", "0.3", "--out", str(out_a), *common])
    report = cli.main(["run", case, "--t-final", "0.6", "--out", str(out_a), "--resume",
                       *common])
    assert report["final_time"] >= 0.6
    cli.main(["run", case, "--t-final", "0.6", "--out", str(out_b), *common])

    def steps(out):
        if io == "native":
            return csnap_steps(out / "snapshots.csnap")
        path = out / "snapshots.h5"
        return {s: load_step(path, s) for s in list_steps(path)}

    a, b = steps(out_a), steps(out_b)
    assert sorted(a) == sorted(b) and max(a) == report["final_step"] > 20
    fields = {"u", "v", "p"} | ({"theta"} if case == "transport" else set())
    for step in a:
        assert set(a[step][0]) == fields
        for name in fields:
            np.testing.assert_array_equal(a[step][0][name], b[step][0][name])
        assert a[step][1] == b[step][1]


def test_resume_from_a_named_file_of_the_other_writer(tmp_path):
    """``--resume FILE`` takes a .csnap container directly, whatever --io
    the resumed run writes with."""
    common = ["run", "cavity", "--n", "16", "--chunk-steps", "5", "--snapshot-interval", "5",
              "--device", "cpu"]
    cli.main([*common, "--max-steps", "10", "--io", "native", "--out", str(tmp_path / "a")])
    report = cli.main([*common, "--max-steps", "15", "--io", "hdf5", "--out",
                       str(tmp_path / "b"), "--resume", str(tmp_path / "a" / "snapshots.csnap")])
    assert report["final_step"] == 15 and report["total_steps"] == 5
    assert list_steps(tmp_path / "b" / "snapshots.h5") == [10, 15]


def test_snapshots_can_be_turned_off(tmp_path):
    cli.main(["run", "cavity", "--n", "16", "--max-steps", "4", "--chunk-steps", "2",
              "--snapshot-interval", "0", "--device", "cpu", "--out", str(tmp_path)])
    assert not (tmp_path / "snapshots.h5").exists()


def test_tuple_arguments_reach_the_case(tmp_path):
    report = cli.main(["run", "cylinder", "--nx", "48", "--ny", "24", "--center", "(5.0,2.0)",
                       "--max-steps", "2", "--chunk-steps", "2", "--snapshot-interval", "0",
                       "--device", "cpu", "--out", str(tmp_path)])
    assert report["final_step"] == 2
