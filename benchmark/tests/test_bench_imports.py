"""What a run loads: a tiny run of the harness loads neither JAX nor the
JAX package (top-level module names compared whole: the port's name
begins with the JAX package's), and the plain reference loads nothing of
the program."""

import json
import subprocess
import sys

from harness.cells import BENCH_DIR, ROOT

RUN = f"""
import sys, time, json
sys.path[:0] = [{str(BENCH_DIR)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(2)
from harness import window
from harness.cells import load_cell
cell = load_cell("cavity1024.dct")
tiny = cell.config["tiny"]
opts = window.Options(seed=1, seconds=0.2, trace=False, device="cpu",
                      args_override=tiny["args"], problem_override=tiny["problem"],
                      chunk_steps=4)
window.run(cell, opts, time.perf_counter(), emit=lambda s: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import sys, json
sys.path[:0] = [{str(BENCH_DIR)!r}]
import reference.flow2d
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = top_level_modules(RUN)
    assert "cfdsim_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "cfdsim_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = top_level_modules(REFERENCE)
    assert not names & {"cfdsim_tpu_torch", "cfdsim_tpu", "jax"}


def test_loaded_forbidden_compares_whole_names(monkeypatch):
    from harness.window import loaded_forbidden

    monkeypatch.setitem(sys.modules, "cfdsim_tpu_torch_fake", sys)
    assert "cfdsim_tpu_torch_fake" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "cfdsim_tpu.fake", sys)
    assert "cfdsim_tpu.fake" in loaded_forbidden()
