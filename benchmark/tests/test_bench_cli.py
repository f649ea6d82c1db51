"""The command refuses to report where it cannot measure: without a CUDA
card (this machine), and in a directory that holds only BENCHMARK.json
and the benchmark's folder (no program). It prints no result either way."""

import shutil
import subprocess
import sys

from harness.cells import BENCH_DIR, ROOT

ARGS = ["--workload", "cavity1024.dct", "--seed", "3000000000", "--seconds", "1",
        "--trace", "0"]


def run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # on a card this is a measurement, not a refusal
    p = run(ROOT)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "CUDA" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = run(tmp_path)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "program" in p.stderr
