"""Running a cell of the benchmark on the CPU at its configuration's tiny
size, through the same harness as a run on the card."""

import json
import time
from pathlib import Path

from harness import window
from harness.cells import BENCH_DIR, load_cell

TEST_CHUNK = 4  # steps per chunk on the CPU


def spec(bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir.parent / "BENCHMARK.json").read_text())


def tiny_options(cell, seed: int, seconds: float = 0.3, **kw) -> window.Options:
    tiny = cell.config["tiny"]
    args = {**tiny["args"], **kw.pop("args_override", {})}
    return window.Options(seed=seed, seconds=seconds, trace=kw.pop("trace", False),
                          device="cpu", args_override=args,
                          problem_override=tiny["problem"], chunk_steps=TEST_CHUNK, **kw)


def run_tiny(name: str, seed: int, bench_dir: Path = BENCH_DIR, **kw) -> dict:
    cell = load_cell(name, bench_dir)
    return window.run(cell, tiny_options(cell, seed, **kw), time.perf_counter(),
                      emit=lambda s: None)
