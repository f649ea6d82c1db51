"""Run one cell of the benchmark once and print its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json`` and the
program (``cfdsim_tpu_torch``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers end
standard error. Earlier lines give the peak device memory, the steps and
chunks of the window, set-up's seconds by phase and, with ``--trace 1``,
the card's clocks and power sampled beside the window.

Exits non-zero without printing a result where there is no CUDA card or
fewer cards than the cell asks for, where the program or a cell's file is
missing, and where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the program builds its kernels into ``build/cfdsim_tpu_torch/`` there
    itself; the libraries' caches are pointed there too."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CFDSIM_AUTOTUNE_CACHE", str(ROOT / "build" / "cfdsim_tpu_torch"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _cache_dirs()
    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(ROOT))
    import torch

    marks = {"torch_imported": time.perf_counter()}
    from harness import window
    from harness.cells import load_cell

    try:
        import cfdsim_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    marks["program_imported"] = time.perf_counter()
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the program on a card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2

    torch.zeros(1, device="cuda")  # the CUDA context, timed on its own
    torch.cuda.synchronize()
    marks["cuda_ready"] = time.perf_counter()
    opts = window.Options(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                          marks=marks)
    result = window.run(cell, opts, PROCESS_T0, emit=lambda s: print(s, flush=True))

    found = window.loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
