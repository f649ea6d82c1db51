"""Readings from which a cell's output-check limits are set.

    python benchmark/calibrate.py --workload <cell> --seeds 11 12 13 \\
        [--seconds 3] [--controls program_bf16 reference_bf16] [--faults frozen altered] \\
        [--witness]

For each seed, one short window of the program at the cell's own size,
judged against the float32 reference: the program itself (the lower
reading, with the largest pressure gap as it is and less the means,
``p_max_gap`` and ``p_mean_free_gap``, for the look at what moves the
pressure); the control (the upper reading): ``program_bf16``, the program's
own lower-precision path (u and v stored in bfloat16 between steps, the
precision below the configuration's float32), run on the same seed, and
``reference_bf16``, the reference computed in bfloat16 in the program's
place over the program's compared chunks; and, with ``--faults``, the
program with each planted fault (``harness/faults.py``); with
``--witness``, the reference in float64 over the same chunks, set against
the float32 reference and against the program. One JSON line per seed and
judge on standard output. A benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
# the program's own lower-precision path: u and v kept in bfloat16 between
# steps (float32 inside a step), the configuration's float32 one step down
PROGRAM_BF16 = {"storage": "bf16"}
ROOT = BENCH_DIR.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", nargs="*", default=["program_bf16"],
                   choices=["program_bf16", "reference_bf16"])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--witness", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    sys.path.insert(0, str(BENCH_DIR))
    sys.path.insert(1, str(ROOT))
    import torch

    from harness import check, faults, window
    from harness.cells import load_cell
    from reference.flow2d import ReferenceFlow, spacing

    cell = load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    quiet = lambda s: None  # noqa: E731
    for seed in args.seeds:
        opts = window.Options(seed=seed, seconds=args.seconds, trace=False, device=args.device)
        out = window.measure(cell, opts, time.perf_counter(), emit=quiet)
        chunks = window.compared(out)
        t0 = time.perf_counter()
        flow = ReferenceFlow(out.problem, args.device, torch.float32)
        refs = check.follow(flow, chunks, out.perturbation, out.chunk_steps)
        ref_s = time.perf_counter() - t0
        h = spacing(out.problem)
        prog = [{**check.chunk_gaps(check.program_answer(c), r, h), "index": c["index"],
                 **_pressure_look(c["post"].p, r["p"])} for c, r in zip(chunks, refs)]
        print(json.dumps({"cell": cell.name, "seed": seed, "judge": "program",
                          "stopped": out.stopped, "chunks": out.chunks,
                          "reference_s": ref_s, "per_chunk": prog, **check.worst(prog)}),
              flush=True)
        if "reference_bf16" in args.controls:
            low = ReferenceFlow(out.problem, args.device, torch.bfloat16)
            ctrl = check.follow(low, chunks, out.perturbation, out.chunk_steps)
            gaps = [check.chunk_gaps(a, r, h) for a, r in zip(ctrl, refs)]
            print(json.dumps({"cell": cell.name, "seed": seed, "judge": "control_reference_bf16",
                              "per_chunk": gaps, **check.worst(gaps)}), flush=True)
        if args.witness:
            wide = ReferenceFlow(out.problem, args.device, torch.float64)
            w = check.follow(wide, chunks, out.perturbation, out.chunk_steps)
            ref_vs = [{**check.chunk_gaps(r, x, h), **_pressure_look(r["p"], x["p"])}
                      for r, x in zip(refs, w)]
            prog_vs = [{**check.chunk_gaps(check.program_answer(c), x, h),
                        **_pressure_look(c["post"].p, x["p"])} for c, x in zip(chunks, w)]
            print(json.dumps({"cell": cell.name, "seed": seed, "judge": "witness_float64",
                              "reference32_vs_64": ref_vs, "program_vs_64": prog_vs}), flush=True)
            del wide, w
        del out, chunks, refs, flow
        if "program_bf16" in args.controls:
            copts = window.Options(seed=seed, seconds=args.seconds, trace=False,
                                   device=args.device, args_override=PROGRAM_BF16)
            cout = window.measure(cell, copts, time.perf_counter(), emit=quiet)
            readings, worst = window.judge(cout, args.device)
            print(json.dumps({"cell": cell.name, "seed": seed, "judge": "control_program_bf16",
                              "stopped": cout.stopped, "per_chunk": readings, **worst}),
                  flush=True)
        for fault in args.faults:
            fopts = window.Options(seed=seed, seconds=args.seconds, trace=False,
                                   device=args.device,
                                   step_hook=faults.hook(fault, cell.config["velocity_scale"]))
            fout = window.measure(cell, fopts, time.perf_counter(), emit=quiet)
            readings, worst = window.judge(fout, args.device)
            print(json.dumps({"cell": cell.name, "seed": seed, "judge": f"fault_{fault}",
                              "stopped": fout.stopped, **worst}), flush=True)
    return 0


def _pressure_look(p, ref_p) -> dict:
    """The largest |Δp| over the largest |p|, as it is and with each
    field less its mean."""
    p, ref_p = p.double(), ref_p.double()
    out = {}
    for name, a, b in (("p_max_gap", p, ref_p),
                       ("p_mean_free_gap", p - p.mean(), ref_p - ref_p.mean())):
        out[name] = ((a - b).abs().amax() / b.abs().amax()).item()
    return out


if __name__ == "__main__":
    sys.exit(main())
