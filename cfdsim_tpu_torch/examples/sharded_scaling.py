"""Multi-rank scaling demo (``examples/sharded_scaling.py`` of the JAX
package).

Runs the same lid-driven cavity single-device and distributed over meshes
of 2, 4 and every rank, checks the physics agree, and reports each
configuration's time for ``steps`` steps (the second of two runs from the
same state: the first builds kernels, plans and groups).

As the JAX driver, it shards the case's step with ``make_sharded_step``
on ``shard_state`` blocks (``parallel/sharded.py``): here that is the
explicit collocated step (``parallel/explicit.py``) with the case's
default DCT projection through the pencil transforms, where the JAX
driver jits the single-device step under GSPMD. Each mesh is its own group of ranks through
``parallel/launch.py::spawn``: ``--device cuda`` (the default) one NCCL
rank per card, ``--device cpu`` gloo ranks. The single-device run is a
``make_chunk`` chunk (one captured CUDA graph on the card), the
distributed one its loop route. The report goes to ``<out>/report.json``.

Run: ``python -m cfdsim_tpu_torch.examples.sharded_scaling [--n 256]
[--steps 20] [--device cpu --ranks 4]``.
"""

from __future__ import annotations

import argparse
import sys
import time

from cfdsim_tpu_torch.examples._common import (
    add_rank_args,
    device_of,
    ranks_of,
    write_report,
)


def _case(n: int, device):
    from cfdsim_tpu_torch.cases import lid_cavity

    return lid_cavity(n=n, Re=1000.0, device=device)


def _timed(chunk, state):
    """The chunk twice from ``state``: (the second run's state, its seconds)."""
    import torch

    def once():
        out, _ = chunk(state, 1.0)
        float(out.t)  # the barrier: one host read
        return out

    once()
    if torch.device(state.t.device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = once()
    return out, time.perf_counter() - t0


def _distributed(mesh, n: int, steps: int) -> dict:
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.parallel import gather_blocks, make_sharded_step, shard_state

    case = _case(n, mesh.device)
    step = make_sharded_step(case.step, mesh)
    out, seconds = _timed(make_chunk(case.cfg, step, steps), shard_state(case.state, mesh))
    return {"mesh": [mesh.py, mesh.px], "seconds": seconds,
            "u": gather_blocks(out.u, mesh).cpu()}


def main(argv=None) -> dict:
    from cfdsim_tpu_torch.models.incompressible import make_chunk
    from cfdsim_tpu_torch.parallel.launch import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    add_rank_args(ap, "out/sharded_scaling", "the largest mesh (default: the cards, or 4 "
                  "gloo ranks)")
    args = ap.parse_args(argv)
    n_dev, _ = ranks_of(args)
    n, steps = args.n, args.steps
    device = device_of(args.device)
    print(f"ranks: {n_dev} × {device.type}")

    rows = []

    def row(label, seconds, **extra):
        print(f"{label:24s} {steps} steps: {seconds * 1e3:8.1f} ms "
              f"({n * n * steps / seconds / 1e6:8.1f} Mcell-upd/s)")
        rows.append({"config": label, "seconds": seconds,
                     "mcell_updates_per_s": n * n * steps / seconds / 1e6, **extra})

    case = _case(n, device)
    ref, seconds = _timed(make_chunk(case.cfg, case.step, steps), case.state)
    row("single-device", seconds)
    ref_u = ref.u.cpu()
    for nd in sorted({2, 4, n_dev} & set(range(1, n_dev + 1))):
        out = spawn(_distributed, nd, None, n, steps, device=args.device)
        err = float((out["u"] - ref_u).abs().max())
        row(f"mesh {out['mesh'][0]}x{out['mesh'][1]}", out["seconds"], max_abs_du=err)
        print(f"{'':24s} max |Δu| vs single-device: {err:.2e}")
    report = {"n": n, "steps": steps, "device": args.device, "rows": rows}
    write_report(args.out, report)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
