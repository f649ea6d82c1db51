"""bf16 inter-step velocity storage, measured
(``examples/bf16_storage_bench.py`` of the JAX package).

``storage="bf16"`` keeps u and v in bfloat16 between steps, which halves
the state's bytes in every pass that reads it, while the stencils and the
Poisson solve compute in float32. This driver measures marginal cell
updates per second between a 100- and a 600-step chunk (``bench.py``'s
method: the constant of a call cancels) for ``storage="fp32"`` and
``"bf16"`` on the collocated (1024² and up through the fused predictor)
and MAC cavities at each ``--n``, and prints one JSON row per (tier, n,
storage), the JAX metric names, then the ratio. Accuracy is a separate,
long run (``cavity_accuracy_1024``'s ``storage`` argument): throughput
alone does not make bf16 the default.

Beyond the JAX driver's ``--n`` and ``--tiers``: ``--device`` (default
``cuda``; exits without it).

Run: ``python -m cfdsim_tpu_torch.examples.bf16_storage_bench [--n 1024 4096]
[--tiers collocated mac] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cfdsim_tpu_torch.examples._common import device_of


def bench_case(tier: str, n: int, storage: str, *, device="cuda"):
    """The 1000-Re cavity of ``tier`` ("collocated": the DCT with
    ``dct_variant="auto"`` and, at n ≥ 1024, the fused predictor; "mac":
    the DCT) at n² with ``storage``, metrics off: the bench's cell."""
    from cfdsim_tpu_torch.cases import lid_cavity, lid_cavity_mac
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    if tier == "collocated":
        return lid_cavity(n=n, Re=1000.0, poisson=PoissonConfig(method="dct", dct_variant="auto"),
                          compute_metrics=False, fused_predictor=n >= 1024, storage=storage,
                          device=device)
    if tier == "mac":
        return lid_cavity_mac(n=n, Re=1000.0, poisson=PoissonConfig(method="dct"),
                              compute_metrics=False, storage=storage, device=device)
    raise ValueError(f"unknown tier {tier!r}: collocated or mac")


def measure(tier, n, storage, short=100, long=600, *, device="cuda") -> float:
    """Marginal cells/s of :func:`bench_case` between a ``short`` and a
    ``long`` chunk; the long chunk's u must be finite."""
    from cfdsim_tpu_torch.bench import _timed_chunk

    case = bench_case(tier, n, storage, device=device)
    t1, _, _ = _timed_chunk(case, case.state, short)
    t2, sl, _ = _timed_chunk(case, case.state, long)
    if not bool(torch.isfinite(sl.u.float()).all()):
        raise RuntimeError(f"{tier}{n} {storage}: non-finite u after {long} steps")
    return n * n * (long - short) / (t2 - t1)


def main(sizes=(1024, 4096), tiers=("collocated", "mac"), *, device="cuda", short=100,
         long=600):
    """[(tier, n, {storage: cells/s})], one JSON row printed per measurement."""
    rows = []
    for tier in tiers:
        for n in sizes:
            r = {}
            for storage in ("fp32", "bf16"):
                cups = measure(tier, n, storage, short, long, device=device)
                r[storage] = cups
                print(json.dumps({"metric": f"cells_per_sec_{tier}{n}_{storage}",
                                  "value": cups, "unit": "cells/s"}), flush=True)
            rows.append((tier, n, r))
            print(f"  {tier}{n}: bf16/fp32 = {r['bf16'] / r['fp32']:.3f}x", flush=True)
    print("\nRESULT bf16_storage_bench")
    for tier, n, r in rows:
        print(f"  {tier:10s} {n:5d}  fp32 {r['fp32']:.3e}  bf16 {r['bf16']:.3e}  "
              f"ratio {r['bf16'] / r['fp32']:.3f}")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[1024, 4096])
    p.add_argument("--tiers", nargs="+", default=["collocated", "mac"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without CUDA pass --device cpu")
    a = p.parse_args()
    main(a.n, a.tiers, device=device_of(a.device))
    sys.exit(0)
