"""An 8192² lid-driven MAC cavity on a mesh of ranks
(``examples/sharded_8192.py`` of the JAX package).

The production multi-rank path — the explicit MAC step, halo exchanges,
the distributed pencil all-to-all DCT projection — run at 8192² cells
(the same code path the tier-1 equality tests pin at small sizes,
``tests/test_torch_mac_explicit.py``). Each step prints dt, the
post-projection divergence, the energy and the largest speed from rank 0;
the run passes when the state is finite, div_post stays under 3e-4·(n/512)²
(the float32 projection residual grows as n² at fixed precision) and the
largest speed under 1.05.

The ranks start through ``parallel/launch.py::spawn``: ``--device cuda``
(the default) puts one NCCL rank on each card (at 8192² one card holds
the whole state), ``--device cpu`` runs gloo ranks (the JAX driver's 8
virtual devices: ``--ranks 8``, about 10 GB of host memory). The result is
printed as one JSON line and written to ``<out>/report.json``; the exit
code is 0 when it passes.

Run: ``python -m cfdsim_tpu_torch.examples.sharded_8192 [--n 8192]
[--steps 3] [--device cpu --ranks 8]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from cfdsim_tpu_torch.examples._common import add_rank_args, ranks_of, write_report


def _run(mesh, n: int, steps: int) -> dict:
    from cfdsim_tpu_torch.cases import lid_cavity_mac
    from cfdsim_tpu_torch.parallel import (
        make_cavity_mac_explicit_step,
        shard_trimmed_state,
        trim_state,
    )
    from cfdsim_tpu_torch.parallel.mesh import pmax
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    case = lid_cavity_mac(n=n, Re=1000.0, scheme="central",
                          poisson=PoissonConfig(method="dct", dct_variant="rfft"),
                          compute_metrics=True, device=mesh.device)
    if mesh.rank == 0:
        print(f"{n}x{n} cavity on mesh {mesh.py}x{mesh.px} ({n * n / 1e6:.0f}M cells, "
              f"{n * n * 4 / mesh.size / 1e9:.2f} GB/rank for p)", flush=True)
    step = make_cavity_mac_explicit_step(case.cfg, mesh)
    t = shard_trimmed_state(trim_state(case.state), mesh)
    del case
    t0 = time.perf_counter()
    m = None
    for i in range(steps):
        t, m = step(t, 1.0)
        if mesh.rank == 0:
            print(f"  step {i + 1}: dt={float(m.dt):.3e}  "
                  f"div_post={float(m.div_post):.3e}  "
                  f"energy={float(m.energy):.6e}  "
                  f"max_vel={float(m.max_vel):.4f}  "
                  f"[{time.perf_counter() - t0:6.1f}s elapsed]", flush=True)
    finite = float(pmax(sum((~x.isfinite()).any().float() for x in (t.u, t.v, t.p)), mesh))
    ok = (finite == 0.0
          and float(m.div_post) < 3e-4 * (n / 512) ** 2
          and float(m.max_vel) <= 1.05)
    return {"metric": f"sharded_{n}sq_demo", "ok": ok, "steps": steps,
            "div_post": float(m.div_post), "energy": float(m.energy),
            "max_vel": float(m.max_vel), "ranks": mesh.size,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    from cfdsim_tpu_torch.parallel.launch import spawn

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--steps", type=int, default=3)
    add_rank_args(p, "out/sharded_8192")
    a = p.parse_args(argv)
    ranks, topology = ranks_of(a)
    result = spawn(_run, ranks, topology, a.n, a.steps, device=a.device,
                   timeout_s=3600.0)
    print(json.dumps(result))
    write_report(a.out, {"device": a.device, **result})
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
