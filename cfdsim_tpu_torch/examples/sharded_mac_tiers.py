"""The staggered (MAC) solver tiers on a mesh of ranks
(``examples/sharded_mac_tiers.py`` of the JAX package).

Runs the distributed explicit steps of all three staggered tiers — 2D
uniform (exact distributed DCT projection), 2D wall-clustered stretched
(exact distributed fast diagonalization), and 3D (z local, distributed 3D
DCT) — each held against its single-device step (run on rank 0 after the
ranks' steps), and reports the post-projection divergence (float32
rounding across the mesh: the staggered tier's exactness survives the
decomposition).

The ranks start through ``parallel/launch.py::spawn``: ``--device cuda``
(the default) puts one NCCL rank on each card, ``--device cpu`` runs gloo
ranks. The report goes to ``<out>/report.json``.

Run: ``python -m cfdsim_tpu_torch.examples.sharded_mac_tiers [--steps 20]
[--device cpu --ranks 4]``.
"""

from __future__ import annotations

import argparse
import sys

from cfdsim_tpu_torch.examples._common import add_rank_args, ranks_of, write_report


def _tiers(mesh, steps: int) -> dict:
    """Each tier's distributed steps, gathered; rank 0 then runs the
    single-device steps and returns the rows."""
    from cfdsim_tpu_torch.cases import cavity3d_mac, cavity_stretched, lid_cavity_mac
    from cfdsim_tpu_torch.parallel import (
        gather_state,
        make_cavity3d_mac_explicit_step,
        make_cavity_mac_explicit_step,
        make_cavity_stretched_explicit_step,
        shard_trimmed_state,
        shard_trimmed_state3d,
        trim_state,
        trim_state3d,
    )
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

    dev = mesh.device
    rows = []

    def drive(name, case, step_ex, blocks, trim):
        for _ in range(steps):
            blocks, m = step_ex(blocks, 1.0)
        got = gather_state(blocks, mesh)
        if mesh.rank != 0:
            return
        r = case.state
        for _ in range(steps):
            r, _ = case.step(r, 1.0)
        err = float((got.u - trim(r).u).abs().max())
        rows.append({"tier": name, "max_abs_err": err, "div_post": float(m.div_post),
                     "ranks": mesh.size})

    case = lid_cavity_mac(n=64, Re=400.0, scheme="tvd", poisson=PoissonConfig(method="dct"),
                          device=dev)
    drive("2D MAC (DCT)", case, make_cavity_mac_explicit_step(case.cfg, mesh),
          shard_trimmed_state(trim_state(case.state), mesh), trim_state)
    case = cavity_stretched(n=64, Re=400.0, beta=1.5, device=dev)
    drive("2D stretched (FDM)", case, make_cavity_stretched_explicit_step(
        case.cfg, mesh, case.extras["x_faces"], case.extras["y_faces"]),
        shard_trimmed_state(trim_state(case.state), mesh), trim_state)
    case = cavity3d_mac(n=16, Re=100.0, device=dev)
    drive("3D MAC (3D DCT)", case, make_cavity3d_mac_explicit_step(case.cfg, mesh),
          shard_trimmed_state3d(trim_state3d(case.state), mesh), trim_state3d)
    return {"mesh": [mesh.py, mesh.px], "backend": mesh.backend, "rows": rows}


def main(argv=None) -> dict:
    from cfdsim_tpu_torch.parallel.launch import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    add_rank_args(ap, "out/sharded_mac_tiers")
    args = ap.parse_args(argv)
    ranks, topology = ranks_of(args)
    out = spawn(_tiers, ranks, topology, args.steps, device=args.device)
    print(f"mesh: {out['mesh']} on {out['backend']}")
    for r in out["rows"]:
        print(f"{r['tier']:24s} max|Δ| vs single-device = {r['max_abs_err']:.2e}   "
              f"div_post = {r['div_post']:.2e}   ranks = {r['ranks']}")
    report = {"steps": args.steps, "device": args.device, **out}
    write_report(args.out, report)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
