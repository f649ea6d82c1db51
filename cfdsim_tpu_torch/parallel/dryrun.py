"""Dry run of the distributed steps:

    python -m cfdsim_tpu_torch.parallel.dryrun --ranks 4 --device cpu [--topology 2x2]

The explicit half of the JAX package's ``__graft_entry__.dryrun_multichip``
on a grid of 8·max(py, px) cells a side: (2) the distributed red-black SOR
solve, (4) the collocated cavity step, (5) the MAC cavity step with the
pencil DCT projection, (6d) the heated cavity; each one call on the mesh,
held against the single-device solver or step from the same input (its
steps 1 and 3 are GSPMD and have no counterpart here). ``--device cuda``
(the default) runs one NCCL rank per card and needs ``--ranks`` cards;
``--device cpu`` runs gloo ranks on the CPU. Prints one JSON line per check
and exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cfdsim_tpu_torch.parallel.launch import spawn

# the largest |Δ| a check allows: float32 sums in another order
ATOL = 1e-5


def _dryrun(mesh):
    from cfdsim_tpu_torch.cases import heated_cavity, lid_cavity, lid_cavity_mac
    from cfdsim_tpu_torch.parallel import (
        block_state,
        gather_blocks,
        gather_state,
        local_block,
        make_cavity_explicit_step,
        make_cavity_mac_explicit_step,
        make_heated_cavity_explicit_step,
        make_sharded_poisson,
        shard_boussinesq_state,
        shard_trimmed_state,
        trim_boussinesq_state,
        trim_state,
    )
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, solve_poisson

    n = 8 * max(mesh.py, mesh.px)
    dev = mesh.device
    rows = []

    def diff(name, got, want, **fields):
        rows.append({"check": name, "max_abs_err": float((got - want).abs().max()),
                     "atol": ATOL, **fields})

    # 2) explicit halo-exchange red-black SOR
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((n, n)).astype(np.float32)
    rhs -= rhs.mean()
    h = 1.0 / n
    solve = make_sharded_poisson(mesh, h, h, iters=4)
    phi = gather_blocks(solve(torch.zeros_like(local_block(rhs, mesh)), local_block(rhs, mesh)),
                        mesh)
    want = solve_poisson(torch.zeros(n, n, device=dev), torch.from_numpy(rhs).to(dev), h, h,
                         PoissonConfig(method="rbsor", iters=4))
    diff("rbsor_solve", phi, want, n=n, sweeps=4)

    # 4) the explicit collocated step
    case = lid_cavity(n=n, Re=100.0, scheme="central",
                      poisson=PoissonConfig(method="rbsor", iters=8), device=dev)
    state, _ = make_cavity_explicit_step(case.cfg, mesh)(block_state(case.state, mesh), 1.0)
    ref, _ = case.step(case.state, 1.0)
    got = gather_state(state, mesh)
    diff("cavity_step", torch.stack([got.u, got.v]), torch.stack([ref.u, ref.v]), n=n)

    # 5) the explicit MAC step with the pencil DCT projection
    case = lid_cavity_mac(n=n, Re=100.0, poisson=PoissonConfig(method="dct"), device=dev)
    state, _ = make_cavity_mac_explicit_step(case.cfg, mesh)(
        shard_trimmed_state(trim_state(case.state), mesh), 1.0)
    ref, _ = case.step(case.state, 1.0)
    got = gather_state(state, mesh)
    diff("mac_cavity_step", torch.stack([got.u, got.v]),
         torch.stack([ref.u[:, :-1], ref.v[:-1, :]]), n=n)

    # 6d) the heated cavity (trimmed faces, θ halos, the pencil DCT)
    case = heated_cavity(n=n, Ra=1e4, device=dev)
    state, _ = make_heated_cavity_explicit_step(case.cfg, mesh)(
        shard_boussinesq_state(trim_boussinesq_state(case.state), mesh), 1.0)
    ref, _ = case.step(case.state, 1.0)
    got = gather_state(state, mesh)
    diff("heated_cavity_step", torch.stack([got.u, got.v, got.theta]),
         torch.stack([ref.u[:, :-1], ref.v[:-1, :], ref.theta]), n=n)
    return {"mesh": [mesh.py, mesh.px], "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--topology", default=None, help="PYxPX, e.g. 2x2 (default: most square)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one NCCL rank per card; cpu: gloo ranks")
    args = ap.parse_args(argv)
    topology = None if args.topology is None else tuple(int(k) for k in
                                                       args.topology.lower().split("x"))
    out = spawn(_dryrun, args.ranks, topology, device=args.device)
    ok = True
    for row in out["rows"]:
        row["ok"] = row["max_abs_err"] <= row["atol"]
        ok &= row["ok"]
        print(json.dumps({"mesh": out["mesh"], **row}), flush=True)
    print(json.dumps({"dryrun_ok": ok, "ranks": args.ranks, "mesh": out["mesh"],
                      "device": args.device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
