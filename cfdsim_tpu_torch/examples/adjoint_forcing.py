"""Adjoint inverse problem: recover a hidden body force from the flow
(``examples/adjoint_forcing.py`` of the JAX package).

The MAC step is plain differentiable torch, so PDE-constrained
optimisation is ``loss.backward()`` through the time loop, checkpointed
per step (``torch.utils.checkpoint``, non-reentrant: memory stays about
one step's activations):

1. drive the free-slip [0, π]² box with the "hidden" body force
   f_u(y) = Σ_k c_k sin((k+1)·y), true c = [1, 0, 0.5, 0], for N steps
   at a fixed dt, and record the final velocity: the observation;
2. from c = 0, minimise ‖u_N(c) − u_obs‖² + ‖v_N(c) − v_obs‖² (means)
   with ``torch.optim.Adam``, each evaluation re-running the N steps and
   differentiating back through them;
3. report the recovered coefficients.

Run: ``python -m cfdsim_tpu_torch.examples.adjoint_forcing [--n 48]
[--steps 200] [--iters 60] [--lr 0.1] [--device cuda]``; exits 0 when the
largest coefficient error is under 0.05. The time loop is this module's
own Python loop of step calls; a captured chunk (``make_chunk``'s graph
route) cannot be differentiated and refuses a step whose forcing requires
grad.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from cfdsim_tpu_torch.grid import Grid
from cfdsim_tpu_torch.models import mac
from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

C_TRUE = (1.0, 0.0, 0.5, 0.0)


class Problem(NamedTuple):
    """``step(c)`` is the MAC step forced by the coefficients ``c``;
    ``simulate(c)`` runs the N forced steps from rest and returns the final
    (u, v); ``loss(c)`` is the misfit to the observation made with the true
    coefficients."""

    step: Callable
    simulate: Callable
    loss: Callable


def make_problem(n: int = 48, n_steps: int = 200, *, device) -> Problem:
    """The control problem on an n² box over ``n_steps`` steps. The metrics
    are off: the loss reads the state only."""
    cfg = mac.MACConfig(
        grid=Grid(nx=n, ny=n, x_max=np.pi, y_max=np.pi, centering="cell"),
        nu=0.02,
        adaptive_dt=False,  # a fixed dt keeps the control problem smooth
        dt_base=2e-3,
        poisson=PoissonConfig(method="dct"),
        compute_metrics=False,
    )
    bcs = mac.free_slip_bcs()
    yu = (np.arange(n) + 0.5) * (np.pi / n)  # the u-faces' y coordinates
    modes = torch.tensor(np.stack([np.sin((k + 1) * yu) for k in range(4)]),
                         dtype=torch.float32, device=device)  # (4, ny)
    fv = torch.zeros((n + 1, n), dtype=torch.float32, device=device)

    def forced_step(coeffs):
        fu = torch.einsum("k,ky->y", coeffs, modes)[:, None] * torch.ones(
            (n, n + 1), dtype=torch.float32, device=device)
        return mac.make_step(cfg, bcs, forcing=(fu, fv), device=device)

    def simulate(coeffs):
        step = forced_step(coeffs)

        def body(s):
            return step(s, 1.0)[0]

        s = mac.init_state(cfg, device=device)
        for _ in range(n_steps):
            s = checkpoint(body, s, use_reentrant=False) if coeffs.requires_grad else body(s)
        return s.u, s.v

    with torch.no_grad():
        u_obs, v_obs = simulate(torch.tensor(C_TRUE, dtype=torch.float32, device=device))

    def loss(c):
        u, v = simulate(c)
        return torch.mean((u - u_obs) ** 2) + torch.mean((v - v_obs) ** 2)

    return Problem(forced_step, simulate, loss)


def main(n: int = 48, n_steps: int = 200, iters: int = 60, lr: float = 0.1,
         verbose: bool = True, device="cuda") -> float:
    """Recover the coefficients; returns the largest error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass --device cpu)")
    loss = make_problem(n, n_steps, device=device).loss
    c = torch.zeros(4, dtype=torch.float32, device=device, requires_grad=True)
    opt = torch.optim.Adam([c], lr=lr)
    t0 = time.perf_counter()
    for it in range(iters):
        opt.zero_grad()
        val = loss(c)
        val.backward()
        opt.step()
        if verbose and (it % 10 == 0 or it == iters - 1):
            print(f"  iter {it:3d}  loss {val.item():.3e}  "
                  f"c = {np.round(c.detach().cpu().numpy(), 4).tolist()}", flush=True)
    err = float((c.detach().cpu() - torch.tensor(C_TRUE)).abs().max())
    if verbose:
        print(f"recovered c = {np.round(c.detach().cpu().numpy(), 4).tolist()} "
              f"(true {list(C_TRUE)}); max err {err:.2e}; {iters} adjoint solves of "
              f"{n_steps} steps in {time.perf_counter() - t0:.1f} s on {device}", flush=True)
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Recover a hidden forcing by adjoint descent.")
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    err = main(n=args.n, n_steps=args.steps, iters=args.iters, lr=args.lr, device=args.device)
    sys.exit(0 if err < 0.05 else 1)
