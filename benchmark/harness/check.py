"""The output check: what the timed path produced, against the plain
reference (``reference/flow2d.py``).

The program runs chunks of steps; a chunk's answer is its end state and
the per-step diagnostics it hands the runner. The reference carries its
own state from the stated start through set-up's chunks and the window's
first chunk, and follows each chunk sampled later in the window from the
program's state before it (it cannot follow the window's 10^4 to 10^5
steps; the chain checks the start and the stage this skips). Three
numbers measure how far the program's answer lies from the reference's:

- ``vel_gap``: the largest |Δu| or |Δv| over the grid, over the largest
  reference speed;
- ``gradp_gap``: the largest difference of the pressure's gradient (the
  corrector's central differences, either component) over the reference's
  largest gradient component. The step reads p only through this
  gradient; p itself is fixed only up to a constant by the Neumann
  problem, and an unconverged multigrid leaves smooth modes in it that the
  gradient scarcely sees and the largest |Δp| swings with;
- ``diag_gap``: over the diagnostics that describe the flow (dt, the
  largest speed, kinetic energy, largest vorticity, divergence before the
  projection, the body's force), the largest |Δ| over the chunk's steps,
  each over that diagnostic's largest reference value in the chunk (the
  force's two components over the larger of the two).

Each is the worst over the compared chunks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.flow2d import METRICS, gradient

DIAGNOSTICS = ("dt", "max_vel", "energy", "vort_max", "div_pre", "fx", "fy")
NUMBERS = ("vel_gap", "gradp_gap", "diag_gap")
# the body's force is judged by its magnitude: its cross-stream part is
# near zero while the wake is symmetric, and rounding alone moves it
SCALED_TOGETHER = {"fx": ("fx", "fy"), "fy": ("fx", "fy")}


def _largest(x) -> float:
    return x.to(torch.float64).abs().amax().item()


def _grad_gap(p, ref_p, spacing) -> float:
    dx, dy = spacing
    got = gradient(p.to(torch.float64), dx, dy)
    want = gradient(ref_p.to(torch.float64), dx, dy)
    diff = max(_largest(g - w) for g, w in zip(got, want))
    return _ratio(diff, max(_largest(w) for w in want))


def _ratio(diff: float, scale: float) -> float:
    if not math.isfinite(diff):
        return math.inf
    return diff / scale if scale > 0 else diff


def chunk_gaps(answer: dict, ref: dict, spacing: tuple) -> dict:
    """The three numbers for one chunk. Each side is a dict with ``u``,
    ``v``, ``p`` (tensors) and ``metrics``, a (steps, len(METRICS)) array
    in METRICS order; ``spacing`` is the grid's (dx, dy)."""
    speed = max(_largest(ref["u"]), _largest(ref["v"]))
    dvel = max(_largest(answer[k].to(torch.float64) - ref[k].to(torch.float64)) for k in "uv")
    diag = 0.0
    for name in DIAGNOSTICS:
        k = METRICS.index(name)
        scale = max(float(np.max(np.abs(ref["metrics"][:, METRICS.index(n)])))
                    for n in SCALED_TOGETHER.get(name, (name,)))
        if scale == 0.0:
            continue
        d = float(np.max(np.abs(answer["metrics"][:, k] - ref["metrics"][:, k])))
        diag = max(diag, _ratio(d, scale))
    return {"vel_gap": _ratio(dvel, speed),
            "gradp_gap": _grad_gap(answer["p"], ref["p"], spacing), "diag_gap": diag}


def worst(readings: list[dict]) -> dict:
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def follow(flow, chunks: list, perturbation, steps: int) -> list[dict]:
    """``flow`` (a ``ReferenceFlow``) run over each compared chunk: a chunk
    whose ``pre`` is None continues the flow's own state, carried from its
    stated start through the chunks before it; any other starts from
    ``pre``, the program's state before the chunk. Returns each chunk's end
    ``u``, ``v``, ``p`` and ``metrics``."""
    out, carried = [], None
    for c in chunks:
        if c["pre"] is None:
            start = carried if carried is not None else flow.initial_state(perturbation)
        else:
            pre = c["pre"]
            start = {"u": pre.u.to(flow.dtype), "v": pre.v.to(flow.dtype),
                     "p": pre.p.to(flow.dtype), "t": pre.t.to(flow.dtype),
                     "step": int(pre.step)}
        state, metrics = flow.run(start, steps, c["cfl"])
        if c["pre"] is None:
            carried = state
        out.append({"u": state["u"], "v": state["v"], "p": state["p"], "metrics": metrics})
    return out


def program_answer(chunk: dict) -> dict:
    post = chunk["post"]
    return {"u": post.u, "v": post.v, "p": post.p, "metrics": chunk["metrics"]}
