"""Faults planted under the timed path, to show that the output check
refuses them: wrappers of a case's step, used by the fault test and by
``calibrate.py``, never by a benchmark run.

- ``frozen``: a step that returns its fields unchanged (time and step
  count still advance, so the runner goes on);
- ``altered``: a step whose answer is altered where it is produced: one
  interior value of u moved by 1e-3 of the velocity scale.
"""

from __future__ import annotations

from torch import nn

FAULTS = ("frozen", "altered")


class FaultyStep(nn.Module):
    def __init__(self, step, fault: str, scale: float = 1.0):
        super().__init__()
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
        self.inner = step
        self.fault = fault
        self.scale = scale
        # what the chunk and the runner read of a step
        self.cfg = getattr(step, "cfg", None)
        self.device = getattr(step, "device", None)
        self.reads_host = getattr(step, "reads_host", True)

    @property
    def poisson(self):
        return getattr(self.inner, "poisson", None)

    def forward(self, state, cfl_scale):
        new, metrics = self.inner(state, cfl_scale)
        if self.fault == "frozen":
            return state._replace(t=new.t, step=new.step), metrics
        u = new.u.clone()
        ny, nx = u.shape
        u[ny // 2, nx // 3] += 1e-3 * self.scale
        return new._replace(u=u), metrics


def hook(fault: str, scale: float = 1.0):
    """An ``Options.step_hook`` that plants ``fault``."""
    return lambda step: FaultyStep(step, fault, scale)
