"""Numerical sanitizers and debug instrumentation (``cfdsim_tpu.utils.debug``).

The JAX package's three tools, each in the nearest PyTorch idiom:

- ``enable_nan_checks()``: JAX's global ``jax_debug_nans`` flag. PyTorch has
  no such flag for forward code (``torch.autograd.set_detect_anomaly`` only
  watches backward passes), so this pushes a ``TorchFunctionMode`` that
  checks every floating result of every torch call and raises
  ``FloatingPointError`` at the call that first produces a non-finite
  value. It reads the host after every call: a sanitizer for development
  runs on the CPU or through the eager loop, not under a graph capture.
- ``nan_watch(step_fn, name)``: JAX's ``jax.debug.callback`` watchdog. The
  wrapper reduces the finiteness of every float leaf of the new state on
  the device, reads the one flag on the host and logs the step index; the
  run continues. Because it reads the host it sets ``reads_host = True``,
  so a chunk of watched steps takes the loop route.
- ``checked(step_fn)``: JAX's ``checkify`` with ``float_checks``. The
  wrapper runs the step under the same mode as ``enable_nan_checks`` and
  returns ``(error, (state, metrics))`` with ``error`` the
  ``FloatingPointError`` or ``None``: errors as data. ``(state, metrics)``
  is ``None`` when the step raised.
"""

from __future__ import annotations

import logging
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode

from cfdsim_tpu_torch.utils.tree import leaves

log = logging.getLogger("cfdsim_tpu_torch.debug")


class NanCheckMode(TorchFunctionMode):
    """Raise ``FloatingPointError`` at the first torch call whose result
    holds a non-finite float."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        results = out if isinstance(out, (tuple, list)) else (out,)
        for x in results:
            if torch.is_tensor(x) and x.is_floating_point() and not bool(
                    torch.isfinite(x).all()):
                name = getattr(func, "__qualname__", None) or getattr(func, "__name__", func)
                raise FloatingPointError(f"non-finite value produced by {name}")
        return out


_active_mode = None


def enable_nan_checks(enable: bool = True) -> None:
    """Make every torch call fail loudly at the first non-finite value it
    produces (process-wide, like the JAX flag), or stop doing so."""
    global _active_mode
    if enable and _active_mode is None:
        _active_mode = NanCheckMode()
        _active_mode.__enter__()
    elif not enable and _active_mode is not None:
        _active_mode.__exit__(None, None, None)
        _active_mode = None


def _tree_finite(tree) -> torch.Tensor:
    flags = [torch.isfinite(x).all() for x in leaves(tree)
             if torch.is_tensor(x) and x.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.tensor(True)


class NanWatch:
    """See :func:`nan_watch`."""

    reads_host = True

    def __init__(self, step_fn: Callable, name: str = "step"):
        self.step_fn = step_fn
        self.name = name
        self.cfg = getattr(step_fn, "cfg", None)
        self.device = getattr(step_fn, "device", None)

    def __call__(self, state, *args):
        new_state, metrics = self.step_fn(state, *args)
        if not bool(_tree_finite(new_state)):
            log.error("%s: non-finite state detected at step %s", self.name,
                      int(new_state.step))
        return new_state, metrics


def nan_watch(step_fn: Callable, name: str = "step") -> Callable:
    """Wrap ``step(state, *args) -> (state, metrics)`` with a non-finite
    watchdog: when any float leaf of the new state goes non-finite, the
    step index is logged (the run continues; pair with the runner's health
    monitor to stop)."""
    return NanWatch(step_fn, name)


def checked(step_fn: Callable) -> Callable:
    """The step with float checks on: returns ``(error, (state, metrics))``;
    ``error`` is ``None`` or the ``FloatingPointError`` naming the first
    call that produced a non-finite value (raise it on the host to surface
    it)."""

    def wrapped(state, *args):
        try:
            with NanCheckMode():
                return None, step_fn(state, *args)
        except FloatingPointError as err:
            return err, None

    wrapped.reads_host = True
    return wrapped
