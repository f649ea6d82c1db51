"""Simulation runner: chunked on-device stepping with host-side control
(``cfdsim_tpu.runner``).

A chunk is ``chunk_steps`` steps, built once by
``models/incompressible.py::make_chunk``: on a CUDA device one captured
device program (a CUDA graph, as the JAX runner's chunk is one jitted
``lax.scan``), on the CPU, or for a step that reads the host, a Python loop
of step calls. Between chunks the host reads the per-step metric scalars,
stacked on the device and copied over in one transfer, to do health checks,
CFL back-off (a new value in the chunk's cfl buffer: no new capture),
snapshots, progress, logging and the wall-clock kill switch. Fields cross
to the host only at snapshot boundaries, between chunks, from the runner's
own state (the chunk hands back copies of its static buffers), never from
inside a captured program. States and metrics may be nested NamedTuples
(``utils/tree.py``). :func:`run_on_device` runs to ``t_final`` with one
host read per chunk and no other host control.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from torch import nn

from cfdsim_tpu_torch.models.incompressible import make_chunk
from cfdsim_tpu_torch.monitor import check_metrics
from cfdsim_tpu_torch.utils.profiling import PerfTracker
from cfdsim_tpu_torch.utils.tree import leaves, rebuild, tree_map


@dataclasses.dataclass
class RunnerConfig:
    """Host-loop configuration: the JAX package's fields and defaults."""

    t_final: float = 1.0
    max_steps: int = 10_000_000
    chunk_steps: int = 50
    snapshot_interval: int = 0  # steps between snapshots; 0 = off
    health_check: bool = True
    max_velocity: float = 1e3
    div_threshold: float = 5.0
    warmup_div_threshold: float = 20.0
    warmup_steps: int = 1000
    on_unhealthy: str = "stop"  # "stop" | "backoff" (CFL × cfl_backoff)
    cfl_backoff: float = 0.8
    cfl_scale_min: float = 0.1
    wall_clock_limit_s: float = 0.0  # 0 = unlimited
    log_every_chunks: int = 10
    progress: bool = False  # tqdm bar keyed on simulated time
    log_memory: bool = False  # psutil RSS in the periodic log


class Simulation:
    """Drives ``step_fn(state, cfl_scale) -> (state, metrics)`` to t_final."""

    def __init__(
        self,
        step_fn: Callable,
        state,
        cfg: RunnerConfig,
        n_cells: int,
        snapshot_fn: Optional[Callable] = None,
        logger: Optional[logging.Logger] = None,
        health_fn: Optional[Callable] = None,
    ):
        # snapshot_fn(state, step, t) is called between chunks with the
        # runner's own state; health_fn(metrics_host, step) -> HealthReport
        # overrides the default incompressible check
        self.step_fn = step_fn
        self.cfg = cfg
        self.state = state
        self.snapshot_fn = snapshot_fn
        self.health_fn = health_fn
        self.device = state.t.device
        self.log = logger or logging.getLogger("cfdsim_tpu_torch")
        self.perf = PerfTracker(n_cells=n_cells, device=self.device)
        self.cfl_scale = 1.0
        self.metrics_history: list = []
        self.stopped_reason = ""
        self.chunk = make_chunk(getattr(step_fn, "cfg", None), step_fn, cfg.chunk_steps,
                                device=self.device)

    def _chunk(self, cfl_scale: float):
        """Run one chunk; return its metrics stacked per field as numpy
        arrays, plus the simulated time, read in ONE device→host copy."""
        self.state, m = self.chunk(self.state, cfl_scale)
        flat = leaves(m)
        host = torch.cat([torch.stack(flat).reshape(-1),
                          self.state.t.reshape(1)]).cpu().numpy()
        return rebuild(m, host[:-1].reshape(len(flat), -1)), float(host[-1])

    def run(self):
        cfg = self.cfg
        t_start = time.perf_counter()
        step = int(self.state.step)
        t_now = float(self.state.t)
        next_snapshot = step
        if self.snapshot_fn and cfg.snapshot_interval > 0:
            self.snapshot_fn(self.state, step, t_now)
            next_snapshot = step + cfg.snapshot_interval

        pbar = None
        if cfg.progress:
            from tqdm import tqdm

            pbar = tqdm(total=cfg.t_final, desc="Simulation", unit="time", initial=t_now)

        chunk_idx = 0
        while True:
            if t_now >= cfg.t_final or step >= cfg.max_steps:
                break
            if cfg.wall_clock_limit_s > 0 and (
                time.perf_counter() - t_start > cfg.wall_clock_limit_s
            ):
                self.stopped_reason = "wall-clock limit"
                self.log.warning("Wall-clock limit reached; stopping.")
                break

            m_host, t_now = self._chunk(self.cfl_scale)
            step += cfg.chunk_steps
            self.perf.add_steps(cfg.chunk_steps)
            chunk_idx += 1
            if pbar is not None:
                pbar.update(min(t_now, cfg.t_final) - pbar.n)

            # host-side control: health, back-off, snapshots, logging
            hist = {
                "step": step,
                "t": t_now,
                "dt": float(m_host.dt[-1]),
                "energy": float(m_host.energy[-1]),
                "max_vel": float(np.max(m_host.max_vel)),
            }
            # the compressible and spectral metrics have no divergence
            if hasattr(m_host, "div_post"):
                hist["div_post"] = float(np.max(m_host.div_post))
            self.metrics_history.append(hist)
            if cfg.health_check:
                if self.health_fn is not None:
                    report = self.health_fn(m_host, step)
                else:
                    report = check_metrics(
                        m_host,
                        cfg.max_velocity,
                        cfg.div_threshold,
                        cfg.warmup_div_threshold,
                        cfg.warmup_steps,
                        step,
                    )
                if not report.ok:
                    if cfg.on_unhealthy == "backoff":
                        self.cfl_scale *= cfg.cfl_backoff
                        self.log.warning(
                            "Unhealthy (%s): reducing CFL scale to %.3f",
                            report.reason,
                            self.cfl_scale,
                        )
                        if self.cfl_scale < cfg.cfl_scale_min:
                            self.stopped_reason = (
                                f"minimum CFL reached after {report.reason}"
                            )
                            self.log.error("%s; stopping.", self.stopped_reason)
                            break
                    else:
                        self.stopped_reason = f"unhealthy: {report.reason}"
                        self.log.error(
                            "Simulation unstable (%s); stopping.", report.reason
                        )
                        break

            if self.snapshot_fn and cfg.snapshot_interval > 0 and step >= next_snapshot:
                self.snapshot_fn(self.state, step, t_now)
                next_snapshot += cfg.snapshot_interval

            if cfg.log_every_chunks and chunk_idx % cfg.log_every_chunks == 0:
                h = self.metrics_history[-1]
                self.log.info(
                    "step %d t=%.4f dt=%.2e div=%.3e E=%.4f speed=%.1f steps/s",
                    step,
                    h["t"],
                    h["dt"],
                    h.get("div_post", float("nan")),
                    h["energy"],
                    self.perf.steps_per_sec,
                )
                if cfg.log_memory:
                    import psutil

                    rss = psutil.Process().memory_info().rss / 1e6
                    self.log.info("host memory usage: %.1f MB", rss)

        if pbar is not None:
            pbar.close()
        report = self.perf.report()
        report["stopped_reason"] = self.stopped_reason
        report["final_time"] = t_now
        report["final_step"] = int(self.state.step)
        report["chunk_route"] = self.chunk.mode
        if "device_peak_bytes" in report:
            self.log.info(
                "device memory: peak %.1f MB / limit %.1f MB",
                report["device_peak_bytes"] / 1e6,
                report["device_bytes_limit"] / 1e6,
            )
        self.log.info("Performance report: %s", report)
        return self.state, report


class _UntilDone(nn.Module):
    """``step_fn`` made a no-op once ``t ≥ t_final`` or ``step ≥ max_steps``:
    the step runs, and a device predicate keeps the old state on every leaf.
    A CUDA graph has no loop whose condition is on the device; a chunk of
    these steps replayed until the host sees the run is over ends in the
    state a device-side while-loop would end in, step for step."""

    def __init__(self, step_fn, t_final: float, max_steps: int):
        super().__init__()
        self.step_fn = step_fn
        self.t_final, self.max_steps = t_final, max_steps
        self.device = getattr(step_fn, "device", None)
        self.reads_host = getattr(step_fn, "reads_host", True)

    def forward(self, state, cfl_scale):
        new, metrics = self.step_fn(state, cfl_scale)
        live = torch.logical_and(state.t < self.t_final, state.step < self.max_steps)
        kept = [torch.where(live, a, b) for a, b in zip(leaves(new), leaves(state))]
        return rebuild(new, kept), metrics


def run_on_device(step_fn, state, t_final: float, max_steps: int = 10_000_000,
                  cfl_scale: float = 1.0, chunk_steps: int = 50):
    """Fast path: the run to ``t_final`` (or ``max_steps``) with no host
    control, the counterpart of the JAX package's one jitted
    ``lax.while_loop``: chunks of ``chunk_steps`` steps that stop advancing
    on the device once the run is over (:class:`_UntilDone`), replayed with
    one host read of ``t`` and ``step`` per chunk. No in-flight health
    intervention or snapshots; check the returned metrics afterwards.
    Returns (state, last_metrics): the metrics of the last step that
    advanced, or of one step from ``state`` when none did."""
    step_fn_done = _UntilDone(step_fn, t_final, max_steps)
    chunk = make_chunk(getattr(step_fn, "cfg", None), step_fn_done, chunk_steps,
                       device=state.t.device)
    last = None
    t_end = float(np.float32(t_final))  # the device compares in float32
    while True:
        step0 = int(state.step)
        if float(state.t) >= t_end or step0 >= max_steps:
            break
        state, stacked = chunk(state, cfl_scale)
        advanced = int(state.step) - step0
        last = tree_map(lambda x: x[advanced - 1], stacked)
    if last is None:
        _, last = step_fn(state, cfl_scale)
    return state, last
