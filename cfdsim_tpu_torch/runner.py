"""Simulation runner: chunked on-device stepping with host-side control
(``cfdsim_tpu.runner``).

A chunk is ``chunk_steps`` steps, built once by
``models/incompressible.py::make_chunk``: on a CUDA device one captured
device program (a CUDA graph, as the JAX runner's chunk is one jitted
``lax.scan``), on the CPU, or for a step that reads the host, a Python loop
of step calls. Between chunks the host reads the per-step metric scalars,
stacked on the device and copied over in one transfer, to do health checks,
CFL back-off (a new value in the chunk's cfl buffer: no new capture),
logging and the wall-clock kill switch. Fields never cross to the host here. Snapshot I/O, the
progress bar and the memory log are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from cfdsim_tpu_torch.models.incompressible import StepMetrics, make_chunk
from cfdsim_tpu_torch.monitor import check_metrics
from cfdsim_tpu_torch.utils.profiling import PerfTracker


@dataclasses.dataclass
class RunnerConfig:
    """Host-loop configuration: the JAX package's fields and defaults, less
    snapshots, the progress bar and the memory log, which are not ported."""

    t_final: float = 1.0
    max_steps: int = 10_000_000
    chunk_steps: int = 50
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
    ):
        if snapshot_fn is not None:
            raise NotImplementedError("snapshot I/O is not ported yet; pass snapshot_fn=None")
        self.step_fn = step_fn
        self.cfg = cfg
        self.state = state
        self.device = state.u.device
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
        host = torch.cat([torch.stack(tuple(m)).reshape(-1),
                          self.state.t.reshape(1)]).cpu().numpy()
        per_field = host[:-1].reshape(len(StepMetrics._fields), -1)
        return StepMetrics(*per_field), float(host[-1])

    def run(self):
        cfg = self.cfg
        t_start = time.perf_counter()
        step = int(self.state.step)
        t_now = float(self.state.t)
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

            # host-side control: health, back-off, logging
            self.metrics_history.append({
                "step": step,
                "t": t_now,
                "dt": float(m_host.dt[-1]),
                "energy": float(m_host.energy[-1]),
                "max_vel": float(np.max(m_host.max_vel)),
                "div_post": float(np.max(m_host.div_post)),
            })
            if cfg.health_check:
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

            if cfg.log_every_chunks and chunk_idx % cfg.log_every_chunks == 0:
                h = self.metrics_history[-1]
                self.log.info(
                    "step %d t=%.4f dt=%.2e div=%.3e E=%.4f speed=%.1f steps/s",
                    step,
                    h["t"],
                    h["dt"],
                    h["div_post"],
                    h["energy"],
                    self.perf.steps_per_sec,
                )

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
