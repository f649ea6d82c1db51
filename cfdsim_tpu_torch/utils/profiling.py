"""Performance tracking: steps/sec, cell-updates/sec, final report
(``cfdsim_tpu.utils.profiling``), with the device-memory figures taken from
PyTorch's CUDA caching allocator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time

import torch

from cfdsim_tpu_torch.utils.graphs import CapturedProgram


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (one
    line per card): a card may be capped below its rated power and then runs
    slower under load, so every timing is kept beside this line."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip()


def eager_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` back-to-back eager calls on the
    current CUDA stream, between two CUDA events: host dispatch included,
    since the host may not keep ahead of the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA graph
    (:class:`CapturedProgram`, after one eager pass of the same calls),
    replayed twice between CUDA events; the faster replay over ``reps``.
    No host dispatch is timed."""

    def calls():
        for _ in range(reps):
            fn()

    program = CapturedProgram(calls)
    program.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        program.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def device_memory_stats(device) -> dict:
    """Device-memory figures for the perf report / runner log.

    For a CUDA device: bytes held by live tensors now and at their peak
    (``torch.cuda.memory_stats``), and the card's total memory. A CPU device
    has no device allocator, so the dict is empty.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(device)
    return {
        "device_bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
        "device_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
        "device_bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
        "device_bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


@dataclasses.dataclass
class PerfTracker:
    n_cells: int
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    _t0: float = dataclasses.field(default_factory=time.perf_counter)
    steps: int = 0

    def add_steps(self, n: int):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        e = self.elapsed
        return self.steps / e if e > 0 else 0.0

    @property
    def cell_updates_per_sec(self) -> float:
        return self.steps_per_sec * self.n_cells

    def report(self, include_memory: bool = True) -> dict:
        """Final performance report plus the device-memory figures of
        :func:`device_memory_stats`."""
        out = {
            "total_steps": self.steps,
            "wall_time_s": round(self.elapsed, 3),
            "steps_per_sec": round(self.steps_per_sec, 2),
            "cell_updates_per_sec": self.cell_updates_per_sec,
            "device": str(self.device),
        }
        if include_memory:
            out.update(device_memory_stats(self.device))
        return out


@contextlib.contextmanager
def profiler_trace(log_dir):
    """Trace the block with ``torch.profiler`` (the CPU, and the card where
    CUDA is present) and write a Chrome trace (``trace.json``) into
    ``log_dir``; a no-op for ``None``."""
    if log_dir is None:
        yield
        return
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
