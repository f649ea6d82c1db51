"""One run of one cell: set-up, the measured window through the program's
runner, the traced part of it, and the output check.

The program is driven as its users drive it: a case from
``cfdsim_tpu_torch.cases`` run by ``cfdsim_tpu_torch.runner.Simulation``.
The benchmark wraps the instance's ``_chunk`` (the runner's one call into a
chunk of steps) from here: the wrapper records each chunk's span on the
host clock, keeps the states that the output check needs, and starts and
stops the profiler between chunks in a traced run.

Every cell shares the run's shape: ``WARM_CHUNKS`` chunks of set-up (the
first captures the chunk's CUDA graph), the window, a traced stretch of
``TRACE_SECONDS`` of chunks from ``TRACE_START`` of the window on, and an
output check of the set-up chunks and the window's first chunk as the
reference carries them from its own start, plus ``SAMPLED_CHUNKS`` window
chunks drawn from the seed, each from the program's state before it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from harness import check, trace
from harness.cells import Cell, load_reader
from reference.flow2d import make_perturbation, spacing

WARM_CHUNKS = 2
TRACE_START = 0.4      # share of the window before the profiler starts
TRACE_SECONDS = 0.4
SAMPLED_CHUNKS = 1


@dataclasses.dataclass
class Options:
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    # tests only: a wrapper of the case's step (a planted fault), and
    # overrides of the sizes and runner settings for a tiny CPU run
    step_hook: object = None
    args_override: dict = dataclasses.field(default_factory=dict)
    problem_override: dict = dataclasses.field(default_factory=dict)
    chunk_steps: int | None = None
    # perf_counter readings of set-up's phases, filled in as they pass
    marks: dict = dataclasses.field(default_factory=dict)


class Spans:
    """The ``_chunk`` wrapper's record of the window."""

    def __init__(self, sim, opts: Options, rng: random.Random):
        self.sim = sim
        self.inner = sim._chunk
        self.opts = opts
        self.rng = rng
        self.phase = "setup"
        self.chain: list[dict] = []  # set-up's chunks and the window's first
        self.spans: list[tuple[float, float]] = []
        self.sample: list[dict] = []  # window chunks kept for the check (reservoir)
        self.seen = 0
        self.skip_gaps: set[int] = set()  # gaps next to a profiler start or stop
        self.prof = None
        self.trace_t0 = None
        self.traced = (None, None)   # indices of the first and last traced chunk
        self.counters = {}
        self.window_t0 = 0.0

    def __call__(self, cfl_scale):
        sim = self.sim
        if self.phase != "window":
            m_host, t_now = self.inner(cfl_scale)
            self.opts.marks[f"setup_chunk_{len(self.chain)}"] = time.perf_counter()
            self.chain.append(_kept(len(self.chain) - WARM_CHUNKS, None, sim.state, m_host,
                                    cfl_scale))
            return m_host, t_now
        index = len(self.spans)
        self._maybe_start_trace(index)
        pre = sim.state
        t0 = time.perf_counter()
        with torch.profiler.record_function(trace.CHUNK_SPAN):
            m_host, t_now = self.inner(cfl_scale)
        t1 = time.perf_counter()
        self.spans.append((t0, t1))
        item = _kept(index, pre, sim.state, m_host, cfl_scale)
        if index == 0:
            self.chain.append({**item, "pre": None})
        else:
            self._reservoir(item)
        self._maybe_stop_trace(index, t1)
        return m_host, t_now

    def _reservoir(self, item):
        """Keeps ``SAMPLED_CHUNKS`` of the window's later chunks, each
        equally likely, drawn from the seed."""
        self.seen += 1
        if len(self.sample) < SAMPLED_CHUNKS:
            self.sample.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < SAMPLED_CHUNKS:
                self.sample[j] = item

    def _maybe_start_trace(self, index):
        if not self.opts.trace or self.prof is not None:
            return
        if time.perf_counter() - self.window_t0 < TRACE_START * self.opts.seconds:
            return
        from torch.profiler import ProfilerActivity, profile

        self.counters["before"] = read_counters(self.sim.chunk.step_fn)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.skip_gaps.add(index)  # the gap before this chunk holds the start
        self.traced = (index, None)

    def _maybe_stop_trace(self, index, t1):
        if self.prof is None or self.traced[1] is not None:
            return
        if self.trace_t0 is None:
            self.trace_t0 = self.spans[index][0]
        if t1 - self.trace_t0 < TRACE_SECONDS:
            return
        self.finish_trace(index)

    def finish_trace(self, index):
        """Stops the profiler after chunk ``index``: here once the traced
        chunks span ``TRACE_SECONDS``, else when the window ends."""
        self.prof.stop()
        self.counters["after"] = read_counters(self.sim.chunk.step_fn)
        self.skip_gaps.add(index + 1)  # the gap after this chunk holds the stop
        self.traced = (self.traced[0], index)


def _kept(index, pre, post, m_host, cfl) -> dict:
    """A chunk as the check compares it: the program's state before it
    (None where the reference carries its own), after it, and the per-step
    diagnostics the runner read."""
    return {"index": index, "pre": pre, "post": post, "metrics": _rows(m_host),
            "cfl": float(cfl)}


def _rows(m_host):
    """A chunk's stacked diagnostics as a (steps, fields) float64 array."""
    return np.stack([np.asarray(x, dtype=np.float64) for x in m_host], axis=1)


def read_counters(step) -> dict:
    """The program's counters that per-layer metrics read: the pressure
    solve's early-exit chunks (a device counter) and its chunk length."""
    pois = getattr(step, "poisson", None)
    runs = getattr(pois, "chunks_run", None)
    if runs is None:
        return {}
    return {"poisson_chunks_run": int(runs.item()),
            "poisson_check_every": int(pois.cfg.check_every)}


def _poisson_arg(value):
    if isinstance(value, dict):
        from cfdsim_tpu_torch.solvers.poisson import PoissonConfig

        return PoissonConfig(**value)
    return value


def build_case(cell: Cell, opts: Options):
    from cfdsim_tpu_torch import cases

    args = {**cell.program_args, **opts.args_override}
    if "poisson" in args:
        args["poisson"] = _poisson_arg(args["poisson"])
    return getattr(cases, cell.config["builder"])(**args, device=opts.device)


def perturbation(problem: dict, config: dict, seed: int, device):
    """The seed's inputs: K×K normal coefficients drawn on ``device`` by a
    generator seeded with ``seed``, made into a smooth divergence-free
    perturbation of the start."""
    spec = config["perturbation"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    k = spec["modes"]
    coeff = torch.randn((k, k), generator=gen, device=device, dtype=torch.float32)
    return make_perturbation(problem, coeff, spec["amplitude"] * config["velocity_scale"])


def sample_clocks(device_index: int = 0):
    """Starts ``nvidia-smi`` sampling the card's clocks and power once a
    second; returns the process (or None where there is no nvidia-smi)."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", f"--id={device_index}",
             "--query-gpu=timestamp,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader", "--loop-ms=1000"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def stop_clocks(proc) -> list[str]:
    if proc is None:
        return []
    proc.terminate()
    try:
        out, _ = proc.communicate(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return [line.strip() for line in out.splitlines() if line.strip()]


@dataclasses.dataclass
class Outcome:
    """What one run of the program left for the result and the check."""

    metrics_e2e: dict
    layer: dict
    device: dict
    breakdown: dict | None
    chain: list            # set-up's chunks and the window's first, in order
    sampled: list          # window chunks drawn from the seed
    perturbation: tuple
    problem: dict
    chunk_steps: int
    chunks: int
    stopped: str


def measure(cell: Cell, opts: Options, process_start: float, emit=print) -> Outcome:
    """Set-up, the window and, in a traced run, its per-layer metrics;
    frees the program before it returns, keeping the compared chunks.
    ``emit`` takes the earlier lines of output (peak memory, clocks)."""
    from cfdsim_tpu_torch.runner import RunnerConfig, Simulation

    cuda = torch.device(opts.device).type == "cuda"
    problem = {**cell.problem, **opts.problem_override}
    traffic = cell.traffic
    runner = dict(traffic["runner"])
    if opts.chunk_steps is not None:
        runner["chunk_steps"] = opts.chunk_steps
    steps_per_chunk = runner["chunk_steps"]

    case = build_case(cell, opts)
    du, dv = perturbation(problem, cell.config, opts.seed, opts.device)
    state = case.state._replace(u=case.state.u + du.to(case.state.u.dtype),
                                v=case.state.v + dv.to(case.state.v.dtype))
    step_fn = case.step if opts.step_hook is None else opts.step_hook(case.step)
    # the CLI's run: the health check's velocity bound is the case's clip
    runner.setdefault("max_velocity", getattr(case.cfg, "max_velocity", 1e3))
    rcfg = RunnerConfig(t_final=math.inf, max_steps=WARM_CHUNKS * steps_per_chunk,
                        wall_clock_limit_s=0.0, **runner)
    sim = Simulation(step_fn, state, rcfg, n_cells=case.grid.n_cells)
    spans = Spans(sim, opts, random.Random(opts.seed))
    sim._chunk = spans
    opts.marks["case_built"] = time.perf_counter()

    # set-up: the first run captures the chunk's CUDA graph on a card
    sim.run()
    if sim.stopped_reason:
        raise RuntimeError(f"set-up stopped: {sim.stopped_reason}")
    rcfg.max_steps = 1 << 62
    rcfg.wall_clock_limit_s = float(opts.seconds)
    step0 = int(sim.state.step)
    if cuda:
        torch.cuda.synchronize()

    clocks = sample_clocks() if (opts.trace and cuda) else None
    spans.phase = "window"
    t0 = time.perf_counter()
    setup_s = _since_process_start(process_start)
    opts.marks["window_start"] = t0
    spans.window_t0 = t0
    sim.run()
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    clock_lines = stop_clocks(clocks)
    if spans.prof is not None and spans.traced[1] is None:
        spans.finish_trace(len(spans.spans) - 1)

    steps = int(sim.state.step) - step0
    chunks = len(spans.spans)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    emit(_line({"setup_phases_s": _phases(opts.marks, process_start, setup_s)}))
    emit(_line({"memory_peak_bytes": peak, "steps": steps, "chunks": chunks,
                "stopped_reason": sim.stopped_reason, "chunk_route": sim.chunk.mode}))
    if opts.trace:
        emit(_line({"clocks_power": clock_lines}))
    chunk_ms = [1e3 * (e - s) for s, e in spans.spans]
    emit(_line({"window_s": t1 - t0, **_distribution(chunk_ms, spans.spans, t0)}))
    metrics_e2e = {
        "cell_updates_per_s": case.grid.n_cells * steps / (t1 - t0),
        "setup_s": setup_s,
    }
    layer, breakdown = {}, None
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    if opts.trace:
        layer, extra, breakdown = _per_layer(cell, spans, steps_per_chunk, problem)
        device.update(extra)
    outcome = Outcome(metrics_e2e, layer, device, breakdown, spans.chain,
                      sorted(spans.sample, key=lambda c: c["index"]),
                      (du, dv), problem, steps_per_chunk, chunks, sim.stopped_reason)
    # free the program (its graph, buffers and pools) before the check runs
    del sim, case, step_fn, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return outcome


def compared(outcome: Outcome) -> list:
    """The chunks the check compares: the chain from the start, then the
    sampled ones."""
    return outcome.chain + outcome.sampled


def judge(outcome: Outcome, device) -> tuple[list, dict]:
    """The reference over the compared chunks: each chunk's readings, and
    the worst reading of each number."""
    refs = check.follow(_reference(outcome.problem, device), compared(outcome),
                        outcome.perturbation, outcome.chunk_steps)
    readings = [check.chunk_gaps(check.program_answer(c), r, spacing(outcome.problem))
                for c, r in zip(compared(outcome), refs)]
    return readings, check.worst(readings)


def run(cell: Cell, opts: Options, process_start: float, emit=print) -> dict:
    """One run of ``cell``; returns the result object the driver reads."""
    out = measure(cell, opts, process_start, emit)
    t0 = time.perf_counter()
    readings, gaps = judge(out, opts.device)
    emit(_line({"check_s": time.perf_counter() - t0}))
    limits = {k: float(cell.limits[k]) for k in check.NUMBERS}
    failed_chunks = sum(any(not (r[k] <= limits[k]) for k in check.NUMBERS) for r in readings)
    healthy = out.stopped == "wall-clock limit"
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in check.NUMBERS}
    checks["chunks_compared"] = {"value": len(readings),
                                 "limit": WARM_CHUNKS + 1 + SAMPLED_CHUNKS}
    checks["stopped"] = {"value": out.stopped or "none", "limit": "wall-clock limit"}
    if opts.trace:
        metrics = {m["name"]: {"value": out.layer[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in out.layer}
    else:
        metrics = {m["name"]: {"value": out.metrics_e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": bool(healthy and failed_chunks == 0), "attempted": out.chunks,
              "failed": failed_chunks + (0 if healthy else 1),
              "metrics": metrics, "device": out.device}
    if out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["checks"] = checks
    return result


def _reference(problem: dict, device):
    from reference.flow2d import ReferenceFlow

    return ReferenceFlow(problem, device, torch.float32)


def _per_layer(cell: Cell, spans: Spans, steps_per_chunk: int, problem: dict):
    first, last = spans.traced
    if spans.prof is None or last is None:
        raise RuntimeError("the window was too short to trace: no chunk was traced")
    device_ops, host_ops = trace.read_profile(spans.prof)
    lo, hi, n_spans = trace.chunk_window(host_ops)
    ops = [o for o in device_ops if o.end > lo and o.start < hi]
    chunks = last - first + 1
    if n_spans != chunks:
        raise RuntimeError(f"the trace holds {n_spans} chunk spans, the window traced {chunks}")
    gaps = [1e3 * (spans.spans[i][0] - spans.spans[i - 1][1])
            for i in range(1, len(spans.spans)) if i not in spans.skip_gaps]
    untraced = [1e3 * (e - s) for i, (s, e) in enumerate(spans.spans)
                if not first <= i <= last]
    record = LayerRecord(
        cell=cell.name, problem=problem, chunk_steps=steps_per_chunk,
        steps=chunks * steps_per_chunk, chunks=chunks, window=(lo, hi), ops=ops,
        host_gaps_ms=gaps, chunk_ms=untraced,
        counters={k: spans.counters[k] for k in ("before", "after") if k in spans.counters},
    )
    values = {}
    for m in cell.per_layer:
        v = load_reader(m["name"], cell.bench_dir).read(record)
        if v is not None:
            values[m["name"]] = float(v)
    busy = trace.union_length([(o.start, o.end) for o in ops]) * 1e-6
    extra = {"busy_s": busy, "window_s": (hi - lo) * 1e-6}
    return values, extra, trace.breakdown(ops, host_ops, lo, hi)


@dataclasses.dataclass
class LayerRecord:
    """What a per-layer metric's reader reads: the traced chunks' device
    ops (µs on the profiler's clock) inside ``window``, the runner's host
    gaps between chunk spans over the whole window, the wall times of the
    window's untraced chunks, and the program's counters before and after
    the traced chunks."""

    cell: str
    problem: dict
    chunk_steps: int
    steps: int
    chunks: int
    window: tuple
    ops: list
    host_gaps_ms: list
    counters: dict
    chunk_ms: list = dataclasses.field(default_factory=list)


def _distribution(chunk_ms, spans, t0) -> dict:
    """The chunk times' quantiles, the host's time between chunks, and the
    mean chunk time in each fifth of the window: whether a slow run is slow
    throughout or in a part."""
    if len(chunk_ms) < 5:
        return {}
    q = statistics.quantiles(chunk_ms, n=20, method="inclusive")
    gaps = [1e3 * (spans[i][0] - spans[i - 1][1]) for i in range(1, len(spans))]
    end = spans[-1][1]
    fifths = [[] for _ in range(5)]
    for (s, _), ms in zip(spans, chunk_ms):
        fifths[min(4, int(5 * (s - t0) / (end - t0)))].append(ms)
    return {"chunk_ms": {"min": min(chunk_ms), "p5": q[0], "p25": q[4], "p50": q[9],
                         "p75": q[14], "p95": q[18], "max": max(chunk_ms)},
            "host_gap_ms": {"mean": sum(gaps) / len(gaps), "max": max(gaps)},
            "chunk_ms_by_fifth": [sum(f) / len(f) if f else None for f in fifths]}


def _phases(marks: dict, process_start: float, setup_s: float) -> dict:
    """Set-up's seconds by phase: before the harness's first line (the
    interpreter's start), then between the marks in the order they passed."""
    out = {"interpreter": setup_s - (marks.get("window_start", process_start) - process_start)}
    last, t = "harness_start", process_start
    for name, at in sorted(marks.items(), key=lambda kv: kv[1]):
        out[f"{last}..{name}"] = at - t
        last, t = name, at
    return out


def _since_process_start(fallback: float) -> float:
    """Seconds since this process started, from the kernel's record of its
    start (10 ms ticks); the harness's own start where that is unreadable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return boot - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - fallback


def _line(obj) -> str:
    return json.dumps(obj)


def loaded_forbidden(names=("jax", "jaxlib", "flax", "cfdsim_tpu")) -> list[str]:
    """Modules in ``sys.modules`` whose top-level name (before the first
    dot) is one of ``names``, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)
