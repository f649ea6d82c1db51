"""Performance tracking (``cfdsim_tpu.utils.profiling``): the process's
recorder of spans and counters (:data:`RECORDER`), the runner's rates and
report read from it (:class:`PerfTracker`), device-memory figures from
PyTorch's CUDA caching allocator, and timing helpers for the card.

Spans (name: where it is opened; what reads it):

- ``cfd.chunk``: ``runner.py::Simulation._chunk``, one per chunk; with
  ``cfd.runner.control``, the runner's rate and ``wall_time_s``.
- ``cfd.graph.replay``: ``models/incompressible.py::Chunk._replay``, one
  per replay of the chunk's program, the host's ``cudaGraphLaunch``; the
  report's ``chunk_host_ms["launch"]`` and a chunk's ``replays``.
- ``cfd.chunk.loop``: ``Chunk._loop``, the loop route's steps;
  ``chunk_host_ms["launch"]`` on that route.
- ``cfd.chunk.copy_out``: ``Chunk._replay``, the clones out of the static
  buffers, which queue behind the graphs when the card is far behind;
  with ``cfd.runner.read``, ``chunk_host_ms["wait"]``.
- ``cfd.runner.read``: ``Simulation._chunk``, the chunk's one device→host
  copy, which waits for the card.
- ``cfd.runner.control``: ``Simulation.run``, from the end of each chunk
  to the next one or the run's end, under the chunk's index (health check,
  history, back-off, snapshot, log, the wall-clock check);
  ``chunk_host_ms["control"]``.
- ``cfd.capture``: ``Chunk._replay``'s first call, the eager pass, the
  capture and the instantiation; the report's ``setup["capture_s"]``.
- ``cfd.capture.record``: ``utils/graphs.py::CapturedProgram``, the
  capture and instantiation alone; ``CapturedProgram.capture_seconds``.
- ``cfd.kernel.build``: ``ops/kernels/cuda_build.py::build_library``, one
  per call; ``setup["kernel_build_s"]``.
- ``cfd.autotune``: ``solvers/autotune.py::measure_dct_variants``;
  ``setup["autotune_s"]``.

Counters: ``graph_replays`` (a chunk's :attr:`ChunkRecord.replays`, its
``cfd.graph.replay`` spans), ``graph_captures`` (``CapturedProgram``; a
chunk that moved it held a capture; the report's ``graph_captures``) and
``kernel_compiles`` (``build_library`` when nvcc ran;
``setup["kernel_compiles"]``). The benchmark's per-layer metrics read the
same records (``benchmark/metrics/``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import statistics
import subprocess
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

_now = time.perf_counter_ns


def _profiling() -> bool:
    """Whether a ``torch.profiler`` runs: the flag PyTorch keeps for fast
    checks from Python, set while any of its profilers is started."""
    return _autograd_profiler._is_profiler_enabled


def _range(name: int):
    """An entered ``record_function`` range named as span ``name``."""
    r = torch.profiler.record_function(NAMES[name])
    r.__enter__()
    return r


# span names; a span stores its name's index
NAMES = (
    "cfd.chunk", "cfd.graph.replay", "cfd.chunk.loop", "cfd.chunk.copy_out",
    "cfd.runner.read", "cfd.runner.control",
    # set-up's, opened through Recorder.span or filed through Recorder.record
    "cfd.capture", "cfd.capture.record", "cfd.kernel.build", "cfd.autotune",
)
(CHUNK, REPLAY, LOOP, COPY_OUT, READ, CONTROL,
 CAPTURE, CAPTURE_RECORD, KERNEL_BUILD, AUTOTUNE) = range(len(NAMES))

CHUNKS_HELD = 4096       # a 35-s window of the shortest chunk (25 ms) is ~1,400
SETUP_SPANS_HELD = 4096


class Span(NamedTuple):
    """A set-up span."""
    serial: int          # the set-up spans filed before it in the process
    name: str
    start_ns: int        # time.perf_counter_ns()
    end_ns: int
    chunk: int           # the chunk's index, -1 outside every chunk


class ChunkRecord(NamedTuple):
    index: int
    steps: int
    profiled: bool       # a torch.profiler was active at the chunk's start
    captures: int        # graphs captured inside the chunk
    replays: int         # its cfd.graph.replay spans
    ns: tuple            # the chunk's nanoseconds summed by span name, indexed as NAMES

    def ms(self, name: str) -> float | None:
        """The chunk's milliseconds in spans named ``name``; None where it
        opened none."""
        ns = self.ns[NAMES.index(name)]
        return 1e-6 * ns if ns else None


class Recorder:
    """Spans and counters of one process.

    On the hot path a span opens and closes in a pair (:meth:`open`,
    :meth:`close`) and spans nest like calls: a stack of open (name, start)
    pairs, and at each close the span's nanoseconds go into the current
    chunk's sum for its name. A chunk runs from :meth:`begin_chunk` to
    :meth:`end_chunk` (or the next chunk's begin), its ``cfd.runner.control``
    span included; its end files a :class:`ChunkRecord` (the last
    ``CHUNKS_HELD`` are kept, :meth:`chunk_records`) and adds the chunk to
    the running totals the runner's rate reads. What a chunk writes costs
    no memory beyond its record, however many spans it opens.

    Set-up spans (:meth:`span`, :meth:`record`) time themselves and are
    kept in :attr:`setup` (the last ``SETUP_SPANS_HELD``); one inside a
    chunk counts in the chunk's sums too.

    While a ``torch.profiler`` is active, checked once at each chunk's start
    (and at each set-up span's start), every span is also entered as a
    ``torch.profiler.record_function`` range of the same name, so that the
    trace holds the program's spans on the profiler's clock. Without a
    profiler no range is entered. ``enabled = False``, set between chunks,
    stops the chunks' recording; it exists to measure what the recording
    costs.

    Spans open from one thread; :meth:`record` may come from any.
    """

    def __init__(self):
        self.enabled = True
        self.chunks = 0               # chunks begun
        self.records: collections.deque = collections.deque(maxlen=CHUNKS_HELD)
        self.setup: collections.deque = collections.deque(maxlen=SETUP_SPANS_HELD)
        self.setup_spans = 0          # set-up spans filed
        self.setup_mark = (0, 0)      # (set-up spans, kernel compiles) at the last report
        self.graph_captures = 0
        self.kernel_compiles = 0
        # the ended chunks' wall (cfd.chunk and cfd.runner.control), and of
        # those that captured nothing, their wall and steps
        self.wall_ns = self.steady_ns = self.steady_steps = 0
        self._stack: list = []        # the open spans' (name, start, profiler range)
        self._ns = [0] * len(NAMES)
        self._n = [0] * len(NAMES)
        self._cur = -1                # the current chunk, -1 between chunks
        self._steps = self._captures = 0
        self._mirror = False
        self._lock = threading.Lock()

    # -- spans ------------------------------------------------------------

    def open(self, name: int) -> None:
        """Opens span ``name`` (an index into :data:`NAMES`) inside the
        innermost open one."""
        if self.enabled:
            self._stack.append((name, _now(), _range(name) if self._mirror else None))

    def close(self) -> None:
        """Closes the innermost open span."""
        if self._stack:
            t = _now()
            name, start, r = self._stack.pop()
            self._ns[name] += t - start
            self._n[name] += 1
            if r is not None:
                r.__exit__(None, None, None)

    def span(self, name: int):
        """``with recorder.span(name) as s:`` a set-up span, filed in
        :attr:`setup`; ``s.seconds`` is its length afterwards."""
        return _SetupSpan(self, name)

    def record(self, name: int, start_ns: int, end_ns: int) -> None:
        """Files a set-up span its caller timed (from any thread)."""
        with self._lock:
            self.setup.append(Span(self.setup_spans, NAMES[name], start_ns, end_ns, self._cur))
            self.setup_spans += 1

    def count_compile(self) -> None:
        """Counts one run of nvcc (from any thread)."""
        with self._lock:
            self.kernel_compiles += 1

    # -- chunks -----------------------------------------------------------

    def begin_chunk(self, steps: int) -> None:
        """Ends the previous chunk, if current, begins chunk ``chunks`` of
        ``steps`` steps and opens its ``cfd.chunk`` span. Checks once for a
        profiler."""
        self.end_chunk()
        if not self.enabled:
            return
        self._stack.clear()  # what a chunk called outside a run left open
        self._cur = self.chunks
        self.chunks += 1
        self._steps, self._captures = steps, self.graph_captures
        self._ns = [0] * len(NAMES)
        self._n = [0] * len(NAMES)
        self._mirror = _profiling()
        self.open(CHUNK)

    def end_chunk(self) -> None:
        """Closes every span still open (the runner's control span, or what
        an exception left open) and files the current chunk, if any."""
        if self._cur < 0:
            return
        while self._stack:
            self.close()
        ns, captures = tuple(self._ns), self.graph_captures - self._captures
        self.records.append(ChunkRecord(self._cur, self._steps, self._mirror, captures,
                                        self._n[REPLAY], ns))
        wall = ns[CHUNK] + ns[CONTROL]
        self.wall_ns += wall
        if not captures:
            self.steady_ns += wall
            self.steady_steps += self._steps
        self._cur = -1
        self._mirror = False

    def chunk_records(self, since: int = 0) -> list[ChunkRecord]:
        """The kept records of the ended chunks from index ``since`` on,
        oldest first."""
        out = []
        for c in reversed(self.records):
            if c.index < since:
                break
            out.append(c)
        return out[::-1]

    # -- set-up -----------------------------------------------------------

    def setup_seconds(self, since: int = 0) -> dict:
        """Set-up's seconds from the set-up spans filed from serial
        ``since`` on (None where no such span ran): ``capture_s``, the
        ``cfd.capture`` spans less the kernel builds inside them (nvcc at a
        checkout's first run stays out of it); ``kernel_build_s``, the
        builds summed (parallel builds overlap); ``autotune_s``."""
        by = collections.defaultdict(list)
        for s in self.setup:
            if s.serial >= since:
                by[s.name].append(s)
        captures, builds = by[NAMES[CAPTURE]], by[NAMES[KERNEL_BUILD]]
        inside = [b for b in builds
                  if any(c.start_ns <= b.start_ns and b.end_ns <= c.end_ns for c in captures)]

        def seconds(spans, less=()):
            if not spans:
                return None
            return 1e-9 * (sum(s.end_ns - s.start_ns for s in spans)
                           - sum(s.end_ns - s.start_ns for s in less))

        return {"capture_s": seconds(captures, inside),
                "kernel_build_s": seconds(builds),
                "autotune_s": seconds(by[NAMES[AUTOTUNE]])}


class _SetupSpan:
    """:meth:`Recorder.span`'s context manager."""

    __slots__ = ("rec", "name", "start", "range", "seconds")

    def __init__(self, rec: Recorder, name: int):
        self.rec, self.name, self.seconds = rec, name, 0.0

    def __enter__(self):
        self.range = _range(self.name) if _profiling() else None
        self.start = _now()
        return self

    def __exit__(self, et, ev, tb):
        end = _now()
        rec = self.rec
        self.seconds = 1e-9 * (end - self.start)
        if rec._cur >= 0:
            rec._ns[self.name] += end - self.start
        rec.record(self.name, self.start, end)
        if self.range is not None:
            self.range.__exit__(et, ev, tb)
        return False


RECORDER = Recorder()


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
    from cfdsim_tpu_torch.utils.graphs import CapturedProgram

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
    """The runner's rates and report, read from the recorder; it keeps no
    clock. The rates run over the chunks ended since the tracker was made
    that captured nothing: their ``cfd.chunk`` and ``cfd.runner.control``
    spans, as the benchmark's window times the runner. ``wall_time_s`` sums
    those spans over every such chunk. Set-up counts from the report before
    the tracker was made (the process's start for the first): this
    simulation's case, kernels and capture, and no earlier run's."""

    n_cells: int
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    steps: int = 0
    recorder: Recorder = dataclasses.field(default_factory=lambda: RECORDER)

    def __post_init__(self):
        r = self.recorder
        self._first = r.chunks
        self._at = (r.wall_ns, r.steady_ns, r.steady_steps, r.graph_captures)
        self._setup_from = r.setup_mark

    def add_steps(self, n: int):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return 1e-9 * (self.recorder.wall_ns - self._at[0])

    @property
    def steps_per_sec(self) -> float:
        r = self.recorder
        ns = r.steady_ns - self._at[1]
        return 1e9 * (r.steady_steps - self._at[2]) / ns if ns else 0.0

    @property
    def cell_updates_per_sec(self) -> float:
        return self.steps_per_sec * self.n_cells

    def chunk_host_ms(self, last: int | None = None) -> dict:
        """Medians over the tracker's kept chunks (the ``last`` ones, where
        given) that neither captured nor ran under a profiler: ``launch``,
        the host's issue of the chunk's steps (its ``cfd.graph.replay``
        spans summed, or on the loop route its ``cfd.chunk.loop``);
        ``wait``, from the last launch to the metrics on the host
        (``cfd.chunk.copy_out`` and ``cfd.runner.read``: the host waits for
        the card in the read, or in the clones where they queue behind the
        graphs); ``control``, its ``cfd.runner.control``. None where no
        chunk has the spans."""
        r = self.recorder
        since = self._first if last is None else max(self._first, r.chunks - last)
        steady = [c for c in r.chunk_records(since) if not c.captures and not c.profiled]
        cols = {"launch": [c.ns[REPLAY] or c.ns[LOOP] for c in steady],
                "wait": [c.ns[COPY_OUT] + c.ns[READ] for c in steady],
                "control": [c.ns[CONTROL] for c in steady]}
        return {k: 1e-6 * statistics.median(v) if any(v) else None for k, v in cols.items()}

    def report(self, include_memory: bool = True) -> dict:
        """Final performance report: steps and rates, set-up's seconds
        (:meth:`Recorder.setup_seconds`) and nvcc runs, the chunk's host
        medians (:meth:`chunk_host_ms`), the graphs captured since the
        tracker was made, and the device-memory figures of
        :func:`device_memory_stats`. Marks the recorder's set-up as
        reported, for the next tracker."""
        r = self.recorder
        spans, compiles = self._setup_from
        setup = r.setup_seconds(since=spans)
        setup["kernel_compiles"] = r.kernel_compiles - compiles
        r.setup_mark = (r.setup_spans, r.kernel_compiles)
        out = {
            "total_steps": self.steps,
            "wall_time_s": round(self.elapsed, 3),
            "steps_per_sec": round(self.steps_per_sec, 2),
            "cell_updates_per_sec": self.cell_updates_per_sec,
            "device": str(self.device),
            "setup": setup,
            "chunk_host_ms": self.chunk_host_ms(),
            "graph_captures": r.graph_captures - self._at[3],
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
