"""Reading a ``torch.profiler`` trace: device operations, the union of
their intervals, idle gaps and what the host was doing in them.

Times are microseconds on the profiler's clock, which its host and device
events share. Device time is the union of the operations' intervals, never
a sum of durations, so overlapping operations count once.
"""

from __future__ import annotations

import dataclasses
import re

CHUNK_SPAN = "bench.chunk"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float  # µs
    end: float    # µs
    kind: str     # "kernel" | "memcpy" | "memset"


@dataclasses.dataclass(frozen=True)
class HostOp:
    name: str
    start: float
    end: float


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def op_kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def matching(ops, pattern: str):
    """The ops whose name matches the regular expression ``pattern``."""
    rx = re.compile(pattern)
    return [o for o in ops if rx.search(o.name)]


def read_profile(prof):
    """(device ops, host ops) of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if getattr(e, "is_user_annotation", False) or (
                e.device_type == DeviceType.CUDA and e.name == CHUNK_SPAN):
            # a span's shadow on the device timeline is no device work
            if e.device_type == DeviceType.CPU:
                host.append(HostOp(e.name, start, end))
            continue
        if e.device_type == DeviceType.CUDA:
            device.append(DeviceOp(e.name, start, end, op_kind(e.name)))
        elif e.device_type == DeviceType.CPU:
            host.append(HostOp(e.name, start, end))
    return device, host


def chunk_window(host_ops) -> tuple[float, float, int]:
    """(start, end, count) of the traced chunk spans."""
    spans = [h for h in host_ops if h.name == CHUNK_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {CHUNK_SPAN!r} span")
    return min(h.start for h in spans), max(h.end for h in spans), len(spans)


def host_labels(gap_list, host_ops) -> list[str]:
    """What the host was doing in each of the sorted, disjoint gaps:
    outside every chunk span, the runner; inside one, the host op that
    covers most of the gap (the shortest among equals). One sweep over the
    host ops sorted by start."""
    ops = sorted(host_ops, key=lambda h: h.start)
    labels, active, i = [], [], 0
    for s, e in gap_list:
        while i < len(ops) and ops[i].start < e:
            active.append(ops[i])
            i += 1
        active = [h for h in active if h.end > s]
        mid = 0.5 * (s + e)
        if not any(h.name == CHUNK_SPAN and h.start <= mid <= h.end for h in active):
            labels.append("runner between chunks")
            continue
        best, key = "chunk: no host op", (0.0, 0.0)
        for h in active:
            if h.name == CHUNK_SPAN:
                continue
            k = (min(h.end, e) - max(h.start, s), -(h.end - h.start))
            if k > key:
                best, key = f"chunk: {h.name}", k
        labels.append(best)
    return labels


def breakdown(device_ops, host_ops, lo: float, hi: float, top: int = 10) -> dict:
    """The device ops that took most time (summed by name) and the idle
    gaps summed by what the host was doing, both in seconds, at most
    ``top`` entries each."""
    by_name: dict[str, float] = {}
    for o in device_ops:
        if o.end > lo and o.start < hi:
            d = min(o.end, hi) - max(o.start, lo)
            by_name[o.name[:160]] = by_name.get(o.name[:160], 0.0) + d * 1e-6
    idle: dict[str, float] = {}
    gap_list = gaps([(o.start, o.end) for o in device_ops], lo, hi)
    for g, label in zip(gap_list, host_labels(gap_list, host_ops)):
        idle[label] = idle.get(label, 0.0) + (g[1] - g[0]) * 1e-6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k, v] for k, v in order(by_name)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}
