"""The program's own spans, from its recorder
(``cfdsim_tpu_torch.utils.profiling.RECORDER``: spans and counters that
the runner, the chunk and set-up record in the process, on the host's
``perf_counter_ns`` clock).

The window's chunks are the last ``len(record.chunk_ms) + record.chunks``
the program recorded: the window's untraced and traced chunks (set-up's
came before them). Of those, the chunks that ran under the profiler and
any that captured a graph are dropped. Where the program keeps no recorder
(a version from before it), the readers read nothing and return None.
"""

from __future__ import annotations

import statistics


def recorder():
    """The program's recorder, or None where it has none."""
    try:
        from cfdsim_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    return RECORDER


def window_chunks(record) -> list | None:
    """The window's chunk records (``ChunkRecord``) that neither ran under
    the profiler nor captured; None where the program has no recorder."""
    rec = recorder()
    if rec is None:
        return None
    n = len(record.chunk_ms) + record.chunks
    if n <= 0:
        return []
    return [c for c in rec.chunk_records(since=rec.chunks - n)
            if not c.profiled and not c.captures]


def median_chunk_ms(record, *spans: str) -> float | None:
    """The median over the window's chunks of each chunk's milliseconds
    in spans named ``spans``, summed; over the chunks that opened one of
    them. None where none did."""
    chunks = window_chunks(record)
    if not chunks:
        return None
    values = [[c.ms(s) for s in spans] for c in chunks]
    values = [sum(v for v in vs if v is not None) for vs in values
              if any(v is not None for v in vs)]
    return statistics.median(values) if values else None
