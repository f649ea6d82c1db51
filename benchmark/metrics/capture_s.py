"""Set-up's graph capture: the process's ``cfd.capture`` spans
(``Chunk._capture``: the eager warm-up steps, the capture and the
instantiation) summed, less any ``cfd.kernel.build`` inside them, so that
nvcc at a checkout's first run stays out of it. None where nothing was
captured or the program has no recorder."""

from harness.program_spans import recorder

LAYER = "chunk"
UNIT = "s"
MOVES = "setup_s"
WORKLOADS = None


def read(record):
    rec = recorder()
    return None if rec is None else rec.setup_seconds()["capture_s"]
