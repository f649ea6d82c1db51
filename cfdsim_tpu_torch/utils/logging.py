"""Two-sink logging: INFO → file, WARNING → console (a copy of
``cfdsim_tpu.utils.logging``).

Parity with the reference's logging setup (v5.py:27-39,
cavity_flow_v1.py:26-36) as a reusable helper instead of per-script
module-level side effects.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path


def setup_logging(
    name: str = "cfdsim_tpu_torch",
    log_dir: str | os.PathLike = "logs",
    filename: str | None = None,
    file_level: int = logging.INFO,
    console_level: int = logging.WARNING,
) -> logging.Logger:
    """The logger ``name`` with one file handler on ``log_dir/filename`` and
    one console handler. A later call in the same process points the file
    handler at its own ``log_dir`` (closing the old file), so each run logs
    into its own directory; a repeated call adds no handler."""
    logger = logging.getLogger(name)
    logger.setLevel(file_level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    path = (Path(log_dir) / (filename or f"{name}.log")).resolve()
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and Path(h.baseFilename) != path:
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
        path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setLevel(file_level)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        ch = logging.StreamHandler()
        ch.setLevel(console_level)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    logger.propagate = False
    return logger
