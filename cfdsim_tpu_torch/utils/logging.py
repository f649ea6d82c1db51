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
    logger = logging.getLogger(name)
    logger.setLevel(file_level)
    if logger.handlers:  # already configured
        return logger
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(Path(log_dir) / (filename or f"{name}.log"))
    fh.setLevel(file_level)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setLevel(console_level)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    logger.propagate = False
    return logger
