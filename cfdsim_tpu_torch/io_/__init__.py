"""Snapshot I/O: HDF5 and native writers and readers with resume support."""

from cfdsim_tpu_torch.io_.hdf5 import (
    SnapshotWriter,
    list_steps,
    load_latest,
    load_step,
    restore,
)

__all__ = ["SnapshotWriter", "list_steps", "load_step", "load_latest", "restore"]
