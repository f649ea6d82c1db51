"""HDF5 snapshot I/O (``cfdsim_tpu.io_.hdf5``).

The on-disk schema is the JAX package's, so a file one package wrote
restores in the other: one group ``step_NNNNNN`` per snapshot with a
``time`` attribute and gzip'd field datasets. :func:`restore` is the
resume path; it also takes a ``.csnap`` file of the native writer directly
(``io_/native.py``), with no detour over HDF5.

Device→host copies happen only here, off the step path: a snapshot is
taken between chunks, from the runner's own state.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def to_host(value) -> np.ndarray:
    """A field as a numpy array (a tensor is copied off its device). A
    complex field (the pseudo-spectral tier's ω̂) becomes the JAX package's
    schema: float32 re/im planes stacked on a new leading axis, (2, ...). A
    bfloat16 field (``storage="bf16"``), which numpy lacks, is written as
    float32, exactly; :func:`restore` rounds it back into the state's
    dtype."""
    if torch.is_tensor(value) and value.dtype == torch.bfloat16:
        value = value.float()
    arr = value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
    if np.iscomplexobj(arr):
        return np.stack([arr.real, arr.imag]).astype(np.float32)
    return arr


def _field_like(arr, like: torch.Tensor) -> torch.Tensor:
    """A snapshot array as a tensor of ``like``'s dtype, shape and device; a
    complex field is read from its (2, ...) float re/im planes."""
    arr = np.asarray(arr)
    if like.is_complex() and arr.shape == (2, *like.shape) and not np.iscomplexobj(arr):
        arr = arr[0] + 1j * arr[1].astype(np.float64)
    if arr.shape != tuple(like.shape):
        raise ValueError(f"snapshot field of shape {arr.shape} for a state field of shape "
                         f"{tuple(like.shape)}")
    return torch.tensor(arr, dtype=like.dtype, device=like.device)


class SnapshotWriter:
    """Appends step snapshots to an HDF5 file (reference schema)."""

    def __init__(self, path, compression: str | None = "gzip", compression_opts=4):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.compression = compression
        self.compression_opts = compression_opts if compression else None

    def save(self, step: int, time: float, **fields) -> None:
        import h5py

        host_fields = {k: to_host(v) for k, v in fields.items() if v is not None}
        with h5py.File(self.path, "a") as f:
            name = f"step_{step:06d}"
            if name in f:
                return
            g = f.create_group(name)
            g.attrs["time"] = float(time)
            for k, v in host_fields.items():
                g.create_dataset(
                    k,
                    data=v,
                    compression=self.compression,
                    compression_opts=self.compression_opts,
                )


def list_steps(path) -> list[int]:
    import h5py

    with h5py.File(path, "r") as f:
        return sorted(
            int(k.split("_")[1]) for k in f.keys() if k.startswith("step_")
        )


def load_step(path, step: int) -> tuple[dict, float]:
    """Load one snapshot: ({field: np.ndarray}, time)."""
    import h5py

    with h5py.File(path, "r") as f:
        g = f[f"step_{step:06d}"]
        fields = {k: np.asarray(g[k][:]) for k in g.keys()}
        return fields, float(g.attrs["time"])


def load_latest(path) -> tuple[dict, int, float]:
    """Resume support: load the most recent snapshot → (fields, step, time),
    from an HDF5 file or a native ``.csnap`` container."""
    if Path(path).suffix == ".csnap":
        from cfdsim_tpu_torch.io_.native import csnap_steps

        by_step = csnap_steps(path)
        if not by_step:
            raise FileNotFoundError(f"no snapshots in {path}")
        step = max(by_step)
        fields, t = by_step[step]
        return fields, step, t
    steps = list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no snapshots in {path}")
    step = steps[-1]
    fields, t = load_step(path, step)
    return fields, step, t


def restore(state, path):
    """Restore a model state from the latest snapshot of ``path`` (HDF5, or
    a ``.csnap`` container read directly): every field whose name matches a
    snapshot dataset is replaced by it (recursing into nested NamedTuple
    states like transport's CoupledState), on the device of the field it
    replaces (a complex field from its re/im planes, :func:`to_host`); ``t``
    (float32) and ``step`` (int32) are taken from the snapshot's metadata.
    A state type with a ``snapshot_prefix`` (the FEM state, whose
    snapshots also hold grid-sampled fields of the same names) reads its
    fields under that prefix; a field that is None stays None. A field
    whose shape differs from the state's raises ``ValueError``."""
    fields, step, t = load_latest(path)

    def fill(st):
        updates = {}
        matched = 0
        prefix = getattr(type(st), "snapshot_prefix", "")
        for name in st._fields:
            v = getattr(st, name)
            if hasattr(v, "_fields"):
                sub, n = fill(v)
                updates[name] = sub
                matched += n
            elif v is not None and prefix + name in fields:
                updates[name] = _field_like(fields[prefix + name], v)
                matched += 1
        if "t" in st._fields:
            updates["t"] = torch.tensor(np.float32(t), device=st.t.device)
        if "step" in st._fields:
            updates["step"] = torch.tensor(np.int32(step), device=st.step.device)
        return st._replace(**updates), matched

    restored, matched = fill(state)
    if matched == 0:
        raise KeyError(
            f"no snapshot dataset matches state fields {state._fields}"
        )
    return restored
