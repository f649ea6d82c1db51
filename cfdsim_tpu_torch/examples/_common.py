"""What the example drivers share: the device flag, the snapshot container,
the report file and the deferred render.

Every driver takes ``--device`` (default ``cuda``; without CUDA it exits
unless given ``--device cpu``: nothing falls back) and ``--io {native,hdf5}``
(default ``native``: the card's machine has no h5py). Each writes its
snapshots (or, where the JAX driver writes none, its final state) into
``<out>/snapshots.csnap`` or ``<out>/snapshots.h5`` and its printed report
into ``<out>/report.json``. Rendering (frames, plots, video) runs only with
``--render``, and then needs matplotlib (and h5py to read a snapshot file
back): a missing package raises, nothing is skipped.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
from torch import nn


def add_common_args(ap: argparse.ArgumentParser, out: str, render: bool = True):
    """``--device``, ``--io``, ``--out`` (default ``out``) and, where the
    driver renders, ``--render``."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without CUDA pass --device cpu")
    ap.add_argument("--io", choices=("native", "hdf5"), default="native",
                    help="snapshot container: native .csnap (default) or HDF5 (needs h5py)")
    ap.add_argument("--out", default=out)
    if render:
        ap.add_argument("--render", action="store_true",
                        help="render frames and plots after the run (needs matplotlib)")


def device_of(name) -> torch.device:
    """The device ``name``; exits when it is CUDA and there is none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available here (pass --device cpu "
                         "to run on the CPU)")
    return device


def snapshot_writer(out, io: str):
    """(writer, path): the native async writer of ``<out>/snapshots.csnap``
    or the HDF5 writer of ``<out>/snapshots.h5``. Close it with
    :func:`close_writer`."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    if io == "native":
        from cfdsim_tpu_torch.io_.native import NativeSnapshotWriter

        path = out / "snapshots.csnap"
        return NativeSnapshotWriter(path), path
    if io != "hdf5":
        raise ValueError(f"--io {io!r}: one of native, hdf5")
    from cfdsim_tpu_torch.io_ import SnapshotWriter

    path = out / "snapshots.h5"
    return SnapshotWriter(path), path


def close_writer(writer) -> None:
    """Drain and close a writer (the native one writes on a thread)."""
    if hasattr(writer, "close"):
        writer.close()


def save_final_state(out, io: str, state) -> Path:
    """Write ``state``'s fields (as the CLI's ``run`` writes them) at its step
    and time; returns the path."""
    from cfdsim_tpu_torch.__main__ import _snapshot_fields

    writer, path = snapshot_writer(out, io)
    try:
        writer.save(int(state.step), float(state.t), **_snapshot_fields(state))
    finally:
        close_writer(writer)
    return path


def as_hdf5(path) -> Path:
    """An HDF5 file of the snapshots at ``path`` (a ``.csnap`` is converted
    beside it): what the renderer reads."""
    path = Path(path)
    if path.suffix == ".csnap":
        from cfdsim_tpu_torch.io_.native import csnap_to_hdf5

        return csnap_to_hdf5(path, path.with_suffix(".h5"))
    return path


def _plain(value):
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (np.generic, np.ndarray)):
        return value.tolist()
    if torch.is_tensor(value):
        return value.detach().cpu().tolist()
    if isinstance(value, Path):
        return str(value)
    return value


def write_report(out, report: dict) -> Path:
    """``<out>/report.json``: the driver's report, numbers as plain JSON."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "report.json"
    path.write_text(json.dumps(_plain(report), indent=1))
    return path


class Probed(nn.Module):
    """``step`` whose metrics are replaced by what ``probe(state, metrics)``
    reads after it (a NamedTuple of float32 0-dim tensors: a probe value, the
    body force, t), so that a chunk stacks them per step as the JAX drivers'
    scans do. It keeps the step's route facts (device, host reads)."""

    def __init__(self, step, probe):
        super().__init__()
        self.inner, self.probe = step, probe
        self.device = step.device
        self.reads_host = getattr(step, "reads_host", True)
        self.collectives = getattr(step, "collectives", False)

    def forward(self, state, cfl_scale):
        state, m = self.inner(state, cfl_scale)
        return state, self.probe(state, m)


def run_probed(case, probe, chunk_steps: int, t_final: float, on_chunk=None):
    """Chunks of ``chunk_steps`` steps of ``case.step`` (``make_chunk``: one
    captured CUDA graph on the card) until t ≥ ``t_final``, with ``probe``'s
    values stacked per step: (state, {field: numpy array over every step}).
    ``on_chunk(state, values)`` sees each chunk's values (progress lines)."""
    from cfdsim_tpu_torch.models.incompressible import make_chunk

    chunk = make_chunk(case.cfg, Probed(case.step, probe), chunk_steps)
    state, parts = case.state, []
    while float(state.t) < t_final:
        state, vals = chunk(state, 1.0)
        host = dict(zip(vals._fields, torch.stack(list(vals)).cpu().numpy()))
        parts.append(host)
        if on_chunk is not None:
            on_chunk(state, host)
    if not parts:
        return state, {}
    return state, {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def add_rank_args(ap: argparse.ArgumentParser, out: str, ranks_help: str = ""):
    """The sharded drivers' ``--device`` (cuda: one NCCL rank per card;
    cpu: gloo ranks), ``--ranks`` (default: every card, or 4 gloo ranks),
    ``--topology PYxPX`` and ``--out``."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): one NCCL rank per card; cpu: gloo ranks")
    ap.add_argument("--ranks", type=int, default=None,
                    help=ranks_help or "ranks (default: the cards, or 4 gloo ranks)")
    ap.add_argument("--topology", default=None, help="PYxPX, e.g. 2x2 (default: most square)")
    ap.add_argument("--out", default=out)


def ranks_of(args) -> tuple[int, tuple | None]:
    """(world size, topology) from ``--ranks``/``--topology``; exits on
    ``--device cuda`` without CUDA."""
    device_of(args.device)
    ranks = args.ranks
    if ranks is None:
        ranks = torch.cuda.device_count() if args.device == "cuda" else 4
    topology = None if args.topology is None else tuple(
        int(k) for k in args.topology.lower().split("x"))
    return ranks, topology
