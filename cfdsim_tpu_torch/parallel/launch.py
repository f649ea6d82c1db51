"""Start a group of ranks, one process each, and collect rank 0's result.

The JAX package runs its multi-device tests on virtual CPU devices inside
one process; a ``torch.distributed`` group needs one process per rank.
:func:`spawn` starts them with ``torch.multiprocessing.spawn``: on the
cards by default (NCCL, rank r on ``cuda:r``, at most one rank per card),
or with ``device="cpu"`` on gloo, each rank on one torch thread. The ranks
meet through a ``file://`` rendezvous in a fresh temporary directory (never
a fixed TCP port, so that several groups can run side by side), and
:func:`spawn` returns what ``fn`` returned on rank 0, passed back through a
file that rank 0 writes. A rank that raises makes :func:`spawn` raise.

``fn(mesh, *args)`` must be importable by name (a module-level function):
each rank imports its module afresh.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cfdsim_tpu_torch.parallel.mesh import BACKEND_DEVICE, init_distributed


def _rank_main(rank: int, fn, world_size: int, topology, args, backend: str, workdir: str,
               timeout_s: float):
    torch.set_num_threads(1)
    mesh = init_distributed(backend, f"file://{os.path.join(workdir, 'rendezvous')}",
                            world_size, rank, topology=topology,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(mesh, *args)
        if rank == 0:
            with open(os.path.join(workdir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, topology=None, *args, device: str = "cuda",
          timeout_s: float = 600.0):
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks (a (py, px) mesh of
    ``topology``, or the most square one) and return rank 0's result.
    ``device="cuda"`` puts one NCCL rank on each of the first
    ``world_size`` cards and raises if there are fewer; ``device="cpu"``
    runs gloo ranks on the CPU. A collective that waits longer than
    ``timeout_s`` raises in its rank, and a group still running after it
    is ended with ``TimeoutError``."""
    kind = torch.device(device).type
    backend = {dev: b for b, dev in BACKEND_DEVICE.items()}.get(kind)
    if backend is None:
        raise ValueError(f"spawn runs on 'cuda' (NCCL) or 'cpu' (gloo), not {device!r}")
    if kind == "cuda" and world_size > torch.cuda.device_count():
        raise RuntimeError(f"{world_size} NCCL ranks need {world_size} CUDA devices, found "
                           f"{torch.cuda.device_count()} (NCCL puts no two ranks on one "
                           "device; pass device='cpu' for gloo ranks)")
    workdir = tempfile.mkdtemp(prefix="cfdsim_ranks_")
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, world_size, topology, args, backend,
                                                   workdir, timeout_s),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world_size} ranks still running after {timeout_s} s")
        with open(os.path.join(workdir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
