"""Build and bind the hand-written CUDA kernels.

Each kernel is a ``.cu`` file under ``cfdsim_tpu_torch/csrc/`` with a plain
C entry point. At first use it is compiled by ``nvcc`` for ``sm_90a`` into
a shared library under ``build/cfdsim_tpu_torch/`` at the repository root,
named by a hash of its source and flags (so an edited source rebuilds), and
loaded with ``ctypes``. Nothing is compiled when a module is imported.

Each ``.cu`` file exports its launcher (returning ``cudaGetLastError()``;
a kernel's launcher takes the address of its device-side launch count last)
and ``const char* cfd_cuda_error_string(int)``, so a failed launch raises
with CUDA's own message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from cfdsim_tpu_torch.utils.profiling import KERNEL_BUILD, RECORDER

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "cfdsim_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda); "
        "the CUDA kernels of cfdsim_tpu_torch are built with it at first use"
    )


def build_library(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists;
    return the library's path. Recorded as a ``cfd.kernel.build`` span, and
    a run of nvcc in ``RECORDER.kernel_compiles``; safe from several
    threads (:func:`build_all`)."""
    t0 = time.perf_counter_ns()
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        RECORDER.record(KERNEL_BUILD, t0, time.perf_counter_ns())
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    RECORDER.count_compile()
    RECORDER.record(KERNEL_BUILD, t0, time.perf_counter_ns())
    return lib


class CudaKernel:
    """One hand-written kernel: its source, the C symbol that launches it,
    and a count of its launches.

    The count lives on the device, one uint64 per device the kernel has run
    on: :meth:`__call__` passes its address to the launcher as the last
    argument (after ``argtypes``), and the kernel itself adds one, from one
    thread, each time it runs. So ``launches`` counts the kernel's runs and
    nothing else: a launch replayed from a CUDA graph counts like an eager
    one, and a call that is only being captured, and runs nothing yet, does
    not. Reading ``launches`` waits for the device.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self._counts: dict = {}  # device index -> its one-element int64 count
        self._lib = None
        self._fn = None

    def build(self) -> float:
        """Compile (if needed) and load the library; return the seconds it took."""
        t0 = time.perf_counter()
        if self._fn is None:
            lib = ctypes.CDLL(str(build_library(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.cfd_cuda_error_string.argtypes = [ctypes.c_int]
            lib.cfd_cuda_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return time.perf_counter() - t0

    def library(self) -> ctypes.CDLL:
        """The loaded library (built if needed), for its entry points that
        launch nothing, such as a device query."""
        if self._fn is None:
            self.build()
        return self._lib

    def error_string(self, code: int) -> str:
        return self.library().cfd_cuda_error_string(code).decode()

    @property
    def launches(self) -> int:
        """The times the kernel has run since :meth:`reset_launches`, summed
        over the devices, as the kernel counted them there."""
        return sum(int(c) for c in self._counts.values())

    def reset_launches(self) -> None:
        for c in self._counts.values():
            c.zero_()

    def _count(self):
        """The current device's count; made at the kernel's first call there,
        which must be an eager one (memory allocated under a capture belongs
        to that graph)."""
        index = torch.cuda.current_device()
        if index not in self._counts:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.symbol}: first call on cuda:{index} under a CUDA "
                                   "graph capture; run it once eagerly first")
            self._counts[index] = torch.zeros(1, dtype=torch.int64, device=f"cuda:{index}")
        return self._counts[index]

    def __call__(self, *args) -> None:
        """Launch on the current device (``args`` end with the stream)."""
        if self._fn is None:
            self.build()
        rc = self._fn(*args, self._count().data_ptr())
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {rc} "
                               f"({self.error_string(rc)})")


def report_cost(bytes_moved: float, flops: float) -> None:
    """Tell each active cost count (``utils/roofline.py::CostMode``, a
    dispatch mode, which cannot see a launch through ``ctypes``) what one
    hand-kernel launch moves and computes. A no-op outside a count."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        add = getattr(mode, "add_kernel_cost", None)
        if add is not None:
            add(bytes_moved, flops)


def build_all(kernels, more_sources=()) -> dict:
    """Compile the sources of ``kernels`` and ``more_sources`` in parallel
    (one nvcc per source, all started together), then load every kernel;
    return the seconds each source took to build."""
    sources = sorted({k.source for k in kernels} | set(more_sources))

    def timed(source):
        t0 = time.perf_counter()
        build_library(source)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        seconds = dict(zip(sources, pool.map(timed, sources)))
    for k in kernels:
        k.build()
    return seconds
