"""Build and bind the hand-written CUDA kernels.

Each kernel is a ``.cu`` file under ``cfdsim_tpu_torch/csrc/`` with a plain
C entry point. At first use it is compiled by ``nvcc`` for ``sm_90a`` into
a shared library under ``build/cfdsim_tpu_torch/`` at the repository root,
named by a hash of its source and flags (so an edited source rebuilds), and
loaded with ``ctypes``. Nothing is compiled when a module is imported.

Each ``.cu`` file exports its launcher (returning ``cudaGetLastError()``)
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
    return the library's path."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
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
    return lib


class CudaKernel:
    """One hand-written kernel: its source, the C symbol that launches it,
    and a count of launches.

    ``launches`` is incremented only in :meth:`__call__`, after the C entry
    point reported a successful launch, so a run can show that it went
    through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None

    def build(self) -> float:
        """Compile (if needed) and load the library; return the seconds it took."""
        t0 = time.perf_counter()
        if self._fn is None:
            lib = ctypes.CDLL(str(build_library(self.source)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
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

    def __call__(self, *args) -> None:
        if self._fn is None:
            self.build()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {rc} "
                               f"({self.error_string(rc)})")
        self.launches += 1


def build_all(kernels) -> dict:
    """Compile the sources of ``kernels`` in parallel (one nvcc per source,
    all started together), then load every kernel; return the seconds each
    source took to build."""
    sources = sorted({k.source for k in kernels})

    def timed(source):
        t0 = time.perf_counter()
        build_library(source)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        seconds = dict(zip(sources, pool.map(timed, sources)))
    for k in kernels:
        k.build()
    return seconds
