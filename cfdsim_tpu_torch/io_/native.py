"""ctypes bindings for the native async snapshot writer (``native/csnap.cc``,
the JAX package's source, which this package compiles and does not edit;
``cfdsim_tpu.io_.native``).

The C++ tier compresses and writes snapshots on a background thread so the
stepping loop never blocks on disk I/O. The library is built at first use
with g++ (and zlib) into ``build/cfdsim_tpu_torch/`` at the repository
root, named by a hash of the source; a missing toolchain raises
``NativeUnavailable`` where the writer is made. ``csnap_append`` copies the
array before it returns, so the caller's buffer may be reused at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import zlib
from pathlib import Path

import numpy as np

from cfdsim_tpu_torch.io_.hdf5 import to_host

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "csnap.cc"
_BUILD_DIR = _REPO_ROOT / "build" / "cfdsim_tpu_torch"

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int32}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
                np.dtype(np.int32): 2}


class NativeUnavailable(RuntimeError):
    pass


_lib_cache = None


def _build_lib() -> ctypes.CDLL:
    global _lib_cache
    if _lib_cache is not None:
        return _lib_cache
    if not _SRC.exists():
        raise NativeUnavailable(f"source missing: {_SRC}")
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libcsnap-{digest}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               str(_SRC), "-o", str(tmp), "-lz", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(
                f"csnap build failed: {e}\n{getattr(e, 'stderr', '')}") from e
        os.replace(tmp, lib_path)  # atomic: no loader sees a partial file
    lib = ctypes.CDLL(str(lib_path))
    lib.csnap_open.restype = ctypes.c_void_p
    lib.csnap_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.csnap_append.restype = ctypes.c_int
    lib.csnap_append.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.csnap_flush.argtypes = [ctypes.c_void_p]
    lib.csnap_pending.restype = ctypes.c_int64
    lib.csnap_pending.argtypes = [ctypes.c_void_p]
    lib.csnap_error.restype = ctypes.c_int
    lib.csnap_error.argtypes = [ctypes.c_void_p]
    lib.csnap_close.argtypes = [ctypes.c_void_p]
    _lib_cache = lib
    return lib


class NativeSnapshotWriter:
    """Async snapshot writer with the SnapshotWriter.save() interface.

    ``max_pending`` bounds the in-flight queue (each entry holds a full
    field copy): when exceeded, ``save`` blocks until the worker drains —
    backpressure instead of unbounded host memory growth."""

    def __init__(self, path, level: int = 4, max_pending: int = 64):
        self._lib = _build_lib()
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.max_pending = max_pending
        self._h = self._lib.csnap_open(str(self.path).encode(), level)
        if not self._h:
            raise NativeUnavailable(f"csnap_open failed for {self.path}")

    def save(self, step: int, time: float, **fields) -> None:
        import time as _time

        while self.pending() > self.max_pending:
            _time.sleep(0.005)
        for name, value in fields.items():
            if value is None:
                continue
            arr = np.ascontiguousarray(to_host(value))
            code = _DTYPE_CODES.get(arr.dtype)
            if code is None:
                arr = arr.astype(np.float32)
                code = 0
            shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            rc = self._lib.csnap_append(
                self._h, name.encode(), step, float(time),
                arr.ctypes.data_as(ctypes.c_void_p), code, arr.ndim, shape,
            )
            if rc != 0:
                raise IOError(f"csnap_append failed (rc={rc}) for {name}")

    def pending(self) -> int:
        return int(self._lib.csnap_pending(self._h))

    def flush(self) -> None:
        """Block until the queue drains; raise if any record was lost to a
        compression or disk I/O failure (the worker records a sticky error
        flag instead of dropping silently)."""
        self._lib.csnap_flush(self._h)
        if self._lib.csnap_error(self._h):
            raise IOError(
                f"csnap writer lost records (compression or disk I/O "
                f"failure) writing {self.path}"
            )

    def close(self) -> None:
        if self._h:
            err = self._lib.csnap_error(self._h)
            self._lib.csnap_close(self._h)
            self._h = None
            if err:
                raise IOError(
                    f"csnap writer lost records writing {self.path}"
                )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_csnap(path, strict: bool = False):
    """Parse a .csnap file → list of {name, step, time, array} records
    (pure Python; format documented in native/csnap.cc).

    A truncated final record (process killed mid-write — likely with an
    async writer) stops the parse and returns the records read so far with
    a warning; pass ``strict=True`` to raise instead."""
    import warnings

    records = []
    raw = Path(path).read_bytes()
    if raw[:6] != b"CSNP1\n":
        raise ValueError(f"{path} is not a csnap file")
    off = 6
    n = len(raw)

    def truncated():
        if strict:
            raise IOError(f"truncated csnap record at offset {off} in {path}")
        warnings.warn(
            f"{path}: truncated final record at offset {off}; returning "
            f"{len(records)} complete records"
        )

    while off < n:
        try:
            if off + 4 > n:
                raise ValueError
            (name_len,) = np.frombuffer(raw, np.uint32, 1, off)
            head_end = off + 4 + int(name_len) + 4 + 8 + 1 + 4
            if head_end > n:
                raise ValueError
            o = off + 4
            name = raw[o : o + name_len].decode()
            o += name_len
            (step,) = np.frombuffer(raw, np.int32, 1, o)
            o += 4
            (time,) = np.frombuffer(raw, np.float64, 1, o)
            o += 8
            dtype_code = raw[o]
            o += 1
            (ndim,) = np.frombuffer(raw, np.int32, 1, o)
            o += 4
            if not (0 <= ndim <= 8) or o + 8 * int(ndim) + 16 > n:
                raise ValueError
            shape = tuple(np.frombuffer(raw, np.int64, ndim, o))
            o += 8 * ndim
            (raw_size,) = np.frombuffer(raw, np.uint64, 1, o)
            o += 8
            (comp_size,) = np.frombuffer(raw, np.uint64, 1, o)
            o += 8
            if o + int(comp_size) > n:
                raise ValueError
            blob = zlib.decompress(
                raw[o : o + int(comp_size)], bufsize=int(raw_size)
            )
            o += int(comp_size)
            arr = np.frombuffer(blob, _DTYPES[dtype_code]).reshape(shape)
        except (ValueError, zlib.error, KeyError, UnicodeDecodeError):
            truncated()
            break
        records.append(
            {"name": name, "step": int(step), "time": float(time), "array": arr}
        )
        off = o
    return records


def csnap_steps(path) -> dict[int, tuple[dict, float]]:
    """Group records into the HDF5-reader shape: {step: (fields, time)}."""
    out: dict[int, tuple[dict, float]] = {}
    for r in read_csnap(path):
        fields, _ = out.setdefault(r["step"], ({}, r["time"]))
        fields[r["name"]] = r["array"]
    return out


def csnap_to_hdf5(csnap_path, h5_path):
    """Convert a .csnap container to the reference's HDF5 schema."""
    from cfdsim_tpu_torch.io_.hdf5 import SnapshotWriter

    w = SnapshotWriter(h5_path)
    for step, (fields, time) in sorted(csnap_steps(csnap_path).items()):
        w.save(step, time, **fields)
    return Path(h5_path)
