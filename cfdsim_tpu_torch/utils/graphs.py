"""A function captured once into a CUDA graph and replayed: the one capture
helper of the package. ``models/incompressible.py::make_chunk`` runs a chunk
of steps through it and ``utils/profiling.py::device_ms`` times calls
through it.
"""

from __future__ import annotations

import ctypes
import gc
import time

import torch


class CapturedProgram:
    """``fn()`` as one device program.

    ``fn`` reads and writes tensors that outlive the call (its static
    buffers); it must read nothing back to the host. Construction runs it
    once eagerly on a side stream (cuFFT plans, kernel build and load, the
    allocator's first blocks), then captures one call with
    ``torch.cuda.graph``, the garbage collector paused. A capture that fails
    raises. :meth:`replay` queues
    the program on the current stream without a synchronisation.

    ``capture_seconds`` is the host time of capture and instantiation.
    With ``keep_graph`` (PyTorch 2.8 or later) the graph is kept beside its
    executable, so that :attr:`nodes` can count its nodes; a caller that
    only runs the program does not ask for it.
    """

    def __init__(self, fn, keep_graph: bool = False):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(**({"keep_graph": True} if keep_graph else {}))
        # no garbage collection inside the capture: a collected cycle that
        # holds another program would release its graph and memory pool
        # there, and that invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                fn()
        finally:
            if collecting:
                gc.enable()
        if keep_graph:
            self.graph.instantiate()  # a kept graph is otherwise instantiated at its first replay
        self.capture_seconds = time.perf_counter() - t0
        self.kept = keep_graph
        self.replays = 0

    @property
    def nodes(self) -> int:
        """The graph's node count, asked of the CUDA runtime."""
        if not self.kept:
            raise RuntimeError("the graph was not kept: capture with keep_graph=True to count "
                               "its nodes")
        cudart = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
        cudart.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_size_t)]
        cudart.cudaGraphGetNodes.restype = ctypes.c_int
        n = ctypes.c_size_t(0)
        rc = cudart.cudaGraphGetNodes(self.graph.raw_cuda_graph(), None, ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"cudaGraphGetNodes failed: CUDA error {rc}")
        return n.value

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
