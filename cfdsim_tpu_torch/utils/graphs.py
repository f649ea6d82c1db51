"""A function captured once into a CUDA graph and replayed: the one capture
helper of the package. ``models/incompressible.py::make_chunk`` runs a chunk
of steps through it and ``utils/profiling.py::device_ms`` times calls
through it.
"""

from __future__ import annotations

import ctypes
import gc

import torch

from cfdsim_tpu_torch.utils.profiling import CAPTURE_RECORD, RECORDER

# a captured cuFFT execution runs on its plan's device memory: the plan must
# outlive the graph. PyTorch's plan cache (``torch.backends.cuda.
# cufft_plan_cache``, 4096 plans a device by default) destroys its least
# recently used plan when it is full, and a replay of a graph whose plan was
# destroyed reads freed memory (an illegal address, or a segfault). While a
# program lives the cache may therefore not evict: a capture lifts its
# max_size to PINNED_PLANS. Replaying after the cache was cleared or shrunk
# raises instead (a best-effort check of its size).
PINNED_PLANS = 1 << 30


def _plan_cache():
    return torch.backends.cuda.cufft_plan_cache[torch.cuda.current_device()]


class CapturedProgram:
    """``fn()`` as one device program.

    ``fn`` reads and writes tensors that outlive the call (its static
    buffers); it must read nothing back to the host. Construction runs it
    once eagerly on a side stream (cuFFT plans, kernel build and load, the
    allocator's first blocks), then captures one call with
    ``torch.cuda.graph``, the garbage collector paused. A capture that fails
    raises. :meth:`replay` queues
    the program on the current stream without a synchronisation.

    The cuFFT plans the program runs stay alive as long as it does: the
    plan cache's eviction is lifted at capture (``PINNED_PLANS``), and a
    replay after the cache was cleared or shrunk below its size at capture
    raises ``RuntimeError``.

    ``capture_seconds`` is the host time of capture and instantiation, read
    from its ``cfd.capture.record`` span (``utils/profiling.py``). Each
    capture counts in ``RECORDER.graph_captures``.
    With ``keep_graph`` (PyTorch 2.8 or later) the graph is kept beside its
    executable, so that :attr:`nodes` can count its nodes; a caller that
    only runs the program does not ask for it.
    """

    def __init__(self, fn, keep_graph: bool = False):
        self._plans = _plan_cache()
        if self._plans.max_size < PINNED_PLANS:
            self._plans.max_size = PINNED_PLANS
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with RECORDER.span(CAPTURE_RECORD) as record:
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
                # a kept graph is otherwise instantiated at its first replay
                self.graph.instantiate()
        self.capture_seconds = record.seconds
        RECORDER.graph_captures += 1
        self.plans_at_capture = self._plans.size
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
        if self._plans.size < self.plans_at_capture:
            raise RuntimeError(
                f"the cuFFT plan cache holds {self._plans.size} plans, fewer than the "
                f"{self.plans_at_capture} at this program's capture: it was cleared or shrunk, "
                "and a plan the graph runs may be destroyed; capture the program again")
        self.graph.replay()
        self.replays += 1
