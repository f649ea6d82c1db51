"""The (py, px) rank grid of a ``torch.distributed`` process group
(``cfdsim_tpu.parallel.mesh``).

Each rank holds one (ny/py, nx/px) block of every (ny, nx) field (of the
two trailing axes of a 3D field). Rank r sits at mesh row iy = r // px and
column ix = r % px, the order of the JAX package's ``reshape(py, px)`` of
its device list. The "x" group of a rank holds the ranks of its mesh row
(the same iy), the "y" group those of its mesh column (the same ix): the
halo exchange and the pencil transposes run inside one of them, as
``lax.ppermute`` and ``lax.all_to_all`` run over one named mesh axis.

A NCCL group works on CUDA tensors and a gloo group on CPU tensors; each
refuses the other's tensors (:meth:`GridMesh.check`) rather than copy them
between host and card. The helpers at the bottom cut a global field into
this rank's block and gather the blocks back: the counterpart of placing a
state with ``NamedSharding(P("y", "x"))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from cfdsim_tpu_torch.utils.tree import tree_map

BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def _factor_2d(n: int) -> tuple[int, int]:
    """Split n devices into the most-square (py, px) factorization."""
    best = (1, n)
    for py in range(1, int(math.isqrt(n)) + 1):
        if n % py == 0:
            best = (py, n // py)
    return best


class GridMesh:
    """A (py, px) grid over the ranks of the initialised process group.

    ``iy``, ``ix`` are this rank's mesh coordinates, ``device`` the device
    its blocks live on, ``backend`` the group's backend. ``group("x")`` is
    the rank's mesh-row group and ``group("y")`` its mesh-column group
    (``None`` along an axis of one shard, where nothing is exchanged)."""

    def __init__(self, py: int, px: int, rank: int, backend: str, device, x_group,
                 y_group):
        self.py, self.px = py, px
        self.rank = rank
        self.iy, self.ix = divmod(rank, px)
        self.backend = backend
        self.device = torch.device(device)
        self._groups = {"x": x_group, "y": y_group}

    @property
    def size(self) -> int:
        return self.py * self.px

    def group(self, axis: str):
        return self._groups[axis]

    def axis_size(self, axis: str) -> int:
        return self.py if axis == "y" else self.px

    def axis_index(self, axis: str) -> int:
        return self.iy if axis == "y" else self.ix

    def check(self, *tensors) -> None:
        """Raise unless every tensor lies on the device type of the backend
        (CUDA for NCCL, the CPU for gloo): nothing is staged through the host."""
        want = BACKEND_DEVICE.get(self.backend)
        for t in tensors:
            if want is not None and t.device.type != want:
                raise ValueError(f"a {self.backend} group takes {want} tensors, got one on "
                                 f"{t.device}")

    def __repr__(self):
        return (f"GridMesh(py={self.py}, px={self.px}, rank={self.rank}, iy={self.iy}, "
                f"ix={self.ix}, backend={self.backend!r}, device={self.device})")


def make_grid_mesh(topology: tuple[int, int] | None = None, device=None) -> GridMesh:
    """A :class:`GridMesh` over the initialised default group, (py, px) =
    ``topology`` or the most square split of the world size. Every rank
    creates every row and column group, in the same order, as
    ``dist.new_group`` requires. ``device`` defaults to the backend's: the
    current CUDA device for NCCL, the CPU for gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid_mesh needs an initialised process group "
                           "(init_distributed or torch.distributed.init_process_group)")
    world = dist.get_world_size()
    py, px = topology if topology is not None else _factor_2d(world)
    if py * px != world:
        raise ValueError(f"topology {py}x{px} != {world} ranks")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    rank = dist.get_rank()
    iy, ix = divmod(rank, px)
    x_group = y_group = None
    if px > 1:
        for row in range(py):
            g = dist.new_group([row * px + j for j in range(px)])
            if row == iy:
                x_group = g
    if py > 1:
        for col in range(px):
            g = dist.new_group([i * px + col for i in range(py)])
            if col == ix:
                y_group = g
    mesh = GridMesh(py, px, rank, backend, device, x_group, y_group)
    mesh.check(torch.empty(0, device=device))
    return mesh


def init_distributed(backend: str, init_method: str, world_size: int, rank: int, device=None,
                     topology: tuple[int, int] | None = None, timeout=None) -> GridMesh:
    """Initialise the default process group and return its mesh.

    ``init_method`` is a rendezvous the caller names (``file://…`` or
    ``tcp://localhost:<port>``): nothing here discovers a cluster. Under
    NCCL ``device`` (default ``cuda:rank``) becomes the current CUDA
    device first; under gloo the blocks live on the CPU. ``timeout`` (a
    ``datetime.timedelta``) bounds each collective's wait. A failed
    initialisation raises."""
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"unknown backend {backend!r}; one of {sorted(BACKEND_DEVICE)}")
    if device is None:
        device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    if device.type != BACKEND_DEVICE[backend]:
        raise ValueError(f"a {backend} group takes {BACKEND_DEVICE[backend]} tensors, not "
                         f"{device}")
    kwargs = {} if timeout is None else {"timeout": timeout}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            **kwargs)
    return make_grid_mesh(topology, device)


# ---------------------------------------------------------------------------
# blocks of global fields
# ---------------------------------------------------------------------------

def block_slices(shape, mesh: GridMesh) -> tuple[slice, slice]:
    """(rows, cols) of this rank's block of a field whose two trailing axes
    are ``shape[-2:]``; raises unless they divide evenly."""
    ny, nx = shape[-2:]
    if ny % mesh.py or nx % mesh.px:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {mesh.py}x{mesh.px}")
    ny_l, nx_l = ny // mesh.py, nx // mesh.px
    return (slice(mesh.iy * ny_l, (mesh.iy + 1) * ny_l),
            slice(mesh.ix * nx_l, (mesh.ix + 1) * nx_l))


def local_block(field, mesh: GridMesh) -> torch.Tensor:
    """This rank's block of a global (…, ny, nx) field (numpy or tensor), a
    new contiguous tensor on the mesh's device."""
    if not torch.is_tensor(field):
        field = torch.as_tensor(np.asarray(field))
    rows, cols = block_slices(field.shape, mesh)
    return field[..., rows, cols].to(mesh.device).clone().contiguous()


def local_rows(vector, mesh: GridMesh) -> torch.Tensor:
    """This rank's slice of a global (ny,) vector along y (a ``P("y")``
    block, such as the cylinder's y coordinates)."""
    if not torch.is_tensor(vector):
        vector = torch.as_tensor(np.asarray(vector))
    n = vector.shape[0]
    if n % mesh.py:
        raise ValueError(f"{n} rows not divisible by {mesh.py}")
    n_l = n // mesh.py
    return vector[mesh.iy * n_l:(mesh.iy + 1) * n_l].to(mesh.device).clone()


def gather_blocks(block: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The global field from every rank's (…, ny_l, nx_l) block, on every
    rank (one ``all_gather`` over the world)."""
    mesh.check(block)
    block = block.detach().contiguous()
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    dist.all_gather(parts, block)
    rows = [torch.cat(parts[i * mesh.px:(i + 1) * mesh.px], -1) for i in range(mesh.py)]
    return torch.cat(rows, -2)


def block_state(state, mesh: GridMesh):
    """A state of global fields → this rank's blocks (every leaf of two or
    more axes is cut; 0-dim leaves are copied to the mesh's device)."""
    return tree_map(lambda x: local_block(x, mesh) if x.ndim >= 2
                    else x.to(mesh.device).clone(), state)


def gather_state(state, mesh: GridMesh):
    """A state of blocks → the state of global fields, on every rank."""
    return tree_map(lambda x: gather_blocks(x, mesh) if x.ndim >= 2 else x.detach().clone(),
                    state)


# ---------------------------------------------------------------------------
# reductions over the whole mesh
# ---------------------------------------------------------------------------

def _quiet(fn, *args, **kwargs):
    """Call a ``torch.distributed.nn.functional`` collective without its
    deprecation notice (newer torch points at the functional collectives;
    these autograd-aware forms are the ones in every version used here)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def psum(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The sum of ``x`` over every rank (``lax.psum`` over both mesh axes),
    one ``all_reduce`` in the backend's order; differentiable (its backward
    is the same sum of the cotangents)."""
    from torch.distributed.nn.functional import all_reduce

    mesh.check(x)
    return _quiet(all_reduce, x, op=dist.ReduceOp.SUM)


class _AllReduceMax(torch.autograd.Function):
    """The elementwise max over every rank. Backward: every rank's copy of
    the max feeds its own loss, so the cotangents are summed over the ranks
    and go to the rank(s) whose input attained the max, split evenly among
    ties (as ``torch.amax`` splits them)."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        ctx.save_for_backward(x.detach(), y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        win = (x == y).to(g.dtype)
        ties = win.clone()
        dist.all_reduce(ties, op=dist.ReduceOp.SUM)
        return g * win / ties


def pmax(x: torch.Tensor, mesh: GridMesh) -> torch.Tensor:
    """The elementwise max of ``x`` over every rank (``lax.pmax``; exact, so
    the order of the reduction does not matter); differentiable."""
    mesh.check(x)
    return _AllReduceMax.apply(x)
