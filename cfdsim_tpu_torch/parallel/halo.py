"""Halo exchange between neighbouring blocks (``cfdsim_tpu.parallel.halo``).

The reference's ghost-cell layout made inter-rank: each rank holds a
(ny/py, nx/px) block of a field and swaps edge lines with its mesh
neighbours before a stencil runs. Along one mesh axis the ranks form a
non-circular chain (``dist.batch_isend_irecv`` with the neighbours along
that axis, the counterpart of ``lax.ppermute`` with the pairs (i, i+1)):
the ends of the chain receive zero halos, and an axis of one shard
exchanges nothing.
Exchanging y first and then x on the y-padded block fills the corners.

The exchange is a ``torch.autograd.Function``: its backward sends each
halo's cotangent back to the rank that sent the lines and adds it into
that rank's edge lines, the transpose of ``ppermute``. Every rank runs the
same exchanges in the same order (the mesh coordinates only decide what is
written locally), so sends and receives always pair up. The messages go to
the neighbours' global ranks in the world group: one batch may then carry
both axes, as :func:`halo_exchange_edges` does for the 5-point stencils (one
round of messages where the exchange with corners takes two: on gloo the
exchanges are latency-bound).

The global-index helpers read the mesh coordinates where the JAX package
calls ``lax.axis_index``; they act on the two trailing axes, so a stack of
fields (k, ny_l, nx_l) or a 3D block (nz, ny_l, nx_l) goes through one
exchange.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cfdsim_tpu_torch.parallel.mesh import GridMesh

# mesh axis → data axis of a block (the two trailing axes are (y, x))
_DATA_AXIS = {"y": -2, "x": -1}


def _neighbours(mesh: GridMesh, axis_name: str):
    """(previous, next) rank along the mesh axis, None past the chain's ends."""
    i, n = mesh.axis_index(axis_name), mesh.axis_size(axis_name)
    step = mesh.px if axis_name == "y" else 1
    prev = mesh.rank - step if i > 0 else None
    nxt = mesh.rank + step if i < n - 1 else None
    return prev, nxt


def _swap(mesh: GridMesh, axes, sends, likes):
    """One ``batch_isend_irecv``: along each mesh axis, send (to_prev,
    to_next) to the previous and next rank and receive (from_prev,
    from_next), zeros where there is no neighbour. The peers are global
    ranks of the world group, so one batch can hold both axes."""
    ops, received = [], []
    for axis_name, (to_prev, to_next), like in zip(axes, sends, likes):
        prev, nxt = _neighbours(mesh, axis_name)
        from_prev, from_next = torch.zeros_like(like), torch.zeros_like(like)
        for peer, out, inc in ((prev, to_prev, from_prev), (nxt, to_next, from_next)):
            if peer is not None:
                ops += [dist.P2POp(dist.isend, out.contiguous(), peer),
                        dist.P2POp(dist.irecv, inc, peer)]
        received.append((from_prev, from_next))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received


class _Exchange(torch.autograd.Function):
    """For each mesh axis in ``axes``: (lo, hi) = the previous shard's last
    ``width`` lines and the next shard's first ``width`` lines, all axes in
    one round of messages."""

    @staticmethod
    def forward(ctx, block, mesh, axes, width):
        ctx.mesh, ctx.axes, ctx.width, ctx.shape = mesh, axes, width, block.shape
        sends, likes = [], []
        for axis_name in axes:
            axis = _DATA_AXIS[axis_name]
            n = block.shape[axis]
            first = block.narrow(axis, 0, width)
            sends.append((first, block.narrow(axis, n - width, width)))
            likes.append(first)
        return tuple(t for pair in _swap(mesh, axes, sends, likes) for t in pair)

    @staticmethod
    def backward(ctx, *grads):
        w = ctx.width
        ref = next(g for g in grads if g is not None)
        grad = torch.zeros(ctx.shape, dtype=ref.dtype, device=ref.device)
        sends, likes = [], []
        for k, axis_name in enumerate(ctx.axes):
            edge = grad.narrow(_DATA_AXIS[axis_name], 0, w)
            g_lo, g_hi = grads[2 * k], grads[2 * k + 1]
            # the lo halo came from the previous rank's last lines: its
            # cotangent goes back there, and the hi halo's to the next rank
            sends.append((torch.zeros_like(edge) if g_lo is None else g_lo,
                          torch.zeros_like(edge) if g_hi is None else g_hi))
            likes.append(edge)
        for axis_name, (from_prev, from_next) in zip(ctx.axes, _swap(ctx.mesh, ctx.axes, sends,
                                                                     likes)):
            axis = _DATA_AXIS[axis_name]
            n = grad.shape[axis]
            # what the previous rank sends back belongs to our first lines,
            # what the next one sends to our last lines
            grad.narrow(axis, 0, w).add_(from_prev)
            grad.narrow(axis, n - w, w).add_(from_next)
        return grad, None, None, None


def _exchange(block, mesh: GridMesh, axes, width: int):
    """[(lo, hi) per mesh axis]: lines received from the previous/next shard;
    zero-filled at the ends of the (non-circular) chain and along an axis
    of one shard."""
    mesh.check(block)
    live = tuple(a for a in axes if mesh.axis_size(a) > 1)
    got = iter(_Exchange.apply(block, mesh, live, width) if live else ())
    out = []
    for axis_name in axes:
        if axis_name in live:
            out.append((next(got), next(got)))
        else:
            edge = torch.zeros_like(block.narrow(_DATA_AXIS[axis_name], 0, width))
            out.append((edge, edge.clone()))
    return out


def _exchange_axis(block, mesh: GridMesh, axis_name: str, width: int = 1):
    """(lo_halo, hi_halo) lines received from the previous/next shard along
    one mesh axis (``lax.ppermute`` with the pairs (i, i+1) and (i+1, i))."""
    return _exchange(block, mesh, (axis_name,), width)[0]


def halo_exchange(block, mesh: GridMesh, width: int = 1):
    """Pad a local (…, ny_l, nx_l) block with ``width`` halo lines on every
    side of its two trailing axes, filled from the mesh neighbours (y
    first, then x on the y-padded block, which covers the corners)."""
    lo_y, hi_y = _exchange_axis(block, mesh, "y", width)
    block = torch.cat([lo_y, block, hi_y], -2)
    lo_x, hi_x = _exchange_axis(block, mesh, "x", width)
    return torch.cat([lo_x, block, hi_x], -1)


def halo_exchange_edges(block, mesh: GridMesh, width: int = 1):
    """:func:`halo_exchange` without the corners (left zero), in one round of
    messages for both axes where the full exchange takes two: for the
    plus-shaped (5-point) stencils, which never read a corner."""
    (lo_y, hi_y), (lo_x, hi_x) = _exchange(block, mesh, ("y", "x"), width)
    rows = torch.cat([lo_y, block, hi_y], -2)
    pad = [0, 0, width, width]
    return torch.cat([torch.nn.functional.pad(lo_x, pad), rows,
                      torch.nn.functional.pad(hi_x, pad)], -1)


def clamp_global_edges(padded, mesh: GridMesh, width: int = 1):
    """Overwrite the halo lines that lie outside the *global* domain with
    the adjacent edge line (ghost = edge), the Neumann clamped-edge
    convention across the mesh. A new tensor; only the ranks on the global
    boundary change anything."""
    padded = padded.clone()
    first_y, last_y = mesh.iy == 0, mesh.iy == mesh.py - 1
    first_x, last_x = mesh.ix == 0, mesh.ix == mesh.px - 1
    ny, nx = padded.shape[-2:]
    for w in range(width):
        top = width - 1 - w  # halo line index from the outside in
        bot = ny - width + w
        if first_y:
            padded[..., top, :] = padded[..., width, :]
        if last_y:
            padded[..., bot, :] = padded[..., ny - width - 1, :]
        lft = width - 1 - w
        rgt = nx - width + w
        if first_x:
            padded[..., :, lft] = padded[..., :, width]
        if last_x:
            padded[..., :, rgt] = padded[..., :, nx - width - 1]
    return padded


def global_indices(local_shape, mesh: GridMesh, halo: int = 0):
    """(rows, cols) int32 global-index grids of a local (ny_l, nx_l) block
    padded by ``halo`` lines (the JAX package's ``_grids``)."""
    ny_l, nx_l = local_shape
    rows = mesh.iy * ny_l - halo + torch.arange(ny_l + 2 * halo, dtype=torch.int32,
                                                device=mesh.device)
    cols = mesh.ix * nx_l - halo + torch.arange(nx_l + 2 * halo, dtype=torch.int32,
                                                device=mesh.device)
    return rows[:, None].expand(-1, nx_l + 2 * halo), cols[None, :].expand(ny_l + 2 * halo, -1)


def global_parity(local_shape, mesh: GridMesh):
    """Checkerboard parity mask (gi + gj) % 2 == 0 in *global* indices for a
    local block."""
    rows, cols = global_indices(local_shape, mesh)
    return ((rows + cols) % 2) == 0


def global_interior_mask(local_shape, mesh: GridMesh, width: int = 1):
    """True on nodes at least ``width`` from the *global* boundary: restores
    the single-device ops' zero frame."""
    rows, cols = global_indices(local_shape, mesh)
    ny_g = mesh.py * local_shape[0]
    nx_g = mesh.px * local_shape[1]
    return (rows >= width) & (rows < ny_g - width) & (cols >= width) & (cols < nx_g - width)


def sharded_stencil(op, blocks, mesh: GridMesh, width: int = 1, *, corners: bool = True,
                    clamp: bool = False, mask=None):
    """Apply a single-device stencil op (zero-frame convention) to blocks of
    one shape: one halo exchange for the stack of them, ``op`` on the padded
    blocks, crop, and zero the global frame (``mask``, by default the
    interior ``width`` from the global boundary), so results match the
    unsharded op. ``corners=False`` exchanges the edges only, in one round
    of messages, for plus-shaped ops, which read no corner; ``clamp`` gives
    the global edges the op's own edge padding (:func:`clamp_global_edges`)."""
    exchange = halo_exchange if corners else halo_exchange_edges
    padded = exchange(torch.stack(tuple(blocks)), mesh, width)
    if clamp:
        padded = clamp_global_edges(padded, mesh, width)
    out = op(*padded.unbind(0))
    outs = out if isinstance(out, tuple) else (out,)
    if mask is None:
        mask = global_interior_mask(tuple(blocks[0].shape), mesh, width)
    w = width
    cropped = tuple(torch.where(mask, o[w:-w, w:-w], 0.0) for o in outs)
    return cropped if isinstance(out, tuple) else cropped[0]


def make_sharded_stencil(op, mesh: GridMesh, n_in: int = 1, width: int = 1):
    """Lift a single-device stencil op (zero-frame convention) to blocks:
    ``sharded(*blocks)`` runs :func:`sharded_stencil` with the corners, so
    results match the unsharded op whatever its shape."""

    def sharded(*blocks):
        if len(blocks) != n_in:
            raise ValueError(f"the stencil takes {n_in} blocks, got {len(blocks)}")
        return sharded_stencil(op, blocks, mesh, width)

    return sharded
