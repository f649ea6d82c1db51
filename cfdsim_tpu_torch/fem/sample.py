"""FE-solution sampling onto a structured grid or a point list
(``cfdsim_tpu.fem.sample``).

Point location runs once on the host (a copy of the JAX package's:
centroid-KDTree candidate search and a barycentric test), producing static
gather and basis tables on the device; sampling is then one gather and a
few einsums, including the exact FE velocity gradient, so the vorticity is
the element-wise ∂v/∂x − ∂u/∂y. Points outside the fluid (inside the
cylinder) are NaN.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

from cfdsim_tpu_torch.fem.assembly import _basis_tables
from cfdsim_tpu_torch.fem.spaces import FESpaces


@dataclasses.dataclass(frozen=True, eq=False)
class SampleTable:
    """Static sampling tables for a fixed point set (ns points).

    idx : (ns, nloc_u) velocity DOF gather indices
    idx_p : (ns, 3) pressure DOF gather indices
    N / Np : (ns, nloc) float32 basis values at each point
    G : (ns, nloc_u, 2) float32 physical basis gradients (for vorticity)
    valid : (ns,) False outside the fluid (NaN in outputs)
    shape : original point-grid shape, outputs are reshaped to it
    """

    idx: torch.Tensor
    idx_p: torch.Tensor
    N: torch.Tensor
    Np: torch.Tensor
    G: torch.Tensor
    valid: torch.Tensor
    shape: tuple


def _locate(mesh, pts, k=24):
    """Containing triangle + barycentric coords per point (host-side).
    Candidate triangles come from a KDTree over centroids; a point whose
    best candidate still has a negative barycentric coordinate beyond
    tolerance is marked invalid (outside the fluid)."""
    tp = mesh.points[mesh.tris]  # (nt, 3, 2)
    cent = tp.mean(axis=1)
    tree = cKDTree(cent)
    k = min(k, len(cent))
    _, cand = tree.query(pts, k=k)
    if k == 1:
        cand = cand[:, None]
    a = tp[cand, 0]  # (ns, k, 2)
    e1 = tp[cand, 1] - a
    e2 = tp[cand, 2] - a
    r = pts[:, None, :] - a
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    l1 = (r[..., 0] * e2[..., 1] - r[..., 1] * e2[..., 0]) / det
    l2 = (e1[..., 0] * r[..., 1] - e1[..., 1] * r[..., 0]) / det
    l0 = 1.0 - l1 - l2
    worst = np.minimum(np.minimum(l0, l1), l2)  # (ns, k)
    best = np.argmax(worst, axis=1)
    rows = np.arange(len(pts))
    tri = cand[rows, best]
    bary = np.stack(
        [l0[rows, best], l1[rows, best], l2[rows, best]], axis=1
    )
    valid = worst[rows, best] > -1e-9
    return tri, bary, valid


def build_sampler(spaces: FESpaces, xs, ys, *, device) -> SampleTable:
    """Tables for sampling on the tensor grid xs × ys (host, one-time)."""
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    return _build_table(spaces, pts, (len(ys), len(xs)), device)


def point_sampler(spaces: FESpaces, pts, *, device) -> SampleTable:
    """Tables for an arbitrary (n, 2) point list: FE-consistent probe
    values. Outputs of ``sample_fields`` have shape (1, n)."""
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    return _build_table(spaces, pts, (1, len(pts)), device)


def _build_table(spaces: FESpaces, pts, shape, device) -> SampleTable:
    mesh = spaces.mesh
    tri, bary, valid = _locate(mesh, pts)
    qp = bary[:, 1:]  # reference coords (ξ, η) = (λ1, λ2)
    kind = "p1" if spaces.kind == "p1p1" else "p2"
    N, dN = _basis_tables(kind, qp)  # (ns, nloc), (ns, nloc, 2)
    Np, _ = _basis_tables("p1", qp)

    tp = mesh.points[mesh.tris[tri]]  # (ns, 3, 2)
    J = np.stack([tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]], axis=2)
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    inv = np.empty_like(J)
    inv[:, 0, 0] = J[:, 1, 1]
    inv[:, 0, 1] = -J[:, 0, 1]
    inv[:, 1, 0] = -J[:, 1, 0]
    inv[:, 1, 1] = J[:, 0, 0]
    inv /= det[:, None, None]
    G = np.einsum("slk,skc->slc", dN, inv)

    def table(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return SampleTable(
        idx=table(spaces.elem_u[tri], torch.int64),
        idx_p=table(spaces.elem_p[tri], torch.int64),
        N=table(N, torch.float32),
        Np=table(Np, torch.float32),
        G=table(G, torch.float32),
        valid=table(valid, torch.bool),
        shape=shape,
    )


def sample_fields(table: SampleTable, u, p=None) -> dict:
    """Sample velocity (+ exact vorticity, + optionally pressure) at the
    table's points. Returns a dict of (ny, nx) tensors with NaN outside the
    fluid: u, v, speed, vorticity [, p]; the tables are cast to the state's
    dtype (float64 states sample in float64, as the JAX package promotes)."""
    from cfdsim_tpu_torch.solvers.fdm import full_fp32_matmul

    with full_fp32_matmul():
        N, G = table.N.to(u.dtype), table.G.to(u.dtype)
        ue = u[table.idx]  # (ns, nloc, 2)
        uv = torch.einsum("sl,sld->sd", N, ue)
        gu = torch.einsum("slc,sld->sdc", G, ue)
        vort = gu[:, 1, 0] - gu[:, 0, 1]
        nan = torch.full((), float("nan"), dtype=u.dtype, device=u.device)
        m = table.valid

        def shape(f):
            return torch.where(m, f, nan).reshape(table.shape)

        out = {
            "u": shape(uv[:, 0]),
            "v": shape(uv[:, 1]),
            "speed": shape(torch.sqrt(uv[:, 0] ** 2 + uv[:, 1] ** 2)),
            "vorticity": shape(vort),
        }
        if p is not None:
            pv = torch.einsum("sl,sl->s", table.Np.to(p.dtype), p[table.idx_p])
            out["p"] = shape(pv)
    return out


def snapshot_fields(table: SampleTable, state, sampled=("u", "v", "p", "vorticity")) -> dict:
    """An unstructured FEM state's snapshot: the ``sampled`` fields on the
    table's grid (by default u, v, p, vorticity: what the renderer reads, as
    the JAX CLI writes them) and its nodal fields under the state's
    ``snapshot_prefix`` (``fem_u``, ``fem_p``, ``fem_phi``), from which
    ``--resume`` restores the state bit for bit."""
    f = sample_fields(table, state.u, state.p)
    fields = {k: f[k] for k in sampled}
    for name in ("u", "p", "phi"):
        if getattr(state, name) is not None:
            fields[state.snapshot_prefix + name] = getattr(state, name)
    return fields
