"""Finite-element spaces on a TriMesh: DOF layout + Dirichlet data (a
copy of ``cfdsim_tpu.fem.spaces``).

Covers both reference discretizations:

- ``"p1p1"`` — equal-order continuous P1 velocity / P1 pressure with
  pressure-gradient stabilization (the reference's "efficient" space,
  v2.jl:137-173; τ per v2.jl:170).
- ``"p2p1"`` — Taylor-Hood P2 velocity / P1 pressure (v1.jl:103-127),
  inf-sup stable, no stabilization. P2 adds one velocity DOF per mesh
  edge; midside nodes on the cylinder boundary are projected radially
  onto the true circle so Dirichlet data and error measures see the
  curved geometry (gmsh's curved physical lines).

Velocity Dirichlet data lives on the reference's physical groups
"inlet", "walls", "cylinder" (v2.jl:146-156: inlet = (V_inf, 0), walls
and cylinder no-slip); the outlet stays natural (do-nothing), which also
fixes the pressure level. All arrays here are host-side NumPy produced
once at setup; the assembly layer lifts them to device constants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from cfdsim_tpu_torch.fem.mesh import TriMesh

DIRICHLET_TAGS = ("inlet", "walls", "cylinder")


@dataclasses.dataclass(frozen=True)
class FESpaces:
    """DOF layout for a velocity/pressure pair on ``mesh``.

    n_u / n_p : number of scalar velocity / pressure nodes
    u_points : (n_u, 2) velocity DOF coordinates (P2: vertex nodes then
        edge midpoints, cylinder midpoints circle-projected)
    elem_u : (n_tris, nloc_u) velocity DOF indices per element
        (P1: 3 vertices; P2: [v0, v1, v2, m0, m1, m2] with m_k the
        midside node on the edge opposite vertex k)
    elem_p : (n_tris, 3) pressure DOF indices (vertices)
    dirichlet_mask : (n_u,) bool — True where velocity is constrained
    dirichlet_tag_nodes : tag -> velocity-DOF index array (includes
        midside nodes for P2)
    """

    mesh: TriMesh
    kind: str
    n_u: int
    n_p: int
    u_points: np.ndarray
    elem_u: np.ndarray
    elem_p: np.ndarray
    dirichlet_mask: np.ndarray
    dirichlet_tag_nodes: Dict[str, np.ndarray]

    @property
    def nloc_u(self) -> int:
        return self.elem_u.shape[1]


def _classify_boundary_edges(mesh: TriMesh) -> Dict[str, np.ndarray]:
    """Tag each boundary edge by the geometric side both endpoints lie
    on (coordinate tests, so corner-adjacent edges land on the correct
    side regardless of node-tag precedence)."""
    pts = mesh.points
    geo = mesh.geometry
    x0, x1, y0, y1 = geo["bbox"]
    eps = 1e-9 * max(x1 - x0, y1 - y0)
    out: Dict[str, list] = {t: [] for t in ("inlet", "outlet", "walls", "cylinder")}
    cc = geo.get("cylinder_center")
    rr = geo.get("cylinder_radius")
    for be in mesh.boundary_edges:
        a, b = mesh.edges[be]
        pa, pb = pts[a], pts[b]
        if abs(pa[0] - x0) < eps and abs(pb[0] - x0) < eps:
            out["inlet"].append(be)
        elif abs(pa[0] - x1) < eps and abs(pb[0] - x1) < eps:
            out["outlet"].append(be)
        elif (abs(pa[1] - y0) < eps and abs(pb[1] - y0) < eps) or (
            abs(pa[1] - y1) < eps and abs(pb[1] - y1) < eps
        ):
            out["walls"].append(be)
        elif cc is not None:
            da = np.hypot(pa[0] - cc[0], pa[1] - cc[1])
            db = np.hypot(pb[0] - cc[0], pb[1] - cc[1])
            if abs(da - rr) < 1e-6 * rr and abs(db - rr) < 1e-6 * rr:
                out["cylinder"].append(be)
    return {k: np.asarray(v, dtype=np.int32) for k, v in out.items()}


def build_spaces(
    mesh: TriMesh, kind: str = "p1p1", dirichlet_tags=None
) -> FESpaces:
    """Construct the DOF layout. ``kind`` ∈ {"p1p1", "p2p1"}.

    ``dirichlet_tags``: which boundary tags carry velocity Dirichlet
    conditions (default inlet/walls/cylinder — the cylinder-channel
    convention with a do-nothing outlet, v2.jl:151-156). Fully enclosed
    cases (lid-driven cavity) pass all four tags."""
    if kind not in ("p1p1", "p2p1"):
        raise ValueError(f"unknown FE space kind {kind!r}")
    tags_d = DIRICHLET_TAGS if dirichlet_tags is None else tuple(dirichlet_tags)
    n_pts = mesh.n_points
    elem_p = mesh.tris.astype(np.int32)

    if kind == "p1p1":
        n_u = n_pts
        u_points = mesh.points.copy()
        elem_u = elem_p.copy()
        tag_nodes = {t: mesh.tags[t].copy() for t in tags_d}
    else:
        # P2: append one midside node per unique edge.
        mids = 0.5 * (mesh.points[mesh.edges[:, 0]] + mesh.points[mesh.edges[:, 1]])
        geo = mesh.geometry
        cc = geo.get("cylinder_center")
        rr = geo.get("cylinder_radius")
        edge_tags = _classify_boundary_edges(mesh)
        if cc is not None and len(edge_tags["cylinder"]):
            # project cylinder midside nodes onto the circle
            ce = edge_tags["cylinder"]
            v = mids[ce] - np.asarray(cc)
            v *= rr / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-300)
            mids[ce] = np.asarray(cc) + v
        n_u = n_pts + mesh.edges.shape[0]
        u_points = np.concatenate([mesh.points, mids], axis=0)
        elem_u = np.concatenate(
            [mesh.tris, n_pts + mesh.tri_edges], axis=1
        ).astype(np.int32)
        tag_nodes = {}
        for t in tags_d:
            mid_nodes = n_pts + edge_tags[t]
            tag_nodes[t] = np.concatenate([mesh.tags[t], mid_nodes]).astype(
                np.int32
            )

    dir_mask = np.zeros(n_u, dtype=bool)
    for t in tags_d:
        dir_mask[tag_nodes[t]] = True
    return FESpaces(
        mesh=mesh,
        kind=kind,
        n_u=n_u,
        n_p=n_pts,
        u_points=u_points,
        elem_u=elem_u,
        elem_p=elem_p,
        dirichlet_mask=dir_mask,
        dirichlet_tag_nodes=tag_nodes,
    )


def dirichlet_values(
    spaces: FESpaces,
    tag_fns: Dict[str, Callable[[np.ndarray, np.ndarray], Tuple]],
) -> np.ndarray:
    """Build the (n_u, 2) velocity Dirichlet lift g: for each tag with a
    value function ``(x, y) -> (u, v)`` (vectorized), fill the tag's DOF
    rows; everything else stays 0. Mirrors Gridap's TrialFESpace value
    list (v2.jl:151-156)."""
    g = np.zeros((spaces.n_u, 2), dtype=np.float64)
    for tag, fn in tag_fns.items():
        idx = spaces.dirichlet_tag_nodes[tag]
        if len(idx) == 0:
            continue
        x, y = spaces.u_points[idx, 0], spaces.u_points[idx, 1]
        u, v = fn(x, y)
        g[idx, 0] = np.broadcast_to(u, x.shape)
        g[idx, 1] = np.broadcast_to(v, x.shape)
    return g
