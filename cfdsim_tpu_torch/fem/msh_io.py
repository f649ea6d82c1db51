"""gmsh `.msh` (format 4.1, ASCII) reader → :class:`TriMesh` (a copy of
``cfdsim_tpu.fem.msh_io``).

The reference's FEM geometry is *defined* by gmsh artifacts
(reference v2.jl:62-134 loads `cylinder_optimized.msh`, generated from
`v2/cylinder_optimized.geo`; physical groups "inlet"/"outlet"/"walls"/
"cylinder"/"domain").  This reader parses the v4.1 ASCII sections —
$PhysicalNames, $Entities (entity→physical mapping), $Nodes and
$Elements (entity-blocked) — into the same ``TriMesh`` structure the
native graded-Delaunay generator produces, so the FEM tier can run on
the *identical* mesh the reference ran (cross-validation, VERDICT r4
#5).  No gmsh binary or meshio dependency: the format is a small,
stable text schema.

Scope: 2D triangular meshes — node blocks from any entity dimension,
element types 1 (2-node line, boundary groups), 2 (3-node triangle,
domain), 15 (point, ignored).  Curved/higher-order elements are out of
scope (the reference meshes are straight-sided P1 triangles).
"""

from __future__ import annotations

import numpy as np

from cfdsim_tpu_torch.fem.mesh import TriMesh, _finalize

_TRI = 2
_LINE = 1
_POINT = 15


def _section(lines, i, name):
    assert lines[i].strip() == f"${name}", (lines[i], name)
    j = i + 1
    while lines[j].strip() != f"$End{name}":
        j += 1
    return lines[i + 1 : j], j + 1


def read_msh(path) -> TriMesh:
    """Parse a gmsh 4.1 ASCII mesh into a TriMesh.

    Node tags may be sparse; they are remapped to dense 0-based indices.
    Boundary node tags are collected per physical-group name from the
    line elements, then deduplicated with the repo convention (a corner
    node belongs to exactly one tag; precedence inlet > walls > outlet,
    matching ``mesh._tag_boundary``).  ``geometry`` gains a bbox and,
    when a "cylinder" group exists, the circle's fitted center/radius
    (used by P2 midside projection in ``spaces.build_spaces``).
    """
    with open(path) as f:
        lines = f.read().splitlines()

    i = 0
    phys_names: dict[int, str] = {}
    curve_phys: dict[int, list[int]] = {}  # curve-entity tag -> phys tags
    surf_phys: dict[int, list[int]] = {}
    nodes: dict[int, tuple[float, float]] = {}
    tris = []
    group_nodes: dict[str, set] = {}

    while i < len(lines):
        head = lines[i].strip()
        if head == "$MeshFormat":
            body, i = _section(lines, i, "MeshFormat")
            ver = body[0].split()
            if not ver[0].startswith("4"):
                raise ValueError(
                    f"unsupported .msh format {ver[0]} (need 4.x ASCII)")
            if ver[1] != "0":
                raise ValueError("binary .msh not supported")
        elif head == "$PhysicalNames":
            body, i = _section(lines, i, "PhysicalNames")
            for ln in body[1:]:
                parts = ln.split(None, 2)
                if len(parts) == 3:
                    phys_names[int(parts[1])] = parts[2].strip().strip('"')
        elif head == "$Entities":
            body, i = _section(lines, i, "Entities")
            np_, nc, ns, nv = (int(x) for x in body[0].split()[:4])
            k = 1 + np_  # skip point entities
            for _ in range(nc):
                vals = body[k].split()
                k += 1
                tag = int(vals[0])
                n_phys = int(vals[7])
                curve_phys[tag] = [int(x) for x in vals[8 : 8 + n_phys]]
            for _ in range(ns):
                vals = body[k].split()
                k += 1
                tag = int(vals[0])
                n_phys = int(vals[7])
                surf_phys[tag] = [int(x) for x in vals[8 : 8 + n_phys]]
        elif head == "$Nodes":
            body, i = _section(lines, i, "Nodes")
            n_blocks = int(body[0].split()[0])
            k = 1
            for _ in range(n_blocks):
                _dim, _etag, _param, n_in = (int(x) for x in body[k].split())
                k += 1
                tags_blk = [int(body[k + j]) for j in range(n_in)]
                k += n_in
                for j in range(n_in):
                    x, y = (float(v) for v in body[k + j].split()[:2])
                    nodes[tags_blk[j]] = (x, y)
                k += n_in
        elif head == "$Elements":
            body, i = _section(lines, i, "Elements")
            n_blocks = int(body[0].split()[0])
            k = 1
            for _ in range(n_blocks):
                dim, etag, etype, n_in = (int(x) for x in body[k].split())
                k += 1
                if etype == _TRI:
                    for j in range(n_in):
                        vals = body[k + j].split()
                        tris.append((int(vals[1]), int(vals[2]), int(vals[3])))
                elif etype == _LINE:
                    names = [phys_names.get(p) for p in curve_phys.get(etag, [])]
                    names = [n for n in names if n]
                    for j in range(n_in):
                        vals = body[k + j].split()
                        for name in names:
                            group_nodes.setdefault(name, set()).update(
                                (int(vals[1]), int(vals[2])))
                k += n_in
        else:
            i += 1

    if not tris:
        raise ValueError(f"no triangles in {path}")

    # dense 0-based renumbering
    tag_order = sorted(nodes)
    remap = {t: j for j, t in enumerate(tag_order)}
    points = np.asarray([nodes[t] for t in tag_order], dtype=np.float64)
    tris_np = np.asarray(
        [[remap[a], remap[b], remap[c]] for a, b, c in tris], dtype=np.int32)

    # physical-group node sets (dense ids), deduplicated with the repo's
    # corner precedence: inlet > walls > outlet; "cylinder" is an
    # interior boundary, disjoint from the outer groups by construction
    raw = {name: {remap[t] for t in s} for name, s in group_nodes.items()}
    tags: dict[str, set] = {}
    taken: set = set()
    for name in ("inlet", "walls", "outlet"):
        s = raw.get(name, set()) - taken
        tags[name] = s
        taken |= s
    for name, s in raw.items():
        if name not in tags and name != "domain":
            tags[name] = set(s)

    geometry = {
        "bbox": (float(points[:, 0].min()), float(points[:, 0].max()),
                 float(points[:, 1].min()), float(points[:, 1].max())),
        "source": str(path),
    }
    cyl = tags.get("cylinder")
    if cyl:
        cp = points[sorted(cyl)]
        center = cp.mean(axis=0)
        radius = float(np.hypot(*(cp - center).T).mean())
        geometry["cylinder_center"] = (float(center[0]), float(center[1]))
        geometry["cylinder_radius"] = radius

    return _finalize(points, tris_np, tags, geometry)
