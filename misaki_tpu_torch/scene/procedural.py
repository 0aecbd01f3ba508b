"""Procedural substitute geometry for meshes referenced by the scenes but
absent from the reference repository.

The reference's `assets/*/scene.xml` reference OBJ files (cbox_*.obj,
bunny.obj, material-testball meshes) that are NOT in the tree (SURVEY.md
section 6 caveat). When the scene compiler cannot resolve a mesh path it
falls back to this registry, keyed by the file's basename:

  * cbox_*           — the canonical Cornell-box coordinates (public data,
                       cornell.edu/box): these are exactly the meshes the
                       missing OBJs contain, so cbox renders are faithful.
  * bunny.obj        — a ~70k-triangle displaced icosphere: a stand-in with
                       the same triangle count magnitude for BVH benchmarks.
  * rectangle.obj    — the standard [-1,1]^2 rectangle in the xy-plane.
  * Mesh00x.obj      — material-testball stand-ins (sphere/base/stand).
  * teapot parts     — sphere stand-ins for teapot-full.

Besides these, `sierpinski` makes the scene compiler's `sierpinski` shape:
the recursive Sierpinski tetrahedron of Haines's Standard Procedural
Databases (`tetra`), generated from its formula, so a million-face mesh
needs no file.

All functions return the same dict format as obj_loader.load_obj.
"""

import numpy as np


def _quads_to_mesh(quads, to_world=None):
    """quads: (Q, 4, 3) -> triangle soup matching OBJ quad split (0,1,2)+(3,0,2)."""
    quads = np.asarray(quads, dtype=np.float64)
    tris = []
    for q in quads:
        tris.append([q[0], q[1], q[2]])
        tris.append([q[3], q[0], q[2]])
    pos = np.asarray(tris, dtype=np.float64)
    if to_world is not None:
        from misaki_tpu_torch.core import transform as tr

        pos = tr.apply_point(to_world, pos.reshape(-1, 3)).reshape(-1, 3, 3)
    return {
        "positions": pos.astype(np.float32),
        "normals": np.zeros_like(pos, dtype=np.float32),
        "uvs": np.zeros((pos.shape[0], 3, 2), dtype=np.float32),
        "has_normals": False,
        "has_uvs": False,
    }


def _tris_mesh(positions, normals=None, uvs=None, to_world=None):
    positions = np.asarray(positions, dtype=np.float64)
    if to_world is not None:
        from misaki_tpu_torch.core import transform as tr

        positions = tr.apply_point(to_world, positions.reshape(-1, 3)).reshape(
            -1, 3, 3
        )
        if normals is not None:
            n = tr.apply_normal(to_world, np.asarray(normals).reshape(-1, 3))
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            normals = n.reshape(-1, 3, 3)
    F = positions.shape[0]
    return {
        "positions": positions.astype(np.float32),
        "normals": (
            np.asarray(normals, np.float32)
            if normals is not None
            else np.zeros((F, 3, 3), np.float32)
        ),
        "uvs": (
            np.asarray(uvs, np.float32)
            if uvs is not None
            else np.zeros((F, 3, 2), np.float32)
        ),
        "has_normals": normals is not None,
        "has_uvs": uvs is not None,
    }


# ---- canonical Cornell-box quads (public measurement data) -----------------

_CBOX = {
    "cbox_floor": [
        [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (549.6, 0.0, 559.2)]
    ],
    "cbox_ceiling": [
        [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2), (0.0, 548.8, 0.0)]
    ],
    "cbox_back": [
        [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2), (556.0, 548.8, 559.2)]
    ],
    # green wall at x = 0 (right in camera space), red at x ~ 556 (left)
    "cbox_greenwall": [
        [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0), (0.0, 548.8, 559.2)]
    ],
    "cbox_redwall": [
        [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2), (556.0, 548.8, 0.0)]
    ],
    "cbox_luminaire": [
        [(343.0, 548.8, 227.0), (343.0, 548.8, 332.0), (213.0, 548.8, 332.0), (213.0, 548.8, 227.0)]
    ],
    "cbox_smallbox": [
        [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0), (290.0, 165.0, 114.0)],
        [(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0), (240.0, 0.0, 272.0)],
        [(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0), (290.0, 0.0, 114.0)],
        [(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0), (130.0, 0.0, 65.0)],
        [(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0), (82.0, 0.0, 225.0)],
    ],
    "cbox_largebox": [
        [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0), (472.0, 330.0, 406.0)],
        [(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0), (472.0, 0.0, 406.0)],
        [(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0), (314.0, 0.0, 456.0)],
        [(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0), (265.0, 0.0, 296.0)],
        [(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0), (423.0, 0.0, 247.0)],
    ],
}


def icosphere(subdivisions=3, radius=1.0, center=(0, 0, 0), smooth=True):
    """Subdivided icosahedron with per-vertex normals."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, dtype=np.int64)

    normals = verts.copy()
    verts = verts * radius + np.asarray(center, dtype=np.float64)
    pos = verts[faces]
    nrm = normals[faces] if smooth else None
    return pos, nrm


def bunny_standin(n_tris_target=70_000):
    """Displaced icosphere with ~the Stanford bunny's bbox and triangle count.

    The real bunny.obj is absent from the reference tree; this keeps the
    BVH-traversal benchmark workload (768x768, 69k tris) representative.
    Bunny bbox is roughly [-0.094,0.061] x [0.033,0.187] x [-0.062,0.059].
    """
    sub = 5  # 20 * 4^5 = 20480 tris
    while 20 * 4 ** (sub + 1) <= n_tris_target:
        sub += 1
    pos, nrm = icosphere(sub, radius=1.0, center=(0, 0, 0))
    # deterministic multi-frequency displacement for BVH-unfriendly geometry
    p = pos.reshape(-1, 3)
    disp = (
        0.10 * np.sin(4.0 * p[:, 0] + 1.0) * np.cos(3.0 * p[:, 1])
        + 0.06 * np.sin(9.0 * p[:, 2] + 0.5) * np.sin(7.0 * p[:, 0])
        + 0.03 * np.cos(15.0 * p[:, 1] * p[:, 2])
    )
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    p = p * (1.0 + 0.3 * disp[:, None])
    pos = p.reshape(-1, 3, 3)
    # scale/offset into the bunny's bounding box
    scale = np.array([0.0775, 0.077, 0.0605])
    offset = np.array([-0.0165, 0.110, -0.0015])
    pos = pos * scale + offset
    return _tris_mesh(pos, normals=None)


def rectangle():
    """[-1,1]^2 in the xy-plane, +z normal, standard UVs (mitsuba convention)."""
    v = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float64
    )
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    n = np.tile([0.0, 0.0, 1.0], (4, 1))
    tris = [[0, 1, 2], [3, 0, 2]]
    pos = v[tris]
    return _tris_mesh(pos, normals=n[tris], uvs=uv[tris])


def sphere_standin(radius=1.0, center=(0, 0, 0), sub=4):
    pos, nrm = icosphere(sub, radius=radius, center=center)
    return _tris_mesh(pos, normals=nrm)


_TESTBALL = {
    # material-testball decomposition: Mesh001+Mesh002 = ball halves, Mesh000 = stand
    "Mesh000": lambda: sphere_standin(0.6, (0.0, 0.3, 0.0), sub=3),
    "Mesh001": lambda: sphere_standin(1.0, (0.0, 1.0, 0.0), sub=5),
    "Mesh002": lambda: sphere_standin(0.4, (0.0, 1.2, 0.2), sub=3),
    "Mesh003": lambda: sphere_standin(1.0, (0.0, 1.0, 0.0), sub=5),
}


# ---- the Sierpinski tetrahedron (SPD `tetra`) --------------------------------

SIERPINSKI_MAX_LEVEL = 10
# a regular tetrahedron of edge 1 standing on its face v0 v1 v2 in the plane
# y = 0, its apex v3 on the y axis
_TETRA = np.array([[-0.5, 0.0, -np.sqrt(3.0) / 6.0],
                   [0.5, 0.0, -np.sqrt(3.0) / 6.0],
                   [0.0, 0.0, np.sqrt(3.0) / 3.0],
                   [0.0, np.sqrt(2.0 / 3.0), 0.0]])
# a tetrahedron's faces by vertex, each wound so that e1 x e2 points out
TETRA_FACES = ((0, 1, 2), (0, 3, 1), (1, 3, 2), (2, 3, 0))


def sierpinski_tetrahedra(level):
    """The 4^level tetrahedra of level `level`, (4^level, 4, 3) float64.
    Level n + 1 replaces tetrahedron t of level n by its four half-size
    corner copies 4t + k, k = 0..3, copy k with vertices (v_i + v_k) / 2:
    vertex i keeps its role, so every copy is wound as the base is."""
    level = int(level)
    if not 0 <= level <= SIERPINSKI_MAX_LEVEL:
        raise ValueError(f"sierpinski level must lie in 0..{SIERPINSKI_MAX_LEVEL}, got {level}")
    v = _TETRA[None]
    for _ in range(level):
        v = (0.5 * (v[:, :, None, :] + v[:, None, :, :])).reshape(-1, 4, 3)
    return v


def sierpinski(level, to_world=None):
    """The Sierpinski tetrahedron of `level` as a triangle soup of 4^(level
    + 1) faces: tetrahedron t's faces are 4t .. 4t + 3, in the order of
    `TETRA_FACES`. Generated in float64 and placed by `to_world` before the
    rounding to float32, as an OBJ of the same vertices loads."""
    tets = sierpinski_tetrahedra(level)
    return _tris_mesh(tets[:, TETRA_FACES].reshape(-1, 3, 3), to_world=to_world)


def get_procedural_mesh(basename, to_world=None):
    """Resolve a missing mesh file by basename; returns mesh dict or None."""
    name = basename
    if name.endswith(".obj"):
        name = name[:-4]
    if name in _CBOX:
        return _quads_to_mesh(_CBOX[name], to_world)
    if name == "bunny":
        mesh = bunny_standin()
    elif name == "rectangle":
        mesh = rectangle()
    elif name in _TESTBALL:
        mesh = _TESTBALL[name]()
    else:
        return None
    if to_world is not None:
        from misaki_tpu_torch.core import transform as tr

        pos = tr.apply_point(
            to_world, mesh["positions"].astype(np.float64).reshape(-1, 3)
        ).reshape(-1, 3, 3)
        mesh["positions"] = pos.astype(np.float32)
        if mesh["has_normals"]:
            n = tr.apply_normal(
                to_world, mesh["normals"].astype(np.float64).reshape(-1, 3)
            )
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            mesh["normals"] = n.reshape(-1, 3, 3).astype(np.float32)
    return mesh
