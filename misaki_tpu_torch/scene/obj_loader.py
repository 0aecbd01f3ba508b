"""Wavefront OBJ parser with the reference's exact semantics
(src/librender/shapes/obj.cpp:58-181): v/vt/vn with f v/vt/vn index triples,
quads split into two triangles (0,1,2)+(3,0,2), texcoord v flipped by default,
to_world applied at load (points for v, inverse-transpose for vn), negative
OBJ indices unsupported (the reference doesn't handle them either).

Output is a simple dict of numpy arrays — consumed by the scene compiler.
"""

import numpy as np


def load_obj(path, to_world=None, flip_tex_coords=True):
    vertices = []
    normals = []
    texcoords = []
    tri_idx = []  # list of (p, uv, n) 0-based triples per corner

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                u, v = float(parts[1]), float(parts[2])
                if flip_tex_coords:
                    v = 1.0 - v
                texcoords.append([u, v])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "f":
                corners = []
                for spec in parts[1:5]:
                    toks = spec.split("/")
                    p = int(toks[0]) - 1
                    uv = int(toks[1]) - 1 if len(toks) > 1 and toks[1] else -1
                    n = int(toks[2]) - 1 if len(toks) > 2 and toks[2] else -1
                    corners.append((p, uv, n))
                tri_idx.append([corners[0], corners[1], corners[2]])
                if len(corners) == 4:
                    # quad -> (3, 0, 2), matching obj.cpp:115-119
                    tri_idx.append([corners[3], corners[0], corners[2]])

    V = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    N = np.asarray(normals, dtype=np.float64).reshape(-1, 3)
    T = np.asarray(texcoords, dtype=np.float64).reshape(-1, 2)

    if to_world is not None:
        from misaki_tpu_torch.core import transform as tr

        V = tr.apply_point(to_world, V) if len(V) else V
        if len(N):
            N = tr.apply_normal(to_world, N)
            norm = np.linalg.norm(N, axis=-1, keepdims=True)
            N = N / np.maximum(norm, 1e-20)

    F = len(tri_idx)
    idx = np.asarray(tri_idx, dtype=np.int64)  # (F, 3, 3)
    p_idx = idx[..., 0]
    uv_idx = idx[..., 1]
    n_idx = idx[..., 2]

    pos = V[p_idx]  # (F, 3corners, 3)
    has_n = bool(len(N)) and (n_idx >= 0).all()
    has_uv = bool(len(T)) and (uv_idx >= 0).all()
    nrm = N[np.maximum(n_idx, 0)] if has_n else np.zeros_like(pos)
    uv = T[np.maximum(uv_idx, 0)] if has_uv else np.zeros((F, 3, 2))

    return {
        "positions": pos.astype(np.float32),      # (F, 3, 3)
        "normals": nrm.astype(np.float32),        # (F, 3, 3)
        "uvs": uv.astype(np.float32),             # (F, 3, 2)
        "has_normals": has_n,
        "has_uvs": has_uv,
    }
