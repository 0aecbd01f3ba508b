"""SoA scene-interaction computation — barycentric surface records
(reference: src/librender/mesh.cpp:50-101 compute_scene_interaction,
interaction.h spawn_ray / initialize_sh_frame).

The per-face data comes from the closest-hit kernel's face row ("fd"), or,
for a hit record without one, from an indexed load of the face table.
"""

import torch

from misaki_tpu_torch.core import frame, math as m, vec
from misaki_tpu_torch.scene.types import (
    FC_BSDF,
    FC_E1,
    FC_E2,
    FC_EMITTER,
    FC_HAS_N,
    FC_HAS_UV,
    FC_MED_EXT,
    FC_MED_INT,
    FC_N0,
    FC_NG,
    FC_TANGENT,
    FC_UV0,
)


def fetch_face(scene, prim):
    """All packed face columns of faces `prim` -> (N_FACE_COLS, L)."""
    return scene.geometry.face_tab[:, prim.to(torch.int64)]


def _rows3(fd, base):
    return (fd[base], fd[base + 1], fd[base + 2])


def _unit_z(like):
    z = torch.zeros_like(like)
    return (z, z, torch.ones_like(like))


def _uv_partials(fd, valid, p, o, ng, d_dx, d_dy):
    """Screen-space UV partials (interaction.h:62-85 compute_uv_partials,
    pinhole origin shared). Returns (duv_dx, duv_dy) 2-tuples of (L,)."""
    e1 = _rows3(fd, FC_E1)
    e2 = _rows3(fd, FC_E2)
    du0 = fd[FC_UV0 + 2] - fd[FC_UV0]
    dv0 = fd[FC_UV0 + 3] - fd[FC_UV0 + 1]
    du1 = fd[FC_UV0 + 4] - fd[FC_UV0]
    dv1 = fd[FC_UV0 + 5] - fd[FC_UV0 + 1]
    det = du0 * dv1 - dv0 * du1
    ok_uv = (fd[FC_HAS_UV] > 0.5) & (torch.abs(det) > 1e-12)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    dp_du = vec.scale(vec.sub(vec.scale(e1, dv1), vec.scale(e2, dv0)), inv)
    dp_dv = vec.scale(vec.add(vec.scale(e1, -du1), vec.scale(e2, du0)), inv)
    # faces without texcoords: barycentric parameterization (dp_du = e1)
    dp_du = vec.where(ok_uv, dp_du, e1)
    dp_dv = vec.where(ok_uv, dp_dv, e2)

    # neighbour-ray plane projections (shared origin o)
    dist = vec.dot(ng, p)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12, 1e-12, x)

    t_x = (dist - vec.dot(ng, o)) / safe(vec.dot(ng, d_dx))
    t_y = (dist - vec.dot(ng, o)) / safe(vec.dot(ng, d_dy))
    dp_dx = vec.sub(vec.add(vec.scale(d_dx, t_x), o), p)
    dp_dy = vec.sub(vec.add(vec.scale(d_dy, t_y), o), p)

    a00 = vec.dot(dp_du, dp_du)
    a01 = vec.dot(dp_du, dp_dv)
    a11 = vec.dot(dp_dv, dp_dv)
    det_a = a00 * a11 - a01 * a01
    inv_det = torch.where((torch.abs(det_a) > 1e-20) & valid, 1.0 / safe(det_a), 0.0)
    b0x = vec.dot(dp_du, dp_dx)
    b1x = vec.dot(dp_dv, dp_dx)
    b0y = vec.dot(dp_du, dp_dy)
    b1y = vec.dot(dp_dv, dp_dy)
    duv_dx = ((a11 * b0x - a01 * b1x) * inv_det, (a00 * b1x - a01 * b0x) * inv_det)
    duv_dy = ((a11 * b0y - a01 * b1y) * inv_det, (a00 * b1y - a01 * b0y) * inv_det)
    return duv_dx, duv_dy


def compute_interaction(scene, hit, o, d, wavelengths, fd=None, ray_diff=None):
    """hit: {"t", "prim", "u", "v"[, "fd"]} from accel.traverse; o/d vec3.

    Returns SoA dict: valid, t, p (vec3), ng (vec3), sh (frame), uv (vec2),
    wi (vec3 local), prim, bsdf (int lanes), emitter (int lanes), med_int,
    med_ext and duv_dx/duv_dy (zeros unless camera differentials
    `ray_diff=(d_dx, d_dy)` are given).
    """
    prim = torch.clamp(hit["prim"], min=0)
    valid = hit["prim"] >= 0
    if fd is None:
        fd = hit.get("fd")
    if fd is None:
        fd = fetch_face(scene, prim)
    b1 = hit["u"]
    b2 = hit["v"]
    b0 = 1.0 - b1 - b2

    # hit position from the ray
    p = vec.add(o, vec.scale(d, hit["t"]))
    p = vec.where(valid, p, o)
    # miss lanes get n = +z: every accel path yields the same safe frame
    ng = vec.where(valid, _rows3(fd, FC_NG), _unit_z(fd[0]))

    # shading normal (mesh.cpp:83-99)
    n0 = _rows3(fd, FC_N0)
    n1 = _rows3(fd, FC_N0 + 3)
    n2 = _rows3(fd, FC_N0 + 6)
    ns = vec.normalize(
        vec.add(vec.scale(n0, b0), vec.add(vec.scale(n1, b1), vec.scale(n2, b2)))
    )
    has_n = fd[FC_HAS_N] > 0.5
    n_sh = vec.where(has_n, ns, ng)

    # UVs: interpolated texcoords or barycentrics (mesh.cpp:66-73)
    has_uv = fd[FC_HAS_UV] > 0.5
    uv_u = fd[FC_UV0] * b0 + fd[FC_UV0 + 2] * b1 + fd[FC_UV0 + 4] * b2
    uv_v = fd[FC_UV0 + 1] * b0 + fd[FC_UV0 + 3] * b1 + fd[FC_UV0 + 5] * b2
    uv = (torch.where(has_uv, uv_u, b1), torch.where(has_uv, uv_v, b2))

    # initialize_sh_frame (interaction.h:54-60): Gram-Schmidt the per-face
    # tangent against the (possibly interpolated) shading normal
    dp_du = _rows3(fd, FC_TANGENT)
    s_raw = vec.sub(dp_du, vec.scale(n_sh, vec.dot(n_sh, dp_du)))
    degenerate = vec.norm2(s_raw) < 1e-12
    s_fallback, _ = frame.coordinate_system(n_sh)
    s = vec.normalize(vec.where(degenerate, s_fallback, s_raw))
    t = vec.cross(n_sh, s)
    sh = {"s": s, "t": t, "n": n_sh}

    wi = frame.to_local(sh, vec.neg(d))

    if ray_diff is not None:
        duv_dx, duv_dy = _uv_partials(fd, valid, p, o, ng, ray_diff[0], ray_diff[1])
    else:
        z = torch.zeros_like(b1)
        duv_dx = duv_dy = (z, z)

    def face_id(col, offset):
        return torch.where(valid, fd[col].to(torch.int32) - offset, -offset)

    return {
        "duv_dx": duv_dx,
        "duv_dy": duv_dy,
        "valid": valid,
        "t": torch.where(valid, hit["t"], torch.inf),
        "p": p,
        "ng": ng,
        "sh": sh,
        "uv": uv,
        "wi": wi,
        "prim": hit["prim"],
        "bsdf": face_id(FC_BSDF, 0),
        "emitter": face_id(FC_EMITTER, 1),
        "med_int": face_id(FC_MED_INT, 1),
        "med_ext": face_id(FC_MED_EXT, 1),
    }


def spawn_ray_mint(p):
    """Origin offset epsilon (interaction.h spawn_ray:40-44)."""
    return (1.0 + vec.max_abs(p)) * m.RayEpsilon
