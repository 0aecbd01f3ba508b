"""4x4 homogeneous transforms for scene compilation
(reference: include/misaki/core/transform.h).

These run in NumPy at scene-compile time; geometry is baked to world space
so no transforms survive into the render kernels (except camera and UV
transforms, which become plain matrices in the compiled scene).
"""

import numpy as np


def identity():
    return np.eye(4, dtype=np.float64)


def translate(v):
    t = np.eye(4)
    t[:3, 3] = v
    return t


def scale(v):
    t = np.eye(4)
    t[0, 0], t[1, 1], t[2, 2] = v
    return t


def rotate(axis, angle_deg):
    """Rotation about an axis, angle in degrees (xml.cpp Rotate tag)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
    t = np.eye(4)
    t[:3, :3] = R
    return t


def lookat(origin, target, up):
    """Camera-to-world (transform.h:167-177): columns [left, new_up, dir, o]."""
    origin = np.asarray(origin, dtype=np.float64)
    d = np.asarray(target, dtype=np.float64) - origin
    d = d / np.linalg.norm(d)
    up = np.asarray(up, dtype=np.float64)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    new_up = new_up / np.linalg.norm(new_up)
    t = np.eye(4)
    t[:3, 0] = left
    t[:3, 1] = new_up
    t[:3, 2] = d
    t[:3, 3] = origin
    return t


def perspective(fov_deg, near, far):
    """Perspective projection (transform.h:179-187), x/y in [-1,1] at unit z
    after the reference's screen-space chain."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.deg2rad(fov_deg / 2.0))
    p = np.zeros((4, 4))
    p[0, 0] = cot
    p[1, 1] = cot
    p[2, 2] = far * recip
    p[2, 3] = -near * far * recip
    p[3, 2] = 1.0
    return p


def apply_point(t, p):
    """Apply to points (..., 3) with w-divide."""
    p = np.asarray(p, dtype=np.float64)
    r = p @ t[:3, :3].T + t[:3, 3]
    w = p @ t[3, :3].T + t[3, 3]
    return r / w[..., None]


def apply_vector(t, v):
    return np.asarray(v, dtype=np.float64) @ t[:3, :3].T


def apply_normal(t, n):
    inv = np.linalg.inv(t)
    return np.asarray(n, dtype=np.float64) @ inv[:3, :3]


def camera_to_sample(film_w, film_h, fov_deg, near, far):
    """The perspective camera's screen-space chain (perspective.cpp:13-19).

    aspect = width / height (sensor.cpp:43).
    """
    aspect = film_w / float(film_h)
    t = (
        scale([film_w, film_h, 1.0])
        @ scale([-0.5, -0.5 * aspect, 1.0])
        @ translate([-1.0, -1.0 / aspect, 0.0])
        @ perspective(fov_deg, near, far)
    )
    return t
