"""Orthonormal shading frames, component-tuple SoA
(reference: include/misaki/core/frame.h, coordinate_system mathutils.h:186-203).

A frame is a dict {"s": vec3, "t": vec3, "n": vec3} of component tuples.
Local directions have n == +z.
"""

import torch

from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.core import vec


def coordinate_system(n):
    """Branchless Duff et al. ONB from a unit normal (mathutils.h:186-203)."""
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    t = (b, sign + ny * ny * a, -ny)
    return s, t


def make_frame(n):
    s, t = coordinate_system(n)
    return {"s": s, "t": t, "n": n}


def to_local(frame, v):
    return (
        vec.dot(v, frame["s"]),
        vec.dot(v, frame["t"]),
        vec.dot(v, frame["n"]),
    )


def to_world(frame, v):
    x, y, z = v
    return (
        frame["s"][0] * x + frame["t"][0] * y + frame["n"][0] * z,
        frame["s"][1] * x + frame["t"][1] * y + frame["n"][1] * z,
        frame["s"][2] * x + frame["t"][2] * y + frame["n"][2] * z,
    )


def cos_theta(v):
    return v[2]


def cos_theta_2(v):
    return v[2] * v[2]


def sin_theta_2(v):
    return torch.clamp(1.0 - cos_theta_2(v), min=0.0)


def sin_theta(v):
    return m.sqrt(sin_theta_2(v))


def tan_theta(v):
    return sin_theta(v) / v[2]
