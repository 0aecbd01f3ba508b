"""Component-tuple SoA vector math, the wavefront's data layout.

Every per-lane vector is a tuple of component tensors, the same layout as
`misaki_tpu.core.vec`, so the port's functions compare like with like:

    v3 = (x, y, z)         # each (L,) float32
    v2 = (u, v)
    spectra stay (4, L) tensors (wavelength-major, lane-minor)
"""

import torch

from misaki_tpu_torch.core import math as m


def splat3(c, like):
    """Constant vector broadcast against a lane tensor."""
    o = torch.ones_like(like)
    return (o * c[0], o * c[1], o * c[2])


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def neg(a):
    return (-a[0], -a[1], -a[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def mul(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm2(a):
    return dot(a, a)


def norm(a):
    return m.sqrt(norm2(a))


def normalize(a):
    inv = 1.0 / m.sqrt(torch.clamp(norm2(a), min=1e-30))
    return scale(a, inv)


def where(mask, a, b):
    """Per-lane select between two vec3s; mask is (L,)."""
    return (
        torch.where(mask, a[0], b[0]),
        torch.where(mask, a[1], b[1]),
        torch.where(mask, a[2], b[2]),
    )


def lerp(a, b, t):
    return (
        a[0] * (1.0 - t) + b[0] * t,
        a[1] * (1.0 - t) + b[1] * t,
        a[2] * (1.0 - t) + b[2] * t,
    )


def max_abs(a):
    return torch.maximum(torch.abs(a[0]), torch.maximum(torch.abs(a[1]), torch.abs(a[2])))
