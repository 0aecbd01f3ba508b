"""Square -> distribution warps, component-tuple SoA
(reference: include/misaki/core/warp.h).

Samples are (u, v) tuples of (L,) tensors; outputs are vec2/vec3 tuples.
"""

import torch

from misaki_tpu_torch.core import math as m


def square_to_uniform_triangle(sample):
    """warp.h:12-16 — barycentric (u, v) in the unit triangle."""
    t = m.safe_sqrt(1.0 - sample[0])
    return (1.0 - t, t * sample[1])


def square_to_uniform_disk_concentric(sample):
    """warp.h:18-32 — Shirley's concentric disk mapping."""
    x = 2.0 * sample[0] - 1.0
    y = 2.0 * sample[1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_x = x * x > y * y
    r = torch.where(quadrant_x, x, y)
    safe_x = torch.where(x == 0.0, 1.0, x)
    safe_y = torch.where(y == 0.0, 1.0, y)
    phi = torch.where(
        quadrant_x,
        (m.Pi / 4.0) * (y / safe_x),
        (m.Pi / 2.0) - (x / safe_y) * (m.Pi / 4.0),
    )
    r = torch.where(is_zero, 0.0, r)
    phi = torch.where(is_zero, 0.0, phi)
    return (r * m.cos(phi), r * m.sin(phi))


def square_to_cosine_hemisphere(sample):
    """warp.h:34-40 — Malley's method via the concentric disk."""
    px, py = square_to_uniform_disk_concentric(sample)
    z = m.safe_sqrt(1.0 - px * px - py * py)
    return (px, py, z)


def square_to_cosine_hemisphere_pdf(v):
    return m.InvPi * v[2]


def square_to_uniform_sphere(sample):
    """warp.h:46-53."""
    z = -2.0 * sample[1] + 1.0
    r = m.safe_sqrt(1.0 - z * z)
    t = 2.0 * m.Pi * sample[0]
    return (r * torch.cos(t), r * torch.sin(t), z)


def square_to_uniform_sphere_pdf(v):
    return torch.full_like(v[2], m.InvFourPi)
