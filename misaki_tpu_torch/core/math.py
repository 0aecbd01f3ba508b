"""Math constants and safe helpers (reference: include/misaki/core/mathutils.h)."""

import numpy as np
import torch

Pi = float(np.pi)
InvPi = 1.0 / Pi
TwoPi = 2.0 * Pi
InvTwoPi = 1.0 / TwoPi
InvFourPi = 1.0 / (4.0 * Pi)

# mathutils.h:19-20 — float32 machine epsilon / 2 scaled up.
Epsilon = float(np.finfo(np.float32).eps) / 2.0
RayEpsilon = Epsilon * 1500.0          # ~8.94e-5
ShadowEpsilon = RayEpsilon * 10.0      # ~8.94e-4

F32_TINY = float(np.finfo(np.float32).tiny)


def sqrt(x):
    """float32 square root, correctly rounded on every device. torch's CPU
    float32 sqrt is off by one ulp on about 0.6% of inputs; the root taken
    in float64 and rounded once to float32 is correctly rounded, since
    53 >= 2 * 24 + 2. On CUDA tensors torch.sqrt is IEEE-rounded (the port
    builds nothing with fast math)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def cos(x):
    """float32 cosine, rounded once from float64 on the CPU: torch's CPU
    float32 cos is one ulp off XLA's on some inputs, which the cosine-
    hemisphere warp's z = sqrt(1 - x^2 - y^2) turns into up to 1e-3 of z
    at the disk's rim. On CUDA tensors torch.cos."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.cos(x.double()).float()
    return torch.cos(x)


def sin(x):
    """float32 sine, rounded as `cos` is."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sin(x.double()).float()
    return torch.sin(x)


def safe_sqrt(x):
    """sqrt clamped away from 0 (finite gradient at x <= 0)."""
    return sqrt(torch.clamp(x, min=1e-20))


def safe_rsqrt(x):
    return 1.0 / sqrt(torch.clamp(x, min=F32_TINY))


def safe_acos(x):
    return torch.acos(torch.clamp(x, -1.0, 1.0))


def safe_asin(x):
    return torch.asin(torch.clamp(x, -1.0, 1.0))


def sqr(x):
    return x * x


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims dropped."""
    return torch.sum(a * b, dim=-1)


def norm(v):
    return sqrt(torch.sum(v * v, dim=-1))


def normalize(v):
    return v * safe_rsqrt(torch.sum(v * v, dim=-1, keepdim=True))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def mis_power2(pdf_a, pdf_b):
    """Power-2 MIS heuristic (reference: integrators/path.cpp:127-131)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return torch.where(a2 > 0.0, a2 / torch.clamp(a2 + b2, min=F32_TINY), 0.0)
