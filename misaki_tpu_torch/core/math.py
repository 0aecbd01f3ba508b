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


def safe_sqrt(x):
    """sqrt clamped away from 0 (finite gradient at x <= 0)."""
    return torch.sqrt(torch.clamp(x, min=1e-20))


def mis_power2(pdf_a, pdf_b):
    """Power-2 MIS heuristic (reference: integrators/path.cpp:127-131)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return torch.where(a2 > 0.0, a2 / torch.clamp(a2 + b2, min=F32_TINY), 0.0)
