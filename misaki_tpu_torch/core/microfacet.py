"""GGX / Beckmann microfacet distribution on component-tuple directions
(reference: include/misaki/render/microfacet.h).

The reference's sampling: classic polar sampling of the GGX NDF (no
visible-normal sampling), GGX eval and sample, and Smith G1 for GGX and
Beckmann. Alphas clamp to >= 1e-4. Directions are vec3 tuples, scalars (L,).
"""

import torch

from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.core import vec

ALPHA_MIN = 1e-4

GGX = 1
BECKMANN = 0


def clamp_alpha(alpha):
    return torch.clamp(alpha, min=ALPHA_MIN)


def eval_ggx(mv, alpha_u, alpha_v):
    """Anisotropic GGX NDF D(m) (microfacet.h:11-18), 0 below the horizon."""
    mx, my, mz = mv
    cos_theta2 = torch.clamp(mz * mz, min=1e-20)
    beckmann_exp = (mx * mx / (alpha_u * alpha_u) + my * my / (alpha_v * alpha_v)) / cos_theta2
    root = (1.0 + beckmann_exp) * cos_theta2
    denom = m.Pi * alpha_u * alpha_v * root * root
    d = 1.0 / denom
    d = torch.where(_tame(d), 1.0 / torch.where(_tame(d), denom, 1.0), d.detach())
    return torch.where((mz > 0.0) & (d * mz > 1e-20), d, 0.0)


def _tame(x):
    """Where a reciprocal x = 1 / y keeps a finite gradient: its derivative
    -x^2 overflows past 1e19, and times the zero cotangent of a lane that a
    later where drops it would give NaN. Elsewhere the value is kept
    detached (the double-where of misaki_tpu/render/ppm.py:371-373)."""
    return torch.abs(x) < 1e19


def pdf_ggx(mv, alpha_u, alpha_v):
    """pdf(m) = D(m) cos_theta(m)."""
    return eval_ggx(mv, alpha_u, alpha_v) * mv[2]


def sample_ggx(sample, alpha_u, alpha_v):
    """Polar anisotropic GGX NDF sample (microfacet.h:20-40).
    sample: (u, v) tuple. Returns (m vec3, pdf)."""
    s0, s1 = sample
    phi_m = (torch.atan(alpha_u / alpha_v * torch.tan(m.Pi + 2.0 * m.Pi * s1))
             + m.Pi * torch.floor(2.0 * s1 + 0.5))
    sin_phi_m = torch.sin(phi_m)
    cos_phi_m = torch.cos(phi_m)
    c = cos_phi_m / alpha_u
    s = sin_phi_m / alpha_v
    alpha_sqr = 1.0 / (c * c + s * s)
    tan_theta_m_sqr = alpha_sqr * s0 / torch.clamp(1.0 - s0, min=1e-20)
    cos_theta_m = 1.0 / m.sqrt(1.0 + tan_theta_m_sqr)
    tmp = 1.0 + tan_theta_m_sqr / alpha_sqr
    pdf = m.InvPi / (alpha_u * alpha_v * cos_theta_m * cos_theta_m * cos_theta_m * tmp * tmp)
    pdf = torch.where(pdf < 1e-20, 0.0, pdf)
    sin_theta_m = m.safe_sqrt(1.0 - cos_theta_m * cos_theta_m)
    return (sin_theta_m * cos_phi_m, sin_theta_m * sin_phi_m, cos_theta_m), pdf


def smith_g1(v, mv, alpha_u, alpha_v, distr_type=GGX):
    """Smith masking term for one direction (microfacet.h:150-175);
    `distr_type` is GGX, BECKMANN or a per-lane (L,) tensor of either."""
    vx, vy, vz = v
    xy_alpha_2 = m.sqr(alpha_u * vx) + m.sqr(alpha_v * vy)
    tan_theta_alpha_2 = xy_alpha_2 / torch.clamp(m.sqr(vz), min=1e-20)

    g_ggx = 2.0 / (1.0 + m.sqrt(1.0 + tan_theta_alpha_2))
    a = 1.0 / m.sqrt(torch.clamp(tan_theta_alpha_2, min=1e-20))
    a_sqr = a * a
    g_b = torch.where(a >= 1.6, 1.0,
                      (3.535 * a + 2.181 * a_sqr) / (1.0 + 2.276 * a + 2.577 * a_sqr))
    g = torch.where(torch.as_tensor(distr_type, device=vz.device) == GGX, g_ggx, g_b)
    g = torch.where(xy_alpha_2 == 0.0, 1.0, g)
    return torch.where(vec.dot(v, mv) * vz <= 0.0, 0.0, g)


def G(wi, wo, mv, alpha_u, alpha_v, distr_type=GGX):
    return (smith_g1(wi, mv, alpha_u, alpha_v, distr_type)
            * smith_g1(wo, mv, alpha_u, alpha_v, distr_type))
