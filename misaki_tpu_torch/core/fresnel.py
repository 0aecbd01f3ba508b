"""Fresnel terms and reflect / refract on component-tuple directions
(reference: include/misaki/render/fresnel.h).

Directions are vec3 component tuples in the local shading frame (+z = normal);
spectral eta / k of conductors are (4, L) tensors.
"""

import torch

from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.core import vec


def reflect(wi):
    """Mirror about the local +z frame normal (fresnel.h:12-15)."""
    return (-wi[0], -wi[1], wi[2])


def reflect_m(wi, mv):
    """Mirror about a half-vector (fresnel.h:17-20)."""
    k = 2.0 * vec.dot(wi, mv)
    return (mv[0] * k - wi[0], mv[1] * k - wi[1], mv[2] * k - wi[2])


def refract(wi, cos_theta_t, eta_ti):
    """Refract about the local +z normal (fresnel.h:22-27)."""
    return (-eta_ti * wi[0], -eta_ti * wi[1], cos_theta_t)


def refract_m(wi, mv, cos_theta_t, eta_ti):
    """Refract about a half-vector (fresnel.h:29-34)."""
    k = vec.dot(wi, mv) * eta_ti + cos_theta_t
    return (mv[0] * k - wi[0] * eta_ti, mv[1] * k - wi[1] * eta_ti, mv[2] * k - wi[2] * eta_ti)


def fresnel(cos_theta_i, eta):
    """Unpolarized dielectric Fresnel (fresnel.h:38-63); under total internal
    reflection cos_theta_t clamps to 0 and F to 1. eta is a tensor or a
    float. Returns (F, cos_theta_t, eta_it, eta_ti), each (L,)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=cos_theta_i.device)
    eta = eta.expand_as(cos_theta_i)
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    cti = torch.abs(cos_theta_i)
    ctt = m.safe_sqrt(cos_theta_t_sqr)

    a_s = (cti - eta_it * ctt) / torch.clamp(cti + eta_it * ctt, min=1e-20)
    a_p = (ctt - eta_it * cti) / torch.clamp(ctt + eta_it * cti, min=1e-20)
    r = 0.5 * (a_s * a_s + a_p * a_p)
    r = torch.where(cti == 0.0, 1.0, r)
    r = torch.where(eta == 1.0, 0.0, r)
    cos_theta_t = ctt * torch.sign(-cos_theta_i)
    return r, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Conductor Fresnel with complex IOR eta + i k (fresnel.h:65-88).
    cos_theta_i: (L,); eta, k: (4, L). Returns (4, L)."""
    c = cos_theta_i[None, :]
    cos2 = c * c
    sin2 = 1.0 - cos2
    sin4 = sin2 * sin2

    temp_1 = eta * eta - k * k - sin2
    a_2_pb_2 = m.sqrt(torch.clamp(temp_1 * temp_1 + 4.0 * k * k * eta * eta, min=1e-20))
    a = m.sqrt(torch.clamp(0.5 * (a_2_pb_2 + temp_1), min=1e-20))

    term_1 = a_2_pb_2 + cos2
    term_2 = 2.0 * c * a
    r_s = (term_1 - term_2) / torch.clamp(term_1 + term_2, min=1e-20)

    term_3 = a_2_pb_2 * cos2 + sin4
    term_4 = term_2 * sin2
    r_p = r_s * (term_3 - term_4) / torch.clamp(term_3 + term_4, min=1e-20)
    return 0.5 * (r_s + r_p)


def fresnel_diffuse_reflectance(eta):
    """Hemispherically integrated Fresnel reflectance fits (fresnel.h:93-125):
    Egan-Hilgeman below eta 1, d'Eon-Irving above."""
    eta = torch.as_tensor(eta, dtype=torch.float32)
    lo = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / eta
    inv = 1.0 / eta
    hi = (0.919317 - 3.4793 * inv + 6.75335 * inv ** 2 - 7.80989 * inv ** 3
          + 4.98554 * inv ** 4 - 1.36881 * inv ** 5)
    return torch.where(eta < 1.0, lo, hi)
