"""Wavefront BSDF evaluation: sample / eval / pdf over SoA lane batches.

Every lane's material row is loaded by index from the packed material table,
and each model present in the scene is computed on every lane and selected
by the lane's material kind, as in `misaki_tpu.bsdf.kernels`. This port
carries the diffuse lobe (bsdfs/diffuse.cpp); a scene with another kind
raises NotImplementedError naming it.

Conventions (bsdf.h): directions in the local shading frame, +z = normal;
`sample` returns weight = f * cos(theta_o) / pdf; `eval` returns
f * cos(theta_o); twosided flips wi.z / wo.z on back faces.
"""

import torch

from misaki_tpu_torch.core import frame, warp
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.render import textures as tex
from misaki_tpu_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_NAMES,
    BSDF_NULL,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
    MASK_FLAG,
    MC_KIND,
    MC_REFL,
    MC_TWOSIDED,
    SCALAR_SLOT_COLS,
    SPEC_SLOT_COLS,
)

PORTED_KINDS = (BSDF_DIFFUSE,)


def rgb_to_spectral(rgb, wavelengths):
    """Map an RGB tuple to hero wavelengths by piecewise-linear interpolation
    between channel anchors (B=465nm, G=532nm, R=630nm).
    rgb: (r, g, b) of (L,); wavelengths (4, L) -> (4, L)."""
    r, g, b = rgb
    t1 = torch.clamp((wavelengths - 465.0) / (532.0 - 465.0), 0.0, 1.0)
    t2 = torch.clamp((wavelengths - 532.0) / (630.0 - 532.0), 0.0, 1.0)
    lo = b[None, :] * (1.0 - t1) + g[None, :] * t1
    hi = g[None, :] * (1.0 - t2) + r[None, :] * t2
    return torch.where(wavelengths < 532.0, lo, hi)


def is_smooth_kind(kind):
    """BSDFFlags::Smooth — kinds NEE can connect to (non-delta lobes)."""
    return (
        (kind == BSDF_DIFFUSE)
        | (kind == BSDF_ROUGH_CONDUCTOR)
        | (kind == BSDF_ROUGH_DIELECTRIC)
        | (kind == BSDF_PLASTIC)
        | (kind == BSDF_DISNEY)
    )


def spectral_slot(scene, cols, base, uv, wavelengths, duv=None):
    """The spectral slot at column `base` of the lanes' material columns
    -> (4, L). Bitmaps are evaluated only for the slots listed in
    `scene.bitmap_slots`, with the texture footprint `duv`."""
    sc = scene if base in scene.bitmap_slots else None
    return tex.eval_spectral_slot(cols[base: base + SPEC_SLOT_COLS], uv, wavelengths,
                                  scene=sc, duv=duv)


def scalar_slot(scene, cols, base, uv, duv=None):
    """The scalar slot at column `base` of the lanes' material columns
    -> (L,), without a roughness clamp (the BSDFs that read scalar slots
    apply their own)."""
    sc = scene if base in scene.bitmap_slots else None
    return tex.eval_scalar_slot(cols[base: base + SCALAR_SLOT_COLS], uv, scene=sc, duv=duv)


def material_params(scene, ids, uv, wavelengths, duv=None):
    """One indexed load of every lane's packed material column, then the
    slot evaluation. Returns the per-lane param dict shared by
    sample/eval/pdf for the bounce. `duv` (the primary hit's texture
    footprint; zeros on bounce hits) selects the bitmap mip level."""
    kinds = scene.bsdf_kinds
    for k in kinds:
        if k not in PORTED_KINDS:
            name = "mask" if k == MASK_FLAG else BSDF_NAMES.get(k, str(k))
            raise NotImplementedError(f"BSDF '{name}'")
    cols = scene.materials.params[:, ids.to(torch.int64)]   # (N_MAT_COLS, L)
    kind = cols[MC_KIND].to(torch.int32)
    return {
        "kind": kind,
        "kinds": kinds,
        "twosided": cols[MC_TWOSIDED] > 0.5,
        "reflectance": spectral_slot(scene, cols, MC_REFL, uv, wavelengths, duv),
        "smooth": is_smooth_kind(kind),
    }


def _flip_z(v, flip):
    return (v[0], v[1], torch.where(flip, -v[2], v[2]))


def _eval_diffuse(p, wi, wo):
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    ok = (cti > 0.0) & (cto > 0.0)
    val = p["reflectance"] * (m.InvPi * cto)[None, :]
    return torch.where(ok[None, :], val, 0.0)


def _pdf_diffuse(p, wi, wo):
    ok = (frame.cos_theta(wi) > 0.0) & (frame.cos_theta(wo) > 0.0)
    return torch.where(ok, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def eval_bsdf(p, wi, wo):
    """f * cos_theta_o per lane (4, L)."""
    flip = p["twosided"] & (frame.cos_theta(wi) < 0.0)
    wi = _flip_z(wi, flip)
    wo = _flip_z(wo, flip)
    out = torch.zeros_like(p["reflectance"])
    return torch.where((p["kind"] == BSDF_DIFFUSE)[None, :], _eval_diffuse(p, wi, wo), out)


def pdf_bsdf(p, wi, wo):
    flip = p["twosided"] & (frame.cos_theta(wi) < 0.0)
    wi = _flip_z(wi, flip)
    wo = _flip_z(wo, flip)
    out = torch.zeros_like(frame.cos_theta(wi))
    return torch.where(p["kind"] == BSDF_DIFFUSE, _pdf_diffuse(p, wi, wo), out)


def sample_bsdf(p, wi, u1, u2):
    """Importance-sample the per-lane BSDF. Returns SoA dict with keys
    wo (vec3), pdf (L,), weight (4, L) = f cos / pdf, eta, delta, null,
    valid. `u1` is the lobe-selection sample (unused by diffuse)."""
    flip = p["twosided"] & (frame.cos_theta(wi) < 0.0)
    wi_f = _flip_z(wi, flip)
    kind = p["kind"]
    is_diffuse = kind == BSDF_DIFFUSE

    # diffuse: cosine-hemisphere (diffuse.cpp:18-33)
    wo_d = warp.square_to_cosine_hemisphere(u2)
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo_d)
    valid_d = (frame.cos_theta(wi_f) > 0.0) & (pdf_d > 0.0)
    pdf = torch.where(valid_d, pdf_d, 0.0)
    weight = torch.where(valid_d[None, :], p["reflectance"], 0.0)
    return {
        "wo": _flip_z(wo_d, flip),
        "pdf": torch.where(is_diffuse, pdf, 0.0),
        "weight": torch.where(is_diffuse[None, :], weight, 0.0),
        "eta": torch.ones_like(pdf_d),
        "delta": (kind == BSDF_DIELECTRIC) | (kind == BSDF_CONDUCTOR) | (kind == BSDF_NULL),
        "null": kind == BSDF_NULL,
        "valid": torch.where(is_diffuse, valid_d, False),
    }
