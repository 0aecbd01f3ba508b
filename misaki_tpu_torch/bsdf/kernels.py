"""Wavefront BSDF evaluation: sample / eval / pdf over SoA lane batches.

Every lane's material column is loaded by index from the packed material
table, only in the rows that the scene's kinds read (`material_rows`), and
each model present in the scene (`scene.bsdf_kinds`) is computed on every
lane and selected by the lane's material kind, as in
`misaki_tpu.bsdf.kernels`. Models absent from the scene are not computed.

Kinds: diffuse (bsdfs/diffuse.cpp), roughconductor (roughconductor.cpp),
roughdielectric (roughdielectric.cpp), dielectric (dielectric.cpp), smooth
conductor (conductor.cpp), roughplastic (roughplastic.cpp), Disney principled
(disney_brdf.cpp, the canonical 2012 model; see below) and null; twosided
(twosided.cpp) is a per-row flag and mask (mask.cpp) a per-row wrapper with
an opacity slot (the MASK_FLAG pseudo-kind).

Conventions (bsdf.h): directions in the local shading frame, +z = normal;
`sample` returns weight = f * cos(theta_o) / pdf; `eval` returns
f * cos(theta_o), 0 for delta lobes; twosided flips wi.z / wo.z on back
faces. Radiance transport: refraction scales by 1 / eta^2.
"""

import functools

import torch

from misaki_tpu_torch.core import frame, fresnel, microfacet, spectrum, vec, warp
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.render import textures as tex
from misaki_tpu_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_NULL,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
    MASK_FLAG,
    MC_ALPHA_U,
    MC_ALPHA_V,
    MC_DISTR,
    MC_DS_ANISO,
    MC_DS_CC_GLOSS,
    MC_DS_CLEARCOAT,
    MC_DS_METALLIC,
    MC_DS_SHEEN,
    MC_DS_SHEEN_TINT,
    MC_DS_SPEC_TINT,
    MC_DS_SPECULAR,
    MC_DS_SUBSURFACE,
    MC_ETA,
    MC_ETA_RGB,
    MC_FDR,
    MC_K_RGB,
    MC_KIND,
    MC_MASK,
    MC_NONLINEAR,
    MC_OPACITY,
    MC_REFL,
    MC_SPEC_REFL,
    MC_SPEC_TRANS,
    MC_SSW,
    MC_TWOSIDED,
    N_MAT_COLS,
    SCALAR_SLOT_COLS,
    SPEC_SLOT_COLS,
)
from misaki_tpu_torch.utils import tracing

_TINY = 1e-20

ALL_KINDS = (
    BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
    BSDF_DIELECTRIC, BSDF_CONDUCTOR, BSDF_NULL, BSDF_PLASTIC, BSDF_DISNEY,
)

_DISNEY_SLOTS = (
    ("subsurface", MC_DS_SUBSURFACE), ("metallic", MC_DS_METALLIC),
    ("specular", MC_DS_SPECULAR), ("spec_tint", MC_DS_SPEC_TINT),
    ("aniso", MC_DS_ANISO), ("sheen", MC_DS_SHEEN), ("sheen_tint", MC_DS_SHEEN_TINT),
    ("clearcoat", MC_DS_CLEARCOAT), ("cc_gloss", MC_DS_CC_GLOSS),
)


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
    -> (L,), without a roughness clamp (Disney's [0, 1] parameters are not
    alphas; the microfacet slots clamp where they are read)."""
    sc = scene if base in scene.bitmap_slots else None
    return tex.eval_scalar_slot(cols[base: base + SCALAR_SLOT_COLS], uv, scene=sc, duv=duv)


def _kind_groups(kinds):
    """Which parameter groups the scene's kinds read."""
    has_disney = BSDF_DISNEY in kinds
    has_conductor = BSDF_ROUGH_CONDUCTOR in kinds or BSDF_CONDUCTOR in kinds
    has_transmission = BSDF_ROUGH_DIELECTRIC in kinds or BSDF_DIELECTRIC in kinds
    return {
        "disney": has_disney,
        "microfacet": has_disney or any(k in kinds for k in (
            BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_PLASTIC)),
        "conductor": has_conductor,
        "specular": has_conductor or has_transmission or BSDF_PLASTIC in kinds,
        "transmission": has_transmission,
        "reflectance": BSDF_DIFFUSE in kinds or BSDF_PLASTIC in kinds,
        "mask": MASK_FLAG in kinds,
    }


def material_rows(kinds):
    """The rows of the packed material table that `material_params` reads
    under the BSDF kinds `kinds`, ascending, so that each slot stays a
    contiguous run: the flags and scalars its dict always holds, then each
    group that some kind reads (`_kind_groups`). Every group gives all 165."""
    has = _kind_groups(kinds)
    rows = [MC_KIND, MC_TWOSIDED, MC_DISTR, MC_ETA, MC_SSW, MC_NONLINEAR, MC_FDR]
    slots = []
    if has["reflectance"] or has["disney"]:
        slots.append((MC_REFL, SPEC_SLOT_COLS))
    if has["specular"]:
        slots.append((MC_SPEC_REFL, SPEC_SLOT_COLS))
    if has["transmission"]:
        slots.append((MC_SPEC_TRANS, SPEC_SLOT_COLS))
    if has["microfacet"]:
        slots += [(MC_ALPHA_U, SCALAR_SLOT_COLS), (MC_ALPHA_V, SCALAR_SLOT_COLS)]
    if has["conductor"]:
        slots += [(MC_ETA_RGB, 3), (MC_K_RGB, 3)]
    if has["disney"]:
        slots += [(base, SCALAR_SLOT_COLS) for _, base in _DISNEY_SLOTS]
    if has["mask"]:
        slots += [(MC_MASK, 1), (MC_OPACITY, SPEC_SLOT_COLS)]
    for base, width in slots:
        rows.extend(range(base, base + width))
    return tuple(sorted(rows))


@functools.cache
def _row_index(rows, device):
    """`rows` as an int64 tensor on `device`, made once a process: the first
    eager bounce makes it, so a CUDA graph captured after it reads the same
    tensor on every replay. It is made outside inference mode, so a gradient
    may save it after a frame made it."""
    with torch.inference_mode(False):
        return torch.tensor(rows, dtype=torch.int64, device=device)


class _Columns:
    """The lanes' gathered rows of the material table (`block`, (len(rows),
    L)), read by the table's own columns: `cols[MC_ETA]` a row,
    `cols[base: base + n]` a slot's rows."""

    def __init__(self, block, rows):
        self.block = block
        self.at = {c: i for i, c in enumerate(rows)}

    def __getitem__(self, col):
        if isinstance(col, slice):
            i = self.at[col.start]
            return self.block[i: i + col.stop - col.start]
        return self.block[self.at[col]]


def material_params(scene, ids, uv, wavelengths, duv=None):
    """One indexed load of every lane's packed material column, in the rows
    that the scene's kinds read (`material_rows`), then the slot
    evaluation. Returns the per-lane param dict shared by
    sample/eval/pdf for the bounce. `duv` (the primary hit's texture
    footprint; zeros on bounce hits) selects the bitmap mip level. Groups of
    parameters that no kind of the scene reads are zeros (or None), as in
    misaki_tpu.

    Roughness and the Disney slots carry gradients only under
    `scene.diff_mode` (misaki_tpu/bsdf/kernels.py:136-161): outside it they
    are detached, and in it `sample_bsdf` samples with detached alpha and
    recomputes the rough lobes' weight (misaki_tpu_torch.diff)."""
    kinds = scene.bsdf_kinds
    diff = scene.diff_mode
    has = _kind_groups(kinds)
    L = ids.shape[0]
    dev = wavelengths.device
    zero_spec = torch.zeros((4, L), device=dev)
    rows = material_rows(kinds)
    tracing.add(tracing.MATERIAL_ROWS_GATHERED, len(rows) * L)
    tracing.add(tracing.MATERIAL_ROWS_PACKED, N_MAT_COLS * L)
    block = _MaterialColumns.apply(scene.materials.params, ids.to(torch.int64),
                                   _row_index(rows, ids.device))  # (len(rows), L)
    cols = _Columns(block, rows)
    kind = cols[MC_KIND].to(torch.int32)

    def spec(base):
        return spectral_slot(scene, cols, base, uv, wavelengths, duv)

    def attach(x):
        return x if diff else x.detach()

    def alpha(base):
        return attach(microfacet.clamp_alpha(scalar_slot(scene, cols, base, uv, duv)))

    def rgb(base):
        return (cols[base], cols[base + 1], cols[base + 2])

    disney = None
    ds_spec0 = ds_sheen = zero_spec
    reflectance = spec(MC_REFL) if has["disney"] or has["reflectance"] else zero_spec
    if has["disney"]:
        disney = {name: attach(scalar_slot(scene, cols, base, uv, duv))
                  for name, base in _DISNEY_SLOTS}
        # spectral tint = base colour / its CIE-Y luminance at the hero
        # wavelengths (Burley's c_tint = rgb / lum); c_spec0 =
        # lerp(0.08 * specular * lerp(1, tint, spec_tint), base, metallic)
        ybar = spectrum.cie1931_xyz(wavelengths)[1]
        lum = torch.sum(reflectance * ybar, dim=0) / torch.clamp(torch.sum(ybar, dim=0), min=1e-9)
        tint = torch.where((lum > 1e-6)[None, :],
                           reflectance / torch.clamp(lum, min=1e-6)[None, :], 1.0)
        spec_mix = 1.0 + (tint - 1.0) * disney["spec_tint"][None, :]
        f0_diel = 0.08 * disney["specular"][None, :] * spec_mix
        met = disney["metallic"][None, :]
        ds_spec0 = f0_diel * (1.0 - met) + reflectance * met
        ds_sheen = (1.0 + (tint - 1.0) * disney["sheen_tint"][None, :]) * disney["sheen"][None, :]

    zero = torch.zeros(L, device=dev)
    return {
        "kind": kind,
        "kinds": kinds,
        "twosided": cols[MC_TWOSIDED] > 0.5,
        "distr": cols[MC_DISTR].to(torch.int32),
        "reflectance": reflectance,
        "spec_refl": spec(MC_SPEC_REFL) if has["specular"] else zero_spec,
        "spec_trans": spec(MC_SPEC_TRANS) if has["transmission"] else zero_spec,
        "alpha_u": alpha(MC_ALPHA_U) if has["microfacet"] else zero,
        "alpha_v": alpha(MC_ALPHA_V) if has["microfacet"] else zero,
        "eta": cols[MC_ETA],
        "eta_spec": rgb_to_spectral(rgb(MC_ETA_RGB), wavelengths) if has["conductor"]
        else zero_spec,
        "k_spec": rgb_to_spectral(rgb(MC_K_RGB), wavelengths) if has["conductor"] else zero_spec,
        "smooth": is_smooth_kind(kind),
        "diff": diff,
        # roughplastic (zeros on other rows)
        "ssw": cols[MC_SSW],
        "fdr": cols[MC_FDR],
        "nonlinear": cols[MC_NONLINEAR] > 0.5,
        # the mask wrapper (mask.cpp): the rows it wraps, their opacity
        "mask": cols[MC_MASK] > 0.5 if has["mask"] else None,
        "opacity": spec(MC_OPACITY) if has["mask"] else None,
        "disney": disney,
        "ds_spec0": ds_spec0,
        "ds_sheen": ds_sheen,
    }


class _MaterialColumns(torch.autograd.Function):
    """params[rows][:, ids]: every lane's material column in the table's
    rows `rows`. The rows are selected first, so the lanes' gather writes
    only those. Its backward sums the lanes' gradients per material as one
    matmul with the lanes' one-hot (L, B) rows, the transpose of
    misaki_tpu's one-hot fetch, and writes them into those rows of a zero
    gradient of the whole table. A scatter (advanced indexing's or
    index_add_'s) serialises the millions of lanes that share each of a
    scene's few materials: it took most of a cbox gradient step on an H100
    (chip_smoke.py phase 15's profiled step)."""

    @staticmethod
    def forward(ctx, params, ids, rows):
        ctx.save_for_backward(ids, rows)
        ctx.table_shape = params.shape
        return torch.index_select(params.index_select(0, rows), 1, ids)

    @staticmethod
    def backward(ctx, grad):
        ids, rows = ctx.saved_tensors
        onehot = torch.zeros((ids.shape[0], ctx.table_shape[1]), dtype=grad.dtype,
                             device=grad.device)
        onehot.scatter_(1, ids[:, None], 1.0)
        # full float32 products whatever the process allows: TF32 would
        # round every lane's gradient to 10 bits of mantissa
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            sums = grad @ onehot
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
        table = torch.zeros(ctx.table_shape, dtype=grad.dtype, device=grad.device)
        return table.index_copy_(0, rows, sums), None, None


def _flip_z(v, flip):
    return (v[0], v[1], torch.where(flip, -v[2], v[2]))


def _half(wi, wo):
    return vec.normalize(vec.add(wi, wo))


# ---------------------------------------------------------------------------
# diffuse
# ---------------------------------------------------------------------------

def _eval_diffuse(p, wi, wo):
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    ok = (cti > 0.0) & (cto > 0.0)
    val = p["reflectance"] * (m.InvPi * cto)[None, :]
    return torch.where(ok[None, :], val, 0.0)


def _pdf_diffuse(p, wi, wo):
    ok = (frame.cos_theta(wi) > 0.0) & (frame.cos_theta(wo) > 0.0)
    return torch.where(ok, warp.square_to_cosine_hemisphere_pdf(wo), 0.0)


def _sample_diffuse(p, wi, u2):
    """Cosine-hemisphere sampling (diffuse.cpp:18-33)."""
    wo = warp.square_to_cosine_hemisphere(u2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    valid = (frame.cos_theta(wi) > 0.0) & (pdf > 0.0)
    return {"wo": wo, "pdf": torch.where(valid, pdf, 0.0),
            "weight": torch.where(valid[None, :], p["reflectance"], 0.0),
            "eta": torch.ones_like(pdf), "valid": valid}


def _sample_null(p, wi):
    """Delta pass-through (BSDFFlags::Null): straight on, weight 1."""
    ones = torch.ones_like(frame.cos_theta(wi))
    return {"wo": vec.neg(wi), "pdf": ones, "weight": torch.ones_like(p["reflectance"]),
            "eta": ones, "valid": torch.ones_like(ones, dtype=torch.bool)}


# ---------------------------------------------------------------------------
# conductors
# ---------------------------------------------------------------------------

def _eval_roughconductor(p, wi, wo):
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    ok = (cti > 0.0) & (cto > 0.0)
    H = _half(wi, wo)
    D = microfacet.eval_ggx(H, p["alpha_u"], p["alpha_v"])
    Gv = microfacet.G(wi, wo, H, p["alpha_u"], p["alpha_v"], p["distr"])
    result = D * Gv / (4.0 * torch.clamp(cti, min=_TINY))
    F = fresnel.fresnel_conductor(vec.dot(wi, H), p["eta_spec"], p["k_spec"])
    val = F * p["spec_refl"] * result[None, :]
    return torch.where((ok & (D > 0.0))[None, :], val, 0.0)


def _pdf_roughconductor(p, wi, wo):
    H = _half(wi, wo)
    ok = ((frame.cos_theta(wi) > 0.0) & (frame.cos_theta(wo) > 0.0)
          & (vec.dot(wi, H) > 0.0) & (vec.dot(wo, H) > 0.0))
    pdf = microfacet.pdf_ggx(H, p["alpha_u"], p["alpha_v"]) / (
        4.0 * torch.clamp(vec.dot(wo, H), min=_TINY))
    return torch.where(ok, pdf, 0.0)


def _sample_roughconductor(p, wi, u2):
    cti = frame.cos_theta(wi)
    mv, pdf = microfacet.sample_ggx(u2, p["alpha_u"], p["alpha_v"])
    wo = fresnel.reflect_m(wi, mv)
    valid = (cti > 0.0) & (pdf != 0.0) & (frame.cos_theta(wo) > 0.0)
    Gv = microfacet.G(wi, wo, mv, p["alpha_u"], p["alpha_v"], p["distr"])
    weight_s = Gv * vec.dot(wi, mv) / torch.clamp(cti * frame.cos_theta(mv), min=_TINY)
    pdf = pdf / torch.clamp(4.0 * vec.dot(wo, mv), min=_TINY)
    F = fresnel.fresnel_conductor(vec.dot(wi, mv), p["eta_spec"], p["k_spec"])
    weight = F * p["spec_refl"] * weight_s[None, :]
    return {"wo": wo, "pdf": torch.where(valid, pdf, 0.0),
            "weight": torch.where(valid[None, :], weight, 0.0),
            "eta": torch.ones_like(pdf), "valid": valid}


def _sample_conductor(p, wi):
    """Smooth conductor (conductor.cpp): delta mirror."""
    cti = frame.cos_theta(wi)
    F = fresnel.fresnel_conductor(torch.abs(cti), p["eta_spec"], p["k_spec"])
    valid = cti > 0.0
    return {"wo": fresnel.reflect(wi), "pdf": torch.where(valid, 1.0, 0.0),
            "weight": torch.where(valid[None, :], F * p["spec_refl"], 0.0),
            "eta": torch.ones_like(cti), "valid": valid}


# ---------------------------------------------------------------------------
# dielectrics
# ---------------------------------------------------------------------------

def _dielectric_half(p, wi, wo):
    """The generalized half-vector of a rough dielectric pair, toward +z
    (roughdielectric.cpp:118-130). Returns (m, reflect, eta_r)."""
    cti = frame.cos_theta(wi)
    reflect = cti * frame.cos_theta(wo) > 0.0
    eta_r = torch.where(cti > 0.0, p["eta"], 1.0 / p["eta"])
    mv = vec.normalize(vec.add(wi, vec.scale(wo, torch.where(reflect, 1.0, eta_r))))
    return vec.scale(mv, torch.sign(frame.cos_theta(mv))), reflect, eta_r


def _eval_roughdielectric(p, wi, wo):
    cti = frame.cos_theta(wi)
    mv, reflect, eta_r = _dielectric_half(p, wi, wo)
    inv_eta_r = torch.where(cti > 0.0, 1.0 / p["eta"], p["eta"])
    D = microfacet.eval_ggx(mv, p["alpha_u"], p["alpha_v"])
    F = fresnel.fresnel(vec.dot(wi, mv), p["eta"])[0]
    Gv = microfacet.G(wi, wo, mv, p["alpha_u"], p["alpha_v"], p["distr"])
    # reflection lobe (roughdielectric.cpp:139-142)
    val_r = (F * D * Gv / (4.0 * torch.clamp(torch.abs(cti), min=_TINY)))[None, :] * p["spec_refl"]
    # transmission lobe, radiance-mode scale (roughdielectric.cpp:144-156)
    denom = m.sqr(vec.dot(wi, mv) + eta_r * vec.dot(wo, mv))
    num = (inv_eta_r * inv_eta_r * (1.0 - F) * D * Gv * eta_r * eta_r
           * vec.dot(wi, mv) * vec.dot(wo, mv))
    val_t = torch.abs(num / torch.where(torch.abs(cti * denom) < _TINY, _TINY, cti * denom))
    val_t = val_t[None, :] * p["spec_trans"]
    ok = torch.abs(cti) > 0.0
    return torch.where(ok[None, :], torch.where(reflect[None, :], val_r, val_t), 0.0)


def _pdf_roughdielectric(p, wi, wo):
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    mv, reflect, eta_r = _dielectric_half(p, wi, wo)
    ok = (vec.dot(wi, mv) * cti > 0.0) & (vec.dot(wo, mv) * cto > 0.0) & (torch.abs(cti) > 0.0)
    dwh_dwo = torch.where(
        reflect,
        1.0 / torch.clamp(4.0 * torch.abs(vec.dot(wo, mv)), min=_TINY),
        eta_r * eta_r * torch.abs(vec.dot(wo, mv))
        / torch.clamp(m.sqr(vec.dot(wi, mv) + eta_r * vec.dot(wo, mv)), min=_TINY),
    )
    s = 1.2 - 0.2 * m.sqrt(torch.abs(cti))  # scaled distribution (rd.cpp:177-183)
    prob = microfacet.pdf_ggx(mv, p["alpha_u"] * s, p["alpha_v"] * s)
    F = fresnel.fresnel(vec.dot(wi, mv), p["eta"])[0]
    prob = prob * torch.where(reflect, F, 1.0 - F)
    return torch.where(ok, prob * torch.abs(dwh_dwo), 0.0)


def _sample_roughdielectric(p, wi, u1, u2):
    """Rough dielectric sampling (roughdielectric.cpp:60-116), taken in
    float64 and rounded once to the inputs' type. On a microfacet seen at a
    grazing angle (wi.m ~ 1e-5, a refraction near total internal reflection)
    the float32 formulas turn the last bits of m, wi.m and 1 - F into the
    pdf's leading digits: misaki_tpu's float32 pdf and the port's differed
    there by up to 25%, each off the float64 value, on about one lane in
    10^5 (tests/torch_bsdf_seed_scan.py)."""
    dt = u1.dtype
    q = {k: p[k].double() for k in ("alpha_u", "alpha_v", "eta", "spec_refl", "spec_trans")}
    q["distr"] = p["distr"]
    out = _sample_roughdielectric_f(q, tuple(c.double() for c in wi), u1.double(),
                                    tuple(c.double() for c in u2))
    return {"wo": tuple(c.to(dt) for c in out["wo"]), "pdf": out["pdf"].to(dt),
            "weight": out["weight"].to(dt), "eta": out["eta"].to(dt), "valid": out["valid"]}


def _sample_roughdielectric_f(p, wi, u1, u2):
    cti = frame.cos_theta(wi)
    # the reference samples the scaled-alpha distribution
    # (roughdielectric.cpp:69-76); the polar sampler ignores wi
    s = 1.2 - 0.2 * m.sqrt(torch.abs(cti))
    mv, pdf = microfacet.sample_ggx(u2, p["alpha_u"] * s, p["alpha_v"] * s)
    F, cos_theta_t, eta_it, eta_ti = fresnel.fresnel(vec.dot(wi, mv), p["eta"])
    selected_r = u1 <= F
    pdf = pdf * torch.where(selected_r, F, 1.0 - F)
    eta = torch.where(selected_r, 1.0, eta_it)
    wo = vec.where(selected_r, fresnel.reflect_m(wi, mv),
                   fresnel.refract_m(wi, mv, cos_theta_t, eta_ti))

    factor = torch.where(selected_r, 1.0, eta_ti * eta_ti)  # radiance mode
    dwo = vec.dot(wo, mv)
    dwh_dwo = torch.where(
        selected_r,
        1.0 / torch.clamp(4.0 * torch.abs(dwo), min=_TINY),
        eta * eta * torch.abs(dwo) / torch.clamp(m.sqr(vec.dot(wi, mv) + eta * dwo), min=_TINY),
    )
    Gv = microfacet.G(wi, wo, mv, p["alpha_u"], p["alpha_v"], p["distr"])
    denom = cti * frame.cos_theta(mv)
    weight_s = Gv * vec.dot(wi, mv) / torch.where(torch.abs(denom) < _TINY, _TINY, denom)
    weight = (factor[None, :] * torch.where(selected_r[None, :], p["spec_refl"], p["spec_trans"])
              * weight_s[None, :])
    pdf = pdf * torch.abs(dwh_dwo)
    valid = (pdf > 0.0) & (torch.abs(cti) > 0.0)
    return {"wo": wo, "pdf": torch.where(valid, pdf, 0.0),
            "weight": torch.where(valid[None, :], torch.clamp(weight, min=0.0), 0.0),
            "eta": eta, "valid": valid}


def _sample_dielectric(p, wi, u1):
    """Smooth dielectric (dielectric.cpp): delta reflect / refract."""
    F, cos_theta_t, eta_it, eta_ti = fresnel.fresnel(frame.cos_theta(wi), p["eta"])
    selected_r = u1 <= F
    pdf = torch.where(selected_r, F, 1.0 - F)
    wo = vec.where(selected_r, fresnel.reflect(wi), fresnel.refract(wi, cos_theta_t, eta_ti))
    factor = torch.where(selected_r, 1.0, eta_ti * eta_ti)  # radiance mode
    weight = torch.where(selected_r[None, :], p["spec_refl"], p["spec_trans"]) * factor[None, :]
    valid = pdf > 0.0
    return {"wo": wo, "pdf": pdf, "weight": torch.where(valid[None, :], weight, 0.0),
            "eta": torch.where(selected_r, 1.0, eta_it), "valid": valid}


# ---------------------------------------------------------------------------
# roughplastic
# ---------------------------------------------------------------------------

def _plastic_prob_specular(p, cti):
    """Lobe-selection probability (roughplastic.cpp:47-54): the
    Fresnel-weighted specular sampling weight, renormalized."""
    t_i = 1.0 - fresnel.fresnel(cti, p["eta"])[0]
    ps = (1.0 - t_i) * p["ssw"]
    pd = t_i * (1.0 - p["ssw"])
    return ps / torch.clamp(ps + pd, min=_TINY)


def _eval_plastic(p, wi, wo):
    """roughplastic.cpp:80-118: microfacet specular plus the internally
    scattered diffuse with Fresnel transmittances and (non)linear
    compensation."""
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    ok = (cti > 0.0) & (cto > 0.0)
    H = _half(wi, wo)
    D = microfacet.eval_ggx(H, p["alpha_u"], p["alpha_v"])
    F = fresnel.fresnel(vec.dot(wi, H), p["eta"])[0]
    Gv = microfacet.G(wi, wo, H, p["alpha_u"], p["alpha_v"], p["distr"])
    spec = (F * D * Gv / (4.0 * torch.clamp(cti, min=_TINY)))[None, :] * p["spec_refl"]

    t_i = 1.0 - fresnel.fresnel(cti, p["eta"])[0]
    t_o = 1.0 - fresnel.fresnel(cto, p["eta"])[0]
    fdr = p["fdr"][None, :]
    diff0 = p["reflectance"]
    denom = 1.0 - torch.where(p["nonlinear"][None, :], diff0 * fdr, fdr)
    inv_eta2 = 1.0 / torch.clamp(p["eta"] * p["eta"], min=_TINY)
    diff = (diff0 / torch.clamp(denom, min=_TINY)) * (m.InvPi * inv_eta2 * cto * t_i * t_o)[None, :]
    return torch.where(ok[None, :], spec + diff, 0.0)


def _pdf_plastic(p, wi, wo):
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    ok = (cti > 0.0) & (cto > 0.0)
    ps = _plastic_prob_specular(p, cti)
    H = _half(wi, wo)
    pdf_s = microfacet.pdf_ggx(H, p["alpha_u"], p["alpha_v"]) / (
        4.0 * torch.clamp(vec.dot(wo, H), min=_TINY))
    pdf = ps * pdf_s + (1.0 - ps) * warp.square_to_cosine_hemisphere_pdf(wo)
    return torch.where(ok, pdf, 0.0)


def _sample_plastic(p, wi, u1, u2):
    """roughplastic.cpp:37-78: pick the specular or diffuse lobe by the
    Fresnel-weighted probability; weight = eval / the combined pdf."""
    cti = frame.cos_theta(wi)
    ps = _plastic_prob_specular(p, cti)
    mv, _ = microfacet.sample_ggx(u2, p["alpha_u"], p["alpha_v"])
    wo = vec.where(u1 < ps, fresnel.reflect_m(wi, mv), warp.square_to_cosine_hemisphere(u2))
    pdf = _pdf_plastic(p, wi, wo)
    valid = (cti > 0.0) & (pdf > 0.0)
    weight = _eval_plastic(p, wi, wo) / torch.clamp(pdf, min=_TINY)[None, :]
    return {"wo": wo, "pdf": torch.where(valid, pdf, 0.0),
            "weight": torch.where(valid[None, :], weight, 0.0),
            "eta": torch.ones_like(pdf), "valid": valid}


# ---------------------------------------------------------------------------
# Disney principled BRDF (bsdfs/disney_brdf.cpp:1-263)
#
# The reference file cannot compile (it calls microfacet helpers that do not
# exist in its tree), swaps t and v1 in its Color3 lerp for c_spec and uses
# 0.8 where Burley uses 0.08, and gives the clearcoat pdf another alpha than
# its D. Like misaki_tpu, this is the canonical 2012 model the file intends:
# Burley diffuse with retro-reflection and the flat subsurface lerp, GTR2
# anisotropic specular with Schlick Fresnel, sheen, and the GTR1 clearcoat
# with a fixed 0.25 Smith alpha; lobe choice by the reference's mixture
# ((1 - metallic) / 2 diffuse, then 1 / (1 + clearcoat) specular against
# clearcoat). The RGB tint generalizes to base / CIE-Y luminance.
# ---------------------------------------------------------------------------

def _schlick_weight(c):
    x = torch.clamp(1.0 - c, 0.0, 1.0)
    x2 = x * x
    return x2 * x2 * x


def _gtr1(cos_h, a):
    """Berry / GTR1 NDF, the long-tailed clearcoat distribution."""
    a = torch.clamp(a, 1e-3, 0.999)
    a2 = a * a
    d = (a2 - 1.0) / (m.Pi * torch.log(a2) * (1.0 + (a2 - 1.0) * cos_h * cos_h))
    return torch.where(cos_h > 0.0, d, 0.0)


def _sample_gtr1(u2, a):
    a = torch.clamp(a, 1e-3, 0.999)
    a2 = a * a
    cos_h2 = (1.0 - torch.pow(a2, 1.0 - u2[0])) / (1.0 - a2)
    cos_h = m.safe_sqrt(cos_h2)
    sin_h = m.safe_sqrt(1.0 - cos_h2)
    phi = 2.0 * m.Pi * u2[1]
    return (sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h)


def _disney_alphas(p):
    ds = p["disney"]
    rough = p["alpha_u"]  # roughness rides in the alpha slot (see the compiler)
    aspect = m.safe_sqrt(1.0 - 0.9 * ds["aniso"])
    ax = torch.clamp(rough * rough / torch.clamp(aspect, min=1e-3), min=1e-3)
    ay = torch.clamp(rough * rough * aspect, min=1e-3)
    a_cc = 0.1 + (0.001 - 0.1) * ds["cc_gloss"]  # lerp(0.1, 0.001, gloss)
    return ax, ay, a_cc


def _eval_disney(p, wi, wo):
    ds = p["disney"]
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    ok = (cti > 0.0) & (cto > 0.0)
    h = _half(wi, wo)
    cos_d = vec.dot(wo, h)
    ax, ay, a_cc = _disney_alphas(p)
    rough = p["alpha_u"]

    fl = _schlick_weight(cti)
    fv = _schlick_weight(cto)
    fd90 = 0.5 + 2.0 * cos_d * cos_d * rough
    f_d = m.lerp(1.0, fd90, fl) * m.lerp(1.0, fd90, fv)
    fss90 = cos_d * cos_d * rough
    f_ss_w = m.lerp(1.0, fss90, fl) * m.lerp(1.0, fss90, fv)
    f_ss = 1.25 * (f_ss_w * (1.0 / torch.clamp(cti + cto, min=1e-6) - 0.5) + 0.5)

    fd_mix = m.lerp(f_d, f_ss, ds["subsurface"])[None, :]
    f_sheen = p["ds_sheen"] * _schlick_weight(cos_d)[None, :]
    f_diffuse = (m.InvPi * fd_mix * p["reflectance"] + f_sheen) * (1.0 - ds["metallic"])[None, :]

    d_s = microfacet.eval_ggx(h, ax, ay)
    g_s = microfacet.G(wi, wo, h, ax, ay)
    f_s = p["ds_spec0"] + (1.0 - p["ds_spec0"]) * _schlick_weight(cos_d)[None, :]
    f_specular = f_s * (d_s * g_s / torch.clamp(4.0 * cti * cto, min=1e-6))[None, :]

    d_c = _gtr1(frame.cos_theta(h), a_cc)
    f_c = 0.04 + 0.96 * _schlick_weight(cos_d)
    g_c = microfacet.smith_g1(wi, h, 0.25, 0.25) * microfacet.smith_g1(wo, h, 0.25, 0.25)
    f_clearcoat = (0.25 * ds["clearcoat"] * d_c * f_c * g_c
                   / torch.clamp(4.0 * cti * cto, min=1e-6))[None, :]

    f = (f_diffuse + f_specular + f_clearcoat) * cto[None, :]
    return torch.where(ok[None, :], f, 0.0)


def _pdf_disney(p, wi, wo):
    ds = p["disney"]
    cti = frame.cos_theta(wi)
    cto = frame.cos_theta(wo)
    h = _half(wi, wo)
    cos_d = torch.clamp(torch.abs(vec.dot(wo, h)), min=1e-6)
    ax, ay, a_cc = _disney_alphas(p)
    prob_d = (1.0 - ds["metallic"]) * 0.5
    prob_s = 1.0 / (1.0 + ds["clearcoat"])
    pdf_d = warp.square_to_cosine_hemisphere_pdf(wo)
    pdf_s = microfacet.pdf_ggx(h, ax, ay) / (4.0 * cos_d)
    pdf_c = _gtr1(frame.cos_theta(h), a_cc) * frame.cos_theta(h) / (4.0 * cos_d)
    pdf = prob_d * pdf_d + (1.0 - prob_d) * (prob_s * pdf_s + (1.0 - prob_s) * pdf_c)
    ok = (cti > 0.0) & (cto > 0.0) & (vec.dot(wi, h) > 0.0)
    return torch.where(ok, pdf, 0.0)


def _sample_disney(p, wi, u1, u2):
    """Mixture sample (disney_brdf.cpp:51-69): all three candidate
    directions, one picked per lane, weight = eval / the mixture's pdf."""
    ds = p["disney"]
    ax, ay, a_cc = _disney_alphas(p)
    prob_d = (1.0 - ds["metallic"]) * 0.5
    prob_s = 1.0 / (1.0 + ds["clearcoat"])

    wo_d = warp.square_to_cosine_hemisphere(u2)
    h_s, _ = microfacet.sample_ggx(u2, ax, ay)
    wo_s = vec.sub(vec.scale(h_s, 2.0 * vec.dot(wi, h_s)), wi)
    h_c = _sample_gtr1(u2, a_cc)
    wo_c = vec.sub(vec.scale(h_c, 2.0 * vec.dot(wi, h_c)), wi)

    take_d = u1 < prob_d
    u1r = (u1 - prob_d) / torch.clamp(1.0 - prob_d, min=1e-6)
    take_s = ~take_d & (u1r < prob_s)
    wo = vec.where(take_d, wo_d, vec.where(take_s, wo_s, wo_c))

    pdf = _pdf_disney(p, wi, wo)
    valid = (frame.cos_theta(wi) > 0.0) & (frame.cos_theta(wo) > 0.0) & (pdf > 1e-8)
    weight = _eval_disney(p, wi, wo) / torch.clamp(pdf, min=1e-8)[None, :]
    return {"wo": wo, "pdf": torch.where(valid, pdf, 0.0),
            "weight": torch.where(valid[None, :], weight, 0.0),
            "eta": torch.ones_like(pdf), "valid": valid}


# ---------------------------------------------------------------------------
# dispatch over the scene's kinds, and the mask wrapper
# ---------------------------------------------------------------------------

_EVAL = ((BSDF_DIFFUSE, _eval_diffuse), (BSDF_ROUGH_CONDUCTOR, _eval_roughconductor),
         (BSDF_ROUGH_DIELECTRIC, _eval_roughdielectric), (BSDF_PLASTIC, _eval_plastic),
         (BSDF_DISNEY, _eval_disney))
_PDF = ((BSDF_DIFFUSE, _pdf_diffuse), (BSDF_ROUGH_CONDUCTOR, _pdf_roughconductor),
        (BSDF_ROUGH_DIELECTRIC, _pdf_roughdielectric), (BSDF_PLASTIC, _pdf_plastic),
        (BSDF_DISNEY, _pdf_disney))
_SAMPLE = (
    (BSDF_DIFFUSE, lambda p, wi, u1, u2: _sample_diffuse(p, wi, u2)),
    (BSDF_ROUGH_CONDUCTOR, lambda p, wi, u1, u2: _sample_roughconductor(p, wi, u2)),
    (BSDF_ROUGH_DIELECTRIC, _sample_roughdielectric),
    (BSDF_DIELECTRIC, lambda p, wi, u1, u2: _sample_dielectric(p, wi, u1)),
    (BSDF_CONDUCTOR, lambda p, wi, u1, u2: _sample_conductor(p, wi)),
    (BSDF_NULL, lambda p, wi, u1, u2: _sample_null(p, wi)),
    (BSDF_PLASTIC, _sample_plastic),
    (BSDF_DISNEY, _sample_disney),
)


def _mask_op_prob(p):
    """The mask's lobe-selection probability: the clamped mean opacity, the
    one value that sample_bsdf selects with and pdf_bsdf reports."""
    return torch.clamp(torch.mean(p["opacity"], dim=0), 1e-4, 1.0)


def _count_kinds(lanes, n_kinds):
    """The tracing counters of one call over `lanes` lanes that computes
    `n_kinds` kinds on every lane."""
    tracing.add(tracing.BSDF_LANES, lanes)
    tracing.add(tracing.BSDF_KIND_LANES, lanes * n_kinds)


def eval_bsdf(p, wi, wo):
    """f * cos_theta_o per lane (4, L); delta kinds give 0 (bsdf.h). p: the
    bounce's `material_params`."""
    flip = p["twosided"] & (frame.cos_theta(wi) < 0.0)
    wi = _flip_z(wi, flip)
    wo = _flip_z(wo, flip)
    out = torch.zeros_like(p["reflectance"])
    evals = [(kval, fn) for kval, fn in _EVAL if kval in p["kinds"]]
    _count_kinds(out.shape[1], len(evals))
    for kval, fn in evals:
        out = torch.where((p["kind"] == kval)[None, :], fn(p, wi, wo), out)
    if p["mask"] is not None:
        # mask.cpp eval: the nested eval times the opacity
        out = torch.where(p["mask"][None, :], out * p["opacity"], out)
    return out


def pdf_bsdf(p, wi, wo):
    flip = p["twosided"] & (frame.cos_theta(wi) < 0.0)
    wi = _flip_z(wi, flip)
    wo = _flip_z(wo, flip)
    out = torch.zeros_like(frame.cos_theta(wi))
    pdfs = [(kval, fn) for kval, fn in _PDF if kval in p["kinds"]]
    _count_kinds(out.shape[0], len(pdfs))
    for kval, fn in pdfs:
        out = torch.where(p["kind"] == kval, fn(p, wi, wo), out)
    if p["mask"] is not None:
        # mask.cpp pdf: the nested pdf times the same clamped selection
        # probability that sample_bsdf uses, so MIS sees one value
        out = torch.where(p["mask"], out * _mask_op_prob(p), out)
    return out


def sample_bsdf(p, wi, u1, u2):
    """Importance-sample the per-lane BSDF. Returns SoA dict with keys
    wo (vec3), pdf (L,), weight (4, L) = f cos / pdf, eta, delta, null,
    valid. `u1` picks the lobe, `u2` the direction."""
    flip = p["twosided"] & (frame.cos_theta(wi) < 0.0)
    wi_f = _flip_z(wi, flip)
    kind = p["kind"]

    # the mask wrapper (mask.cpp:28-70) picks its lobe by opacity; lanes on
    # the nested lobe reuse u1 rescaled, and the null lobe is made after
    # the nested select below
    mask = p["mask"]
    if mask is not None:
        op_prob = _mask_op_prob(p)
        choose_null = mask & (u1 >= op_prob)
        u1 = torch.where(mask, torch.clamp(u1 / op_prob, max=1.0 - 1e-7), u1)

    # diff_mode's detached-sampling estimator (misaki_tpu/bsdf/kernels.py:
    # 767-773): directions and pdfs come from detached alpha; the rough
    # lobes' weight is recomputed below
    p_s = dict(p, alpha_u=p["alpha_u"].detach(), alpha_v=p["alpha_v"].detach()) \
        if p["diff"] else p
    # the compiler's kinds always hold at least one model
    cases = [(kv, fn(p_s, wi_f, u1, u2)) for kv, fn in _SAMPLE if kv in p["kinds"]]
    _count_kinds(kind.shape[0], len(cases))

    def select(field, out, expand=False):
        for kval, r in cases:
            sel = kind == kval
            out = torch.where(sel[None, :] if expand else sel, r[field], out)
        return out

    weight = select("weight", torch.zeros_like(cases[0][1]["weight"]), expand=True)
    pdf = select("pdf", torch.zeros_like(cases[0][1]["pdf"]))
    valid = select("valid", torch.zeros_like(kind, dtype=torch.bool))
    eta = select("eta", torch.ones_like(cases[0][1]["eta"]))
    wo = cases[0][1]["wo"]
    for kval, r in cases[1:]:
        wo = vec.where(kind == kval, r["wo"], wo)
    wo = _flip_z(wo, flip)

    delta = (kind == BSDF_DIELECTRIC) | (kind == BSDF_CONDUCTOR) | (kind == BSDF_NULL)
    null = kind == BSDF_NULL
    if p["diff"]:
        # the attached weight at the detached sample for the rough lobes,
        # f_attached(wo_detached) / pdf_detached (misaki_tpu/bsdf/kernels.py:
        # 818-832); delta lobes keep their closed forms. The mask wrapper is
        # stripped for the recompute: eval_bsdf multiplies mask lanes by the
        # opacity, which the mask branch below applies once more
        wo_det = tuple(c.detach() for c in wo)
        pdf_det = pdf.detach()
        f_att = eval_bsdf(dict(p, mask=None) if mask is not None else p, wi, wo_det)
        w_att = f_att / torch.clamp(pdf_det, min=_TINY)[None, :]
        rough = (kind == BSDF_ROUGH_CONDUCTOR) | (kind == BSDF_ROUGH_DIELECTRIC)
        weight = torch.where((rough & (pdf_det > 0.0))[None, :], w_att, weight)
    if mask is not None:
        # the null lobe, and the nested lobe reweighted by opacity / prob.
        # The reference's nested branch omits the 1 / prob (mask.cpp:44-47),
        # which under-weights partly opaque surfaces; this is the unbiased
        # estimator, the convention of its own null branch (mask.cpp:49-57).
        wo = vec.where(choose_null, vec.neg(wi), wo)
        w_nested = weight * (p["opacity"] / op_prob[None, :])
        w_null = (1.0 - p["opacity"]) / torch.clamp(1.0 - op_prob, min=1e-6)[None, :]
        weight = torch.where(mask[None, :], torch.where(choose_null[None, :], w_null, w_nested),
                             weight)
        pdf = torch.where(mask, torch.where(choose_null, 1.0 - op_prob, pdf * op_prob), pdf)
        valid = valid | choose_null
        delta = delta | choose_null
        null = null | choose_null
    return {"wo": wo, "pdf": pdf, "weight": weight, "eta": eta, "delta": delta,
            "null": null, "valid": valid}
