"""Texture-slot evaluation on packed material columns
(reference: src/librender/spectra/{uniform,srgb}.cpp,
textures/{checkerboard,bitmap}.cpp; see scene/types.py for the slot layout).

A spectral slot holds two sigmoid-coefficient triples (A, and the
checkerboard's second colour B) plus a 2x3 UV transform; `uniform` values
are degenerate sigmoids. Slot mode 0 is a plain colour, 1 a checkerboard,
2 a bitmap: slot[1] holds the texture id, and the texels come bilinearly
from the scene's mip-chained bitmap table through the texel-fetch kernel
(render/texel_fetch.py), at the level the primary-ray UV footprint selects.
"""

import torch

from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.render.texel_fetch import fetch4

SLOT_CHECKER = 1.0
SLOT_BITMAP = 2.0


def _sigmoid_spectrum(c0, c1, c2, wavelengths):
    """srgb.h:8-19 sigmoid model; c* are (L,), wavelengths (4, L)."""
    v = (c0[None, :] * wavelengths + c1[None, :]) * wavelengths + c2[None, :]
    return torch.clamp(0.5 * v / m.sqrt(v * v + 1.0) + 0.5, min=0.0)


def _slot_uv(slot, uv):
    """Apply the slot's baked 2x3 to_uv transform."""
    uu, vv = uv
    u = slot[-6] * uu + slot[-5] * vv + slot[-4]
    v = slot[-3] * uu + slot[-2] * vv + slot[-1]
    return u, v


def _checker_pick(slot, uv):
    """checkerboard.cpp: to_uv transform, (u>.5 == v>.5) picks color0/A."""
    u, v = _slot_uv(slot, uv)
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    return (u > 0.5) == (v > 0.5)


def bitmap_fetch_rgb(scene, tex_id, u, v, duv=None):
    """Bilinear fetch of bitmap `tex_id` at (u, v) through the texel-fetch
    kernel. Returns (r, g, b) tuples of (L,)."""
    out = fetch4(scene.bitmaps, *bitmap_taps(scene, tex_id, u, v, duv))
    return (out[0], out[1], out[2])


def bitmap_taps(scene, tex_id, u, v, duv=None):
    """The four bilinear taps (idx4 (4, L) int32 into `scene.bitmaps`,
    w4 (4, L) float32) of bitmap `tex_id` at (u, v), both wrapped like the
    reference's uv - floor(uv) (bitmap.cpp:31-32), at the mip level the
    screen-space footprint `duv` selects (level 0 without it). The
    arithmetic is misaki_tpu's `bitmap_fetch_rgb`; each lane's level
    geometry is looked up in the scene's `bitmap_levels` instead of unrolled
    over the levels."""
    W0, H0, levels = scene.bitmap_meta[tex_id]
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    n_lv = len(levels)
    if duv is None:
        lvl = torch.zeros_like(u)
    else:
        (dudx, dvdx), (dudy, dvdy) = duv
        # footprint in base-level texels; level = log2 (clamped)
        fp = torch.maximum(
            torch.maximum(torch.abs(dudx), torch.abs(dudy)) * W0,
            torch.maximum(torch.abs(dvdx), torch.abs(dvdy)) * H0,
        )
        lvl = torch.floor(torch.log2(torch.clamp(fp, min=1.0)))
        lvl = torch.clamp(lvl, 0.0, n_lv - 1.0)
    # a NaN footprint selects no level: all four taps dead, texel 0
    has_lvl = lvl >= 0.0
    li = torch.where(has_lvl, lvl, 0.0).to(torch.int64)
    geo = scene.bitmap_levels[tex_id][li]                              # (L, 3)
    off, W, H = geo[:, 0], geo[:, 1], geo[:, 2]
    fu = u * W.to(torch.float32) - 0.5
    fv = v * H.to(torch.float32) - 0.5
    j0 = torch.floor(fu)
    i0 = torch.floor(fv)
    tu = fu - j0
    tv = fv - i0
    j0i = j0.to(torch.int32)
    i0i = i0.to(torch.int32)
    j0w = torch.remainder(j0i, W)
    j1w = torch.remainder(j0i + 1, W)
    i0w = torch.remainder(i0i, H)
    i1w = torch.remainder(i0i + 1, H)
    idx4 = torch.stack([off + i0w * W + j0w, off + i0w * W + j1w,
                        off + i1w * W + j0w, off + i1w * W + j1w])
    w4 = torch.stack([(1.0 - tu) * (1.0 - tv), tu * (1.0 - tv),
                      (1.0 - tu) * tv, tu * tv])
    idx4 = torch.where(has_lvl[None, :], idx4, 0).to(torch.int32).contiguous()
    w4 = torch.where(has_lvl[None, :], w4, 0.0).contiguous()
    return idx4, w4


def _bitmap_masks(scene, slot):
    """(texture id, lanes whose slot is that bitmap) for every bitmap."""
    is_bitmap = torch.abs(slot[0] - SLOT_BITMAP) < 0.25
    for tid in range(len(scene.bitmap_meta)):
        yield tid, is_bitmap & (torch.abs(slot[1] - tid) < 0.25)


def eval_spectral_slot(slot, uv, wavelengths, scene=None, duv=None):
    """slot: (13, L) rows [mode, cA(3), cB(3), uvT(6)] -> (4, L).

    mode 0: plain sigmoid spectrum A; mode 1: checkerboard A/B; mode 2:
    bitmap, evaluated when `scene` is given: the texels are lifted to the
    hero wavelengths with the channel-anchor model (rgb_to_spectral). Every
    lane is fetched once per bitmap and the result masked, so the number of
    fetches does not depend on the data."""
    is_checker = torch.abs(slot[0] - SLOT_CHECKER) < 0.25
    pick_a = torch.where(is_checker, _checker_pick(slot, uv), True)
    c0 = torch.where(pick_a, slot[1], slot[4])
    c1 = torch.where(pick_a, slot[2], slot[5])
    c2 = torch.where(pick_a, slot[3], slot[6])
    out = _sigmoid_spectrum(c0, c1, c2, wavelengths)
    if scene is not None and scene.bitmap_meta:
        from misaki_tpu_torch.bsdf.kernels import rgb_to_spectral

        u, v = _slot_uv(slot, uv)
        for tid, mask in _bitmap_masks(scene, slot):
            rgb = bitmap_fetch_rgb(scene, tid, u, v, duv)
            spec = torch.clamp(rgb_to_spectral(rgb, wavelengths), min=0.0)
            out = torch.where(mask[None, :], spec, out)
    return out


def eval_scalar_slot(slot, uv, scene=None, duv=None):
    """slot: (9, L) rows [mode, vA, vB, uvT(6)] -> (L,). Bitmap mode, when
    `scene` is given, uses the texel luminance (bitmap.cpp eval_1)."""
    is_checker = torch.abs(slot[0] - SLOT_CHECKER) < 0.25
    pick_a = torch.where(is_checker, _checker_pick(slot, uv), True)
    out = torch.where(pick_a, slot[1], slot[2])
    if scene is not None and scene.bitmap_meta:
        u, v = _slot_uv(slot, uv)
        for tid, mask in _bitmap_masks(scene, slot):
            r, g, b = bitmap_fetch_rgb(scene, tid, u, v, duv)
            lum = r * 0.212671 + g * 0.715160 + b * 0.072169
            out = torch.where(mask, lum, out)
    return out
