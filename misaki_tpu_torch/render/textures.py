"""Texture-slot evaluation on packed material columns
(reference: src/librender/spectra/{uniform,srgb}.cpp,
textures/checkerboard.cpp; see scene/types.py for the slot layout).

A spectral slot holds two sigmoid-coefficient triples (A, and the
checkerboard's second colour B) plus a 2x3 UV transform; `uniform` values
are degenerate sigmoids. Slot mode 0 is a plain colour, 1 a checkerboard;
bitmap slots (mode 2) are not in this port yet.
"""

import torch

SLOT_CHECKER = 1.0


def _sigmoid_spectrum(c0, c1, c2, wavelengths):
    """srgb.h:8-19 sigmoid model; c* are (L,), wavelengths (4, L)."""
    v = (c0[None, :] * wavelengths + c1[None, :]) * wavelengths + c2[None, :]
    return torch.clamp(0.5 * v / torch.sqrt(v * v + 1.0) + 0.5, min=0.0)


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


def eval_spectral_slot(slot, uv, wavelengths):
    """slot: (13, L) rows [mode, cA(3), cB(3), uvT(6)] -> (4, L).

    mode 0: plain sigmoid spectrum A; mode 1: checkerboard A/B."""
    is_checker = torch.abs(slot[0] - SLOT_CHECKER) < 0.25
    pick_a = torch.where(is_checker, _checker_pick(slot, uv), True)
    c0 = torch.where(pick_a, slot[1], slot[4])
    c1 = torch.where(pick_a, slot[2], slot[5])
    c2 = torch.where(pick_a, slot[3], slot[6])
    return _sigmoid_spectrum(c0, c1, c2, wavelengths)
