"""Wavefront emitter evaluation: NEE direct sampling, pdf, and radiance
(reference: src/librender/emitters/{area,constant}.cpp and the uniform
emitter selection in scene.cpp:68-112).

Radiance spectra are (sigmoid coeff x 95-bin curve) models; per-emitter work
is unrolled over `scene.emitter_kinds` with lane masks, as in
`misaki_tpu.emitter.kernels`. This port carries area and constant emitters;
a scene with another kind raises NotImplementedError naming it.
"""

import torch

from misaki_tpu_torch.core import frame, table, vec, warp
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.core.cie_data import CIE_MAX, CIE_MIN
from misaki_tpu_torch.scene.types import (
    EF_CDF_HI,
    EF_CDF_LO,
    EF_E1,
    EF_E2,
    EF_HAS_N,
    EF_N0,
    EF_NG,
    EF_P0,
    EM_AREA,
    EM_CONSTANT,
    EMITTER_NAMES,
)


def _sigmoid(coeff, wavelengths):
    v = (coeff[0] * wavelengths + coeff[1]) * wavelengths + coeff[2]
    return torch.clamp(0.5 * v / torch.sqrt(v * v + 1.0) + 0.5, min=0.0)


def radiance(scene, ei, wavelengths, rad=None):
    """Emitter radiance spectrum for a static emitter index: L(lambda) =
    hat(curve)(lambda) * sigmoid(coeff)(lambda). Returns (4, L). `rad` is
    an optional `radiance_all` cache."""
    if rad is not None:
        return rad[ei]
    t = (wavelengths - CIE_MIN) * (94.0 / (CIE_MAX - CIE_MIN))
    base = table.hat_eval(scene.emitters.rad_curve[ei], t)
    return base * _sigmoid(scene.emitters.rad_coeff[ei], wavelengths)


def radiance_all(scene, wavelengths):
    """Per-chunk radiance cache: one (4, L) spectrum per emitter (the
    spectrum depends only on the chunk's wavelengths)."""
    n = scene.n_emitters
    if n == 0:
        return None
    t = (wavelengths - CIE_MIN) * (94.0 / (CIE_MAX - CIE_MIN))
    bases = table.hat_eval_multi([scene.emitters.rad_curve[ei] for ei in range(n)], t)
    return [bases[ei] * _sigmoid(scene.emitters.rad_coeff[ei], wavelengths)
            for ei in range(n)]


def eval_emitter(scene, emitter_ids, wi_local, uv, wavelengths, rad=None):
    """Emitter::eval at a surface hit — area lights emit on the front side
    only (area.cpp:51-54). Lanes with emitter_ids < 0 return 0. -> (4, L)."""
    L = wavelengths.shape[-1]
    out = torch.zeros((4, L), dtype=torch.float32, device=wavelengths.device)
    front = frame.cos_theta(wi_local) > 0.0
    for ei in range(scene.n_emitters):
        if scene.emitter_kinds[ei] != EM_AREA:
            continue
        mask = (emitter_ids == ei) & front
        out = torch.where(mask[None, :], radiance(scene, ei, wavelengths, rad), out)
    return out


def eval_environment(scene, d, wavelengths, rad=None):
    """Environment radiance along escaped direction d (constant.cpp eval)."""
    if not scene.has_environment:
        return torch.zeros(wavelengths.shape, dtype=torch.float32, device=wavelengths.device)
    kind = scene.emitter_kinds[scene.environment_idx]
    if kind != EM_CONSTANT:
        raise NotImplementedError(f"emitter '{EMITTER_NAMES.get(kind, kind)}'")
    return radiance(scene, scene.environment_idx, wavelengths, rad)


def _sample_area_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Area-light direct sampling: area-uniform position on the emissive
    shape (mesh.cpp:103-133) converted to solid angle (shape.cpp:66-80),
    one-sided (area.cpp:38-45)."""
    em = scene.emitters
    cdf = em.face_cdf[ei]     # (Fmax,)

    # face pick by area CDF with sample reuse (distribution.h sample_reuse)
    uy = u2[1]
    fmax = cdf.shape[0]
    below = uy[None, :] > cdf[:, None]                      # (Fmax, L)
    idx = torch.clamp(below.to(torch.int32).sum(dim=0), 0, fmax - 1)
    fd = em.face_pack[ei][:, idx]                           # (EF_COLS, L)
    lo, hi = fd[EF_CDF_LO], fd[EF_CDF_HI]
    uy = torch.clamp((uy - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0 - 1e-7)

    b1, b2 = warp.square_to_uniform_triangle((u2[0], uy))
    b0 = 1.0 - b1 - b2

    p0 = (fd[EF_P0], fd[EF_P0 + 1], fd[EF_P0 + 2])
    e1 = (fd[EF_E1], fd[EF_E1 + 1], fd[EF_E1 + 2])
    e2 = (fd[EF_E2], fd[EF_E2 + 1], fd[EF_E2 + 2])
    p = vec.add(p0, vec.add(vec.scale(e1, b1), vec.scale(e2, b2)))
    ng = (fd[EF_NG], fd[EF_NG + 1], fd[EF_NG + 2])
    n0 = (fd[EF_N0], fd[EF_N0 + 1], fd[EF_N0 + 2])
    n1 = (fd[EF_N0 + 3], fd[EF_N0 + 4], fd[EF_N0 + 5])
    n2 = (fd[EF_N0 + 6], fd[EF_N0 + 7], fd[EF_N0 + 8])
    ns = vec.normalize(
        vec.add(vec.scale(n0, b0), vec.add(vec.scale(n1, b1), vec.scale(n2, b2)))
    )
    n = vec.where(fd[EF_HAS_N] > 0.5, ns, ng)

    d = vec.sub(p, ref_p)
    dist2 = vec.norm2(d)
    dist = torch.sqrt(dist2)
    d = vec.scale(d, 1.0 / torch.clamp(dist, min=1e-20))

    pdf_area = 1.0 / torch.clamp(em.area[ei], min=1e-20)
    dn = vec.dot(d, n)
    dp = torch.abs(dn)
    pdf = torch.where(dp != 0.0, pdf_area * dist2 / torch.clamp(dp, min=1e-20), 0.0)

    # one-sided emission: only where d . n < 0 (area.cpp:38)
    pdf = torch.where(dn < 0.0, pdf, 0.0)
    rad_s = radiance(scene, ei, wavelengths, rad)
    spec = torch.where((pdf > 0.0)[None, :],
                       rad_s / torch.clamp(pdf, min=1e-20)[None, :], 0.0)
    return {"d": d, "dist": dist, "pdf": pdf, "spec": spec}


def _sample_constant_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Uniform-sphere env sampling (constant.cpp:53-74)."""
    em = scene.emitters
    d = warp.square_to_uniform_sphere(u2)
    dist = torch.ones_like(d[0]) * (2.0 * em.bsphere_radius)
    pdf = warp.square_to_uniform_sphere_pdf(d)
    rad_s = radiance(scene, ei, wavelengths, rad)
    return {"d": d, "dist": dist, "pdf": pdf, "spec": rad_s / pdf[None, :]}


_SAMPLERS = {EM_AREA: _sample_area_emitter, EM_CONSTANT: _sample_constant_emitter}


def sample_emitter_direct(scene, ref_p, wavelengths, u2, rad=None):
    """Scene::sample_emitter_direct (scene.cpp:68-103) minus the visibility
    test (the integrator casts the batched shadow ray).

    Uniform emitter pick with sample reuse; returns SoA dict
    {d (vec3), dist, pdf, spec (4, L), delta} — spec = radiance/pdf times
    the selection count; pdf includes the selection pdf."""
    n = scene.n_emitters
    L = ref_p[0].shape[0]
    dev = ref_p[0].device
    for k in scene.emitter_kinds:
        if k not in _SAMPLERS:
            raise NotImplementedError(f"emitter '{EMITTER_NAMES.get(k, k)}'")
    if n == 0:
        z = torch.zeros(L, device=dev)
        return {
            "d": (z, z, z),
            "dist": z,
            "pdf": z,
            "spec": torch.zeros((4, L), device=dev),
            "delta": torch.zeros(L, dtype=torch.bool, device=dev),
        }

    ux = u2[0]
    if n == 1:
        index = torch.zeros(L, dtype=torch.int32, device=dev)
        ux_r = ux
    else:
        index = torch.clamp((ux * n).to(torch.int32), max=n - 1)
        ux_r = (ux - index.to(torch.float32) / n) * n
    u2r = (ux_r, u2[1])

    out = None
    for ei in range(n):
        r = _SAMPLERS[scene.emitter_kinds[ei]](scene, ei, ref_p, wavelengths, u2r, rad)
        mask = index == ei
        if out is None:
            out = r
        else:
            out = {
                "d": vec.where(mask, r["d"], out["d"]),
                "dist": torch.where(mask, r["dist"], out["dist"]),
                "pdf": torch.where(mask, r["pdf"], out["pdf"]),
                "spec": torch.where(mask[None, :], r["spec"], out["spec"]),
            }
    if n > 1:
        out["pdf"] = out["pdf"] * (1.0 / n)
        out["spec"] = out["spec"] * n
    # no delta (point) emitters in this port's set of kinds
    out["delta"] = torch.zeros(L, dtype=torch.bool, device=dev)
    return out


def pdf_emitter_direct(scene, emitter_ids, d, dist, n_at_hit):
    """Scene::pdf_emitter_direct (scene.cpp:105-112) for MIS when a BSDF ray
    hits an emitter. Area: (1/area) * dist^2/|d.n| (shape.cpp:82-88);
    constant env: uniform-sphere pdf."""
    pdf = torch.zeros_like(dist)
    dp = torch.abs(vec.dot(d, n_at_hit))
    for ei in range(scene.n_emitters):
        kind = scene.emitter_kinds[ei]
        mask = emitter_ids == ei
        if kind == EM_AREA:
            p_area = torch.where(
                dp != 0.0,
                (1.0 / torch.clamp(scene.emitters.area[ei], min=1e-20))
                * dist * dist / torch.clamp(dp, min=1e-20),
                0.0,
            )
            pdf = torch.where(mask, p_area, pdf)
        elif kind == EM_CONSTANT:
            pdf = torch.where(mask, m.InvFourPi, pdf)
        else:
            raise NotImplementedError(f"emitter '{EMITTER_NAMES.get(kind, kind)}'")
    if scene.n_emitters > 1:
        pdf = pdf / scene.n_emitters
    return torch.where(emitter_ids >= 0, pdf, 0.0)
