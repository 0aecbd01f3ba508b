"""Wavefront emitter evaluation: NEE direct sampling, pdf, and radiance
(reference: src/librender/emitters/{area,constant,envmap,point}.cpp and the
uniform emitter selection in scene.cpp:68-112).

Radiance spectra are (sigmoid coeff x 95-bin curve) models; per-emitter work
is unrolled over `scene.emitter_kinds` with lane masks, as in
`misaki_tpu.emitter.kernels`. The envmap is a lat-long RGB table, fetched
bilinearly through the texel-fetch kernel (render/texel_fetch.py) and
importance-sampled by its 2D luminance CDF with exact per-lane binary
searches. A point light is a delta position light: NEE takes its
contribution unweighted by MIS, and no BSDF ray ever hits it.
"""

import torch

from misaki_tpu_torch.core import frame, table, vec, warp
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.core.cie_data import CIE_MAX, CIE_MIN
from misaki_tpu_torch.render.texel_fetch import fetch4
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
    EM_ENVMAP,
    EM_POINT,
)


def _sigmoid(coeff, wavelengths):
    v = (coeff[0] * wavelengths + coeff[1]) * wavelengths + coeff[2]
    return torch.clamp(0.5 * v / m.sqrt(v * v + 1.0) + 0.5, min=0.0)


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


# ---------------------------------------------------------------------------
# environment map (emitters/envmap.cpp: lat-long HDR with 2D luminance-CDF
# importance sampling and the sin(theta) Jacobian)
# ---------------------------------------------------------------------------

def _env_dir_to_uv(scene, d):
    """World direction -> lat-long (u, v) in the emitter's local frame,
    y up (envmap.cpp:65-67, 76-78): u = atan2(x, -z) / 2pi wrapped to
    [0, 1), v = acos(y) / pi. Returns (u, v, sin_theta)."""
    R = scene.emitters.env_to_local
    x = R[0, 0] * d[0] + R[0, 1] * d[1] + R[0, 2] * d[2]
    y = R[1, 0] * d[0] + R[1, 1] * d[1] + R[1, 2] * d[2]
    z = R[2, 0] * d[0] + R[2, 1] * d[1] + R[2, 2] * d[2]
    u = torch.atan2(x, -z) * m.InvTwoPi
    u = u - torch.floor(u)
    y = torch.clamp(y, -1.0, 1.0)
    v = torch.acos(y) * m.InvPi
    sin_t = m.sqrt(torch.clamp(1.0 - y * y, min=0.0))
    return u, v, sin_t


def _env_uv_to_dir(scene, u, v):
    """Inverse of _env_dir_to_uv (envmap.cpp:43-47): phi = 2pi u,
    local d = (sin phi sin theta, cos theta, -cos phi sin theta).
    Returns (world direction, sin_theta)."""
    theta = v * m.Pi
    phi = u * m.TwoPi
    st = torch.sin(theta)
    local = (st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi))
    R = scene.emitters.env_to_world
    d = (
        R[0, 0] * local[0] + R[0, 1] * local[1] + R[0, 2] * local[2],
        R[1, 0] * local[0] + R[1, 1] * local[1] + R[1, 2] * local[2],
        R[2, 0] * local[0] + R[2, 1] * local[1] + R[2, 2] * local[2],
    )
    return d, st


def _env_bilinear_rgb(scene, u, v):
    """Bilinear fetch of the (He, We, 3) map through the texel-fetch
    kernel. Returns (r, g, b) tuples of (L,)."""
    env = scene.emitters.env_rgb
    out = fetch4(env.reshape(-1, 3), *env_taps(scene, u, v))
    return (out[0], out[1], out[2])


def env_taps(scene, u, v):
    """The four bilinear taps (idx4 (4, L) int32 into the flat (He*We, 3)
    map, w4 (4, L) float32) at texel centres: u wraps, v clamps."""
    env = scene.emitters.env_rgb
    He, We = env.shape[0], env.shape[1]
    fu = u * We - 0.5
    fv = v * He - 0.5
    j0 = torch.floor(fu)
    i0 = torch.floor(fv)
    tu = fu - j0
    tv = fv - i0
    j0i = j0.to(torch.int32)
    i0i = i0.to(torch.int32)
    j0w = torch.remainder(j0i, We)
    j1w = torch.remainder(j0i + 1, We)
    i0c = torch.clamp(i0i, 0, He - 1)
    i1c = torch.clamp(i0i + 1, 0, He - 1)
    idx4 = torch.stack([i0c * We + j0w, i0c * We + j1w, i1c * We + j0w, i1c * We + j1w])
    w4 = torch.stack([(1.0 - tu) * (1.0 - tv), tu * (1.0 - tv), (1.0 - tu) * tv, tu * tv])
    return idx4.to(torch.int32).contiguous(), w4.contiguous()


def _env_radiance_spec(scene, d, wavelengths):
    """Envmap radiance along world direction d -> (4, L): RGB texels lifted
    to the hero wavelengths with the channel-anchor model."""
    from misaki_tpu_torch.bsdf.kernels import rgb_to_spectral

    u, v, _ = _env_dir_to_uv(scene, d)
    rgb = _env_bilinear_rgb(scene, u, v)
    return torch.clamp(rgb_to_spectral(rgb, wavelengths), min=0.0)


def _env_pdf_sa(scene, u, v, sin_t):
    """Solid-angle pdf of the 2D texel-CDF sampler at (u, v):
    p(omega) = pmf[i, j] * Hs * Ws / (2 pi^2 sin(theta))."""
    pmf = scene.emitters.env_pmf
    Hs, Ws = pmf.shape
    i = torch.clamp((v * Hs).to(torch.int64), 0, Hs - 1)
    j = torch.clamp((u * Ws).to(torch.int64), 0, Ws - 1)
    p = pmf.reshape(-1)[i * Ws + j]
    denom = 2.0 * m.Pi * m.Pi * torch.clamp(sin_t, min=1e-6)
    return p * (Hs * Ws) / denom


def _count_below(flat, base, n, x):
    """Per lane, the number of entries of the non-decreasing run
    flat[base : base + n] that are strictly below x: a binary search by
    gathers (lower bound), exact for ties and for x equal to an entry.
    Returns (count, the entry before it or 0, the entry at it or 1)."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, n)
    for _ in range(n.bit_length()):
        mid = (lo + hi) >> 1
        open_ = lo < hi
        below = open_ & (flat[base + torch.clamp(mid, max=n - 1)] < x)
        lo = torch.where(below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    under = torch.where(lo > 0, flat[base + torch.clamp(lo - 1, min=0)], 0.0)
    over = torch.where(lo < n, flat[base + torch.clamp(lo, max=n - 1)], 1.0)
    return lo, under, over


def _env_sample_dir(scene, u2):
    """2D CDF importance sampling of the lat-long map: row from the
    marginal CDF, column from the row's conditional CDF, the position inside
    the texel by sample reuse; pdf in solid angle with the sin(theta)
    Jacobian. Returns (d toward the environment, pdf, u, v).

    misaki_tpu counts the entries below u against whole (H, L) and (W, L)
    broadcasts; here each count is a binary search over the flat CDF, which
    gives the same numbers in O(log W) gathers per lane."""
    em = scene.emitters
    Hs, Ws = em.env_pmf.shape
    ux, uy = u2
    zero = torch.zeros(uy.shape, dtype=torch.int64, device=uy.device)

    # row: marginal CDF
    r, mlo, mhi = _count_below(em.env_marg_cdf, zero, Hs, uy)
    r = torch.clamp(r, max=Hs - 1)
    dv = torch.clamp((uy - mlo) / torch.clamp(mhi - mlo, min=1e-20), 0.0, 1.0 - 1e-6)

    # column: conditional CDF of row r
    c, clo, chi = _count_below(em.env_cond_cdf.reshape(-1), r * Ws, Ws, ux)
    c = torch.clamp(c, max=Ws - 1)
    du = torch.clamp((ux - clo) / torch.clamp(chi - clo, min=1e-20), 0.0, 1.0 - 1e-6)

    u = (c.to(torch.float32) + du) / Ws
    v = (r.to(torch.float32) + dv) / Hs
    d, sin_t = _env_uv_to_dir(scene, u, v)
    pdf = _env_pdf_sa(scene, u, v, sin_t)
    pdf = torch.where(sin_t > 1e-6, pdf, 0.0)
    return d, pdf, u, v


def _sample_envmap_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Direct sampling of the envmap by its 2D CDF (_env_sample_dir)."""
    from misaki_tpu_torch.bsdf.kernels import rgb_to_spectral

    em = scene.emitters
    d, pdf, u, v = _env_sample_dir(scene, u2)
    rgb = _env_bilinear_rgb(scene, u, v)
    rad_tex = torch.clamp(rgb_to_spectral(rgb, wavelengths), min=0.0)
    spec = torch.where((pdf > 0.0)[None, :],
                       rad_tex / torch.clamp(pdf, min=1e-20)[None, :], 0.0)
    dist = torch.ones_like(pdf) * (2.0 * em.bsphere_radius)
    return {"d": d, "dist": dist, "pdf": pdf, "spec": spec}


def eval_environment(scene, d, wavelengths, rad=None):
    """Environment radiance along escaped direction d (constant.cpp eval /
    the envmap's lat-long lookup)."""
    if not scene.has_environment:
        return torch.zeros(wavelengths.shape, dtype=torch.float32, device=wavelengths.device)
    if scene.emitter_kinds[scene.environment_idx] == EM_ENVMAP:
        return _env_radiance_spec(scene, d, wavelengths)
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
    dist = m.sqrt(dist2)
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


def _sample_point_emitter(scene, ei, ref_p, wavelengths, u2, rad=None):
    """Delta position light with 1/r^2 falloff (emitters/point.cpp); its
    radiance model holds the intensity."""
    d = vec.sub(vec.splat3(scene.emitters.position[ei], ref_p[0]), ref_p)
    dist2 = vec.norm2(d)
    dist = m.sqrt(dist2)
    d = vec.scale(d, 1.0 / torch.clamp(dist, min=1e-20))
    rad_s = radiance(scene, ei, wavelengths, rad)
    return {"d": d, "dist": dist, "pdf": torch.ones_like(dist),
            "spec": rad_s / torch.clamp(dist2, min=1e-20)[None, :]}


_SAMPLERS = {EM_AREA: _sample_area_emitter, EM_CONSTANT: _sample_constant_emitter,
             EM_POINT: _sample_point_emitter, EM_ENVMAP: _sample_envmap_emitter}


def sample_emitter_direct(scene, ref_p, wavelengths, u2, rad=None):
    """Scene::sample_emitter_direct (scene.cpp:68-103) minus the visibility
    test (the integrator casts the batched shadow ray).

    Uniform emitter pick with sample reuse; returns SoA dict
    {d (vec3), dist, pdf, spec (4, L), delta} — spec = radiance/pdf times
    the selection count; pdf includes the selection pdf."""
    n = scene.n_emitters
    L = ref_p[0].shape[0]
    dev = ref_p[0].device
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
    delta = torch.zeros(L, dtype=torch.bool, device=dev)
    for ei in range(n):
        r = _SAMPLERS[scene.emitter_kinds[ei]](scene, ei, ref_p, wavelengths, u2r, rad)
        mask = index == ei
        if scene.emitter_kinds[ei] == EM_POINT:
            delta = delta | mask
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
    out["delta"] = delta
    return out


def pdf_emitter_direct(scene, emitter_ids, d, dist, n_at_hit):
    """Scene::pdf_emitter_direct (scene.cpp:105-112) for MIS when a BSDF ray
    hits an emitter. Area: (1/area) * dist^2/|d.n| (shape.cpp:82-88);
    constant env: uniform-sphere pdf; envmap: the 2D-CDF sampler's pdf; a
    point light, which no ray hits, 0."""
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
        elif kind == EM_ENVMAP:
            u, v, sin_t = _env_dir_to_uv(scene, d)
            pdf = torch.where(mask & (sin_t > 1e-6), _env_pdf_sa(scene, u, v, sin_t), pdf)
    if scene.n_emitters > 1:
        pdf = pdf / scene.n_emitters
    return torch.where(emitter_ids >= 0, pdf, 0.0)
