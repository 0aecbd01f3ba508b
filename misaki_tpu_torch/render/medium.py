"""Participating media: homogeneous free-flight sampling, analytic and
marched transmittance, grid densities and the Henyey-Greenstein phase
function (reference: media/homogeneous.cpp:21-55, phase/isotropic.cpp:12-27,
scene.cpp:114-184 eval_transmittance; misaki_tpu/render/medium.py).

As in misaki_tpu, sigma_s and sigma_a are sigmoid spectra at the four hero
wavelengths times an amplitude, the distance-sampling channel is one of the
four wavelengths, and pdfs are spectral means. Each lane carries an int32
medium id (-1 = vacuum).

Differences from misaki_tpu: the medium parameters are an indexed load of
the (few) media's rows, not a one-hot matmul, and a grid density is a
float32 trilinear of eight indexed loads into `scene.volumes`, where
misaki_tpu fetches bfloat16-rounded texels (`table.fetch_lowp`). On a grid
whose values bfloat16 holds exactly the two agree.
"""

import torch

from misaki_tpu_torch.core import frame, vec
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.render.textures import _sigmoid_spectrum

_TINY = 1e-20
INV_4PI = 1.0 / (4.0 * m.Pi)

HETERO_STEPS = 32  # fixed-step march resolution of a grid medium


def spectral_mean(x):
    """(4, L) -> (L,): the mean over the four wavelengths, summed in
    order as jnp.mean sums them on the CPU."""
    return (((x[0] + x[1]) + x[2]) + x[3]) / 4.0


def _channel(x, channel):
    """(4, L) -> (L,): each lane's hero-wavelength `channel` row."""
    return torch.gather(x, 0, channel.to(torch.int64)[None, :])[0]


def fetch_medium(scene, med_ids, wavelengths):
    """Per-lane spectral medium parameters for int32 medium ids (-1 =
    vacuum). Returns {sigma_s (4, L), sigma_t (4, L), g (L,), vacuum (L,)};
    vacuum lanes get sigma 0 and g 0."""
    med = scene.media
    L = med_ids.shape[0]
    dev = wavelengths.device
    vacuum = med_ids < 0
    if med.kind.shape[0] == 0:
        z = torch.zeros((4, L), device=dev)
        return {"sigma_s": z, "sigma_t": z, "g": torch.zeros(L, device=dev), "vacuum": vacuum}
    ids = torch.clamp(med_ids, min=0).to(torch.int64)

    def sig_eval(coeff, amp):
        c = coeff[ids]                                           # (L, 3)
        spec = _sigmoid_spectrum(c[:, 0], c[:, 1], c[:, 2], wavelengths)
        return torch.where(vacuum[None, :], 0.0, spec * (amp * med.scale)[ids][None, :])

    sigma_s = sig_eval(med.sigma_s_coeff, med.sigma_s_amp)
    sigma_a = sig_eval(med.sigma_a_coeff, med.sigma_a_amp)
    return {
        "sigma_s": sigma_s,
        "sigma_t": sigma_s + sigma_a,
        "g": torch.where(vacuum, 0.0, med.g[ids]),
        "vacuum": vacuum,
    }


# ---------------------------------------------------------------------------
# spatially varying density (volume.h Volume::eval, gridvolume)
# ---------------------------------------------------------------------------

def fetch_density_vol(scene, med_ids):
    """Per-lane density-volume index (-1 = constant density 1)."""
    med = scene.media
    if med.kind.shape[0] == 0:
        return torch.full_like(med_ids, -1)
    v = med.density_vol[torch.clamp(med_ids, min=0).to(torch.int64)]
    return torch.where(med_ids >= 0, v.to(med_ids.dtype), -1)


def _to_unit(m12, p, point=True):
    """The static world -> unit-cube 3x4 applied to a point or a direction."""
    rows = [m12[4 * r] * p[0] + m12[4 * r + 1] * p[1] + m12[4 * r + 2] * p[2]
            for r in range(3)]
    return tuple(r + m12[4 * k + 3] for k, r in enumerate(rows)) if point else tuple(rows)


def grid_density(scene, vol_ids, p):
    """Cell-centred trilinear density of each lane's volume at world point
    p, clamped at the grid's border (volume.h Volume::eval generalised from
    constant3d to grids); 0 outside the volume's box, 1 where vol_ids is -1.
    Eight indexed loads into `scene.volumes` per volume, in float32."""
    L = p[0].shape[0]
    out = torch.ones(L, device=p[0].device)
    for vi, (off, W, H, D, m12) in enumerate(scene.volume_meta):
        x, y, z = _to_unit(m12, p)
        inside = ((x >= 0.0) & (x <= 1.0) & (y >= 0.0) & (y <= 1.0)
                  & (z >= 0.0) & (z <= 1.0))
        sel = vol_ids == vi
        fx = torch.clamp(x * W - 0.5, 0.0, W - 1.0)
        fy = torch.clamp(y * H - 0.5, 0.0, H - 1.0)
        fz = torch.clamp(z * D - 0.5, 0.0, D - 1.0)
        x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
        tx, ty, tz = fx - x0, fy - y0, fz - z0
        x0i, y0i, z0i = x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)
        x1i = torch.clamp(x0i + 1, max=W - 1)
        y1i = torch.clamp(y0i + 1, max=H - 1)
        z1i = torch.clamp(z0i + 1, max=D - 1)
        acc = torch.zeros(L, device=p[0].device)
        # misaki_tpu's order of the taps and of each weight's product
        for zi, wz in ((z0i, 1.0 - tz), (z1i, tz)):
            for yi, wy in ((y0i, 1.0 - ty), (y1i, ty)):
                for xi, wx in ((x0i, 1.0 - tx), (x1i, tx)):
                    idx = torch.where(sel, off + (zi * H + yi) * W + xi, 0)
                    # index_select, whose backward is an index_add_
                    acc = acc + torch.index_select(scene.volumes, 0, idx) * (wx * wy * wz)
        out = torch.where(sel, torch.where(inside, acc, 0.0), out)
    return out


def _march_optical_depth(scene, mp, vol_ids, o, d, t_lo, t_hi, channel, u1):
    """Fixed-step (HETERO_STEPS) piecewise-constant march along o + t d over
    [t_lo, t_hi]: accumulates the spectral optical depth and inverts the
    channel's at -log(1 - u1). Returns (t_scatter, found, tau at the
    scatter (4, L), tau over the span (4, L), sigma at the scatter
    (4, L))."""
    L = u1.shape[0]
    dev = u1.device
    span = torch.clamp(t_hi - t_lo, min=0.0)
    dt = span / HETERO_STEPS
    target = -torch.log1p(-torch.clamp(u1, max=1.0 - 1e-7))
    onehot = (torch.arange(4, device=dev)[:, None] == channel[None, :]).to(torch.float32)

    tau_c = torch.zeros(L, device=dev)
    tau_s = torch.zeros((4, L), device=dev)
    found = torch.zeros(L, dtype=torch.bool, device=dev)
    t_sc = torch.full((L,), torch.inf, device=dev)
    tau_at = torch.zeros((4, L), device=dev)
    sig_at = torch.zeros((4, L), device=dev)
    for i in range(HETERO_STEPS):
        t_mid = t_lo + (i + 0.5) * dt
        rho = grid_density(scene, vol_ids, vec.add(o, vec.scale(d, t_mid)))
        sig_spec = mp["sigma_t"] * rho[None, :]
        sig_c = torch.sum(sig_spec * onehot, dim=0)
        step_tau = sig_c * dt
        cross = ~found & (tau_c + step_tau >= target) & (sig_c > 0.0)
        frac = torch.where(cross, (target - tau_c) / torch.clamp(sig_c, min=_TINY), 0.0)
        t_new = t_lo + i * dt + torch.minimum(torch.clamp(frac, min=0.0), dt)
        t_sc = torch.where(cross, t_new, t_sc)
        tau_at = torch.where(cross[None, :], tau_s + sig_spec * frac[None, :], tau_at)
        sig_at = torch.where(cross[None, :], sig_spec, sig_at)
        tau_c = tau_c + step_tau
        tau_s = tau_s + sig_spec * dt
        found = found | cross
    return t_sc, found, tau_at, tau_s, sig_at


def _grid_span(scene, vol_ids, o, d, tmax):
    """[t_lo, t_hi]: where the lane's grid volume can have density, the
    slab interval of the unit cube in volume space clipped to [0, tmax]."""
    L = tmax.shape[0]
    far = torch.clamp(tmax, max=3e38)
    t_lo = torch.zeros(L, device=tmax.device)
    t_hi = far
    for vi, (_off, _W, _H, _D, m12) in enumerate(scene.volume_meta):
        sel = vol_ids == vi
        ol = _to_unit(m12, o)
        dl = _to_unit(m12, d, point=False)
        tn = torch.zeros(L, device=tmax.device)
        tf = far
        for k in range(3):
            safe = torch.where(torch.abs(dl[k]) < 1e-20,
                               torch.where(dl[k] < 0, -1e-20, 1e-20), dl[k])
            inv = 1.0 / safe
            t0 = (0.0 - ol[k]) * inv
            t1 = (1.0 - ol[k]) * inv
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        t_lo = torch.where(sel, torch.minimum(tn, tf), t_lo)
        t_hi = torch.where(sel, tf, t_hi)
    return t_lo, torch.maximum(t_hi, t_lo)


def eval_transmittance(mp, dist):
    """exp(-sigma_t * dist) (homogeneous.cpp:52-55). dist (L,) -> (4, L)."""
    return torch.exp(-mp["sigma_t"] * torch.clamp(dist, min=0.0)[None, :])


def transmittance_ray(scene, mp, med_ids, o, d, dist):
    """Spectral transmittance along a ray segment: grid lanes march
    (fixed-step quadrature), the others take the closed form
    (Scene::eval_transmittance, scene.cpp:160-166)."""
    homog = eval_transmittance(mp, dist)
    if not scene.volume_meta:
        return homog
    vol_ids = fetch_density_vol(scene, med_ids)
    t_lo, t_hi = _grid_span(scene, vol_ids, o, d, dist)
    _, _, _, tau_total, _ = _march_optical_depth(
        scene, mp, vol_ids, o, d, t_lo, t_hi, torch.zeros_like(vol_ids), torch.zeros_like(dist))
    return torch.where((vol_ids >= 0)[None, :], torch.exp(-tau_total), homog)


def sample_distance(mp, channel, u1, tmax, scene=None, o=None, d=None, med_ids=None):
    """HomogeneousMedium::sample_distance (homogeneous.cpp:21-50).

    mp: fetch_medium's dict; channel (L,) the hero-wavelength index in
    [0, 4); u1 (L,) uniform; tmax (L,) the distance to the surface hit.
    Given `scene`, `o`, `d` and `med_ids` on a scene with grid volumes, the
    lanes whose medium has a density grid invert the marched optical depth
    instead (the reference has no heterogeneous sampling).

    Returns {scatter (L,) bool: the flight ends before the surface; t (L,)
    the sampled distance; pdf (L,) the spectral-mean pdf of what happened
    (a density on scatter, the survival probability otherwise); tr (4, L)
    the transmittance over the travelled segment; rho (L,) the relative
    density at the scatter point (1 on homogeneous lanes)}."""
    sigma_c = _channel(mp["sigma_t"], channel)
    # -log(1 - u) / sigma; vacuum (sigma == 0) -> inf
    dist = -torch.log1p(-torch.clamp(u1, max=1.0 - 1e-7)) / torch.clamp(sigma_c, min=_TINY)
    dist = torch.where(sigma_c > 0.0, dist, torch.inf)
    scatter = dist < tmax
    traveled = torch.where(scatter, dist, torch.clamp(tmax, max=3e38))
    tr = torch.exp(-mp["sigma_t"] * traveled[None, :])
    pdf = torch.where(scatter, spectral_mean(tr * mp["sigma_t"]), spectral_mean(tr))
    # tr.maxCoeff() < 1e-20 -> 0 (homogeneous.cpp:45-46)
    tr = torch.where((tr.amax(dim=0) < 1e-20)[None, :], 0.0, tr)
    out = {"scatter": scatter, "t": dist, "pdf": pdf, "tr": tr, "rho": torch.ones_like(pdf)}
    if scene is None or o is None or not scene.volume_meta:
        return out

    vol_ids = fetch_density_vol(scene, med_ids)
    grid_lane = vol_ids >= 0
    t_lo, t_hi = _grid_span(scene, vol_ids, o, d, tmax)
    t_sc, found, tau_at, tau_total, sig_at = _march_optical_depth(
        scene, mp, vol_ids, o, d, t_lo, t_hi, channel, u1)
    h_scatter = found & (t_sc < tmax)
    tr_h = torch.where(h_scatter[None, :], torch.exp(-tau_at), torch.exp(-tau_total))
    pdf_h = torch.where(h_scatter, spectral_mean(sig_at * torch.exp(-tau_at)),
                        spectral_mean(torch.exp(-tau_total)))
    # sig_at == sigma_t * rho(x): the hero channel recovers rho
    rho_h = _channel(sig_at, channel) / torch.clamp(sigma_c, min=_TINY)
    return {
        "scatter": torch.where(grid_lane, h_scatter, scatter),
        "t": torch.where(grid_lane, t_sc, dist),
        "pdf": torch.where(grid_lane, pdf_h, pdf),
        "tr": torch.where(grid_lane[None, :], tr_h, tr),
        "rho": torch.where(grid_lane & h_scatter, rho_h, out["rho"]),
    }


# ---------------------------------------------------------------------------
# phase function (Henyey-Greenstein; g = 0 is the reference's isotropic)
# ---------------------------------------------------------------------------

def hg_pdf(cos_theta, g):
    """HG density over solid angle, cos_theta between the direction of
    travel and the scattered direction (mean cosine g); g == 0 -> 1/4pi."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(denom * m.sqrt(denom), min=_TINY)


def phase_eval(wi_world, wo_world, g):
    """PhaseFunction::eval: the density of scattering from the direction of
    travel `wi_world` into `wo_world` (isotropic.cpp:24-27 at g == 0)."""
    return hg_pdf(vec.dot(wi_world, wo_world), g)


def phase_sample(wi_world, g, u2):
    """PhaseFunction::sample -> (wo (vec3), pdf (L,), weight (L,)); the
    weight is 1 (perfect importance sampling, isotropic.cpp:15-22 at
    g == 0)."""
    small = torch.abs(g) < 1e-4
    safe_g = torch.where(small, 1e-4, g)
    sqr_term = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u2[0])
    cos_hg = (1.0 + safe_g * safe_g - sqr_term * sqr_term) / (2.0 * safe_g)
    cos_theta = torch.clamp(torch.where(small, 1.0 - 2.0 * u2[0], cos_hg), -1.0, 1.0)
    sin_theta = m.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = m.TwoPi * u2[1]
    fr = frame.make_frame(wi_world)
    local = (sin_theta * m.cos(phi), sin_theta * m.sin(phi), cos_theta)
    wo = frame.to_world(fr, local)
    pdf = hg_pdf(cos_theta, g)
    return wo, pdf, torch.ones_like(pdf)
