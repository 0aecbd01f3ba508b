"""Photon frames, written plainly: stochastic progressive photon mapping
(Hachisuka and Jensen 2009; Mitsuba's `sppm` integrator) over diffuse
surfaces.

Each iteration draws one set of hero wavelengths for the whole frame. A
camera pass sends one jittered ray a pixel; its first hit adds the light it
sees directly and one light sample (no MIS), and on a surface seen from its
front parks the pixel's visible point there. (A diffuse vertex seen from
behind scatters nothing, so in a scene of diffuse surfaces every camera
path ends at its first hit.) A photon pass emits `photons` photons from the
light (a point uniform in area, a cosine-distributed direction, flux
L pi A), follows each through its bounces with Russian roulette on the
flux's ratio, and gathers the photons of every bounce after the first
(direct light is the camera's light sample) within each visible point's
radius, on the visible point's side. The radius then shrinks by the
progressive rule with alpha 2/3, and the frame is the iterations' mean of
the direct light plus tau / (N pi r^2).

Photon i of iteration k draws from `pcg32.iteration_stream(i, 0x6C078965,
k, 0x400000, 0xB5297A4D, seed)`: the emitter pick (1), the point (2), the
direction (2), then each bounce the lobe (1, unused), the direction (2) and
the roulette (1). Pixel j draws from `iteration_stream(j, 0x9E3779B9, k, 0,
0x85EBCA6B, seed)`: the jitter (2), then the light sample (2).

The gather bins the photons into a uniform grid of cells no smaller than
the first radius and tests each visible point against the photons of the
27 cells about its own.
"""

import math

import torch

from benchmark.reference import pcg32
from benchmark.reference import path as pt

GAMMA = 2.0 / 3.0


def camera_pass(scene, it, seed, lam, le):
    """-> (the light each pixel sees directly (L, 4), its visible point:
    {p, wi (toward the camera), valid, rho (the reflectance (L, 4))})."""
    W, H = scene.width, scene.height
    lane = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    st = pcg32.iteration_stream(lane, 0x9E3779B9, it, 0, 0x85EBCA6B, seed)
    (jx, jy), st = pcg32.next_2d(st)
    (ul1, ul2), st = pcg32.next_2d(st)
    x = (lane % W).to(torch.float32) + jx
    y = (lane // W).to(torch.float32) + jy
    o, d, mint, maxt = pt.camera_rays(scene, x, y)
    hit = pt.Hit(scene, o, d, *pt.closest_hit(scene, o, d, mint, maxt))
    front = hit.wi_z > 0.0
    value = torch.where((hit.emits & front)[:, None], le, 0.0)

    rho = pt.sigmoid_spectrum(scene.leaves["materials"][scene.shape[hit.face]], lam)
    wl, dist, pdf_l = pt.sample_light(scene, hit.p, ul1, ul2)
    try_l = hit.valid & (pdf_l > 0.0)
    blocked = pt.occluded(scene, hit.p, wl, torch.where(try_l, hit.spawn_mint(), 0.0),
                          torch.where(try_l, dist * (1.0 - pt.SHADOW_EPS), -1.0))
    cos_o = pt.dot(wl, hit.n)
    f = torch.where((front & (cos_o > 0.0))[:, None], rho * (cos_o / math.pi)[:, None], 0.0)
    value = value + torch.where((try_l & ~blocked)[:, None],
                                le / torch.clamp(pdf_l, min=1e-20)[:, None] * f, 0.0)
    return value, {"p": hit.p, "wi": -d, "valid": hit.valid & front, "rho": rho}


class Grid:
    """Photons binned by cell: cells of side `h` over the box lo .. lo + n h
    (n per axis); a point outside falls into the nearest border cell."""

    def __init__(self, lo, h, n):
        self.lo, self.h, self.n = lo, h, n

    def cell3(self, p):
        return torch.clamp(torch.floor((p - self.lo) / self.h), 0, self.n - 1).to(torch.int64)

    def key(self, c):
        return (c[:, 2] * self.n + c[:, 1]) * self.n + c[:, 0]


def gather(grid, vp, r2, ph_p, ph_wi, ph_n, ph_flux, ph_ok):
    """Each visible point's sum of the flux (L, 4) and count (L,) of the
    photons within its radius (|p - q|^2 < r^2) whose surface faces its
    camera direction (n_photon . wi_vp > 0), of the photons alive and
    arriving on their surface's front (wi . n > 0)."""
    L = r2.shape[0]
    dev = r2.device
    ok = ph_ok & (pt.dot(ph_wi, ph_n) > 0.0)
    idx = torch.nonzero(ok).squeeze(1)
    key = grid.key(grid.cell3(ph_p[idx]))
    key, order = torch.sort(key)
    idx = idx[order]
    n_cells = grid.n ** 3
    start = torch.searchsorted(key, torch.arange(n_cells + 1, device=dev))

    vis = torch.nonzero(vp["valid"]).squeeze(1)
    c = grid.cell3(vp["p"][vis])
    phi = torch.zeros((L, 4), device=dev)
    count = torch.zeros(L, device=dev)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cc = c + torch.tensor([dx, dy, dz], device=dev)
                inside = ((cc >= 0) & (cc < grid.n)).all(1)
                k = grid.key(torch.clamp(cc, 0, grid.n - 1))
                a = torch.where(inside, start[k], 0)
                b = torch.where(inside, start[k + 1], 0)
                m = b - a
                owner = torch.repeat_interleave(torch.arange(vis.shape[0], device=dev), m)
                first = torch.cumsum(m, 0) - m
                j = idx[a[owner] + torch.arange(owner.shape[0], device=dev) - first[owner]]
                i = vis[owner]
                v = ph_p[j] - vp["p"][i]
                d2 = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
                hit = (d2 < r2[i]) & (pt.dot(ph_n[j], vp["wi"][i]) > 0.0)
                phi.index_add_(0, i[hit], ph_flux[j[hit]])
                count.index_add_(0, i[hit], torch.ones(int(hit.sum()), device=dev))
    return phi, count


def photon_pass(scene, it, seed, lam, le, vp, r2, grid, budget):
    """-> (flux sum (L, 4), count (L,)) of every visible point over the
    `budget` vertices of this iteration's photons."""
    P = scene.photons
    dev = scene.device
    lane = torch.arange(P, dtype=torch.int64, device=dev)
    st = pcg32.iteration_stream(lane, 0x6C078965, it, 0x400000, 0xB5297A4D, seed)
    _, st = pcg32.next_float32(st)                   # the emitter pick: one light
    (up1, up2), st = pcg32.next_2d(st)
    (ud1, ud2), st = pcg32.next_2d(st)
    lam = lam.expand(P, 4)
    le = le.expand(P, 4)
    o, f0 = pt.light_point(scene, up1, up2)
    n0 = scene.n[f0]
    s0, t0 = pt.onb(n0)
    v = pt.cosine_direction(ud1, ud2)
    d = s0 * v[:, 0:1] + t0 * v[:, 1:2] + n0 * v[:, 2:3]
    flux = le * (math.pi * scene.light_area)
    mint = pt.RAY_EPS * (1.0 + o.abs().amax(-1))
    hit = pt.Hit(scene, o, d, *pt.closest_hit(scene, o, d, mint, torch.full_like(mint, torch.inf)))
    alive = hit.valid
    phi = torch.zeros((r2.shape[0], 4), device=dev)
    count = torch.zeros(r2.shape[0], device=dev)
    for depth in range(budget):
        if depth >= 1:
            dphi, dcount = gather(grid, vp, r2, hit.p, -d, hit.n, flux, alive)
            phi, count = phi + dphi, count + dcount
        if depth == budget - 1:
            break
        _, st = pcg32.next_float32(st)
        (ub1, ub2), st = pcg32.next_2d(st)
        u_rr, st = pcg32.next_float32(st)
        refl = pt.sigmoid_spectrum(scene.leaves["materials"][scene.shape[hit.face]], lam)
        wo = pt.cosine_direction(ub1, ub2)
        ok = (hit.wi_z > 0.0) & (wo[:, 2] > 0.0)
        alive = alive & ok
        scattered = flux * refl
        q = torch.clamp(scattered.amax(-1) / torch.clamp(flux.amax(-1), min=1e-20), max=0.95)
        alive = alive & (u_rr < q)
        flux = torch.where(alive[:, None], scattered / torch.clamp(q, min=1e-8)[:, None], flux)
        d = hit.world(wo)
        t, f = pt.closest_hit(scene, hit.p, d, torch.where(alive, hit.spawn_mint(), 0.0),
                              torch.where(alive, torch.inf, -1.0))
        hit = pt.Hit(scene, hit.p, d, t, f)
        alive = alive & hit.valid
    return phi, count


def render(scene, seed, depth_cap):
    """The frame with `seed`, a photon path's vertices capped at `depth_cap`
    + 1: (H, W, 3) linear sRGB, negatives clipped."""
    W, H = scene.width, scene.height
    L = W * H
    dev = scene.device
    budget = max(min(scene.max_depth, depth_cap + 1), 1)
    r0 = 0.025 * max(scene.bsphere_radius, 1e-3)
    with torch.no_grad():
        lo = torch.cat([scene.p0, scene.p0 + scene.e1, scene.p0 + scene.e2]).amin(0)
        hi = torch.cat([scene.p0, scene.p0 + scene.e1, scene.p0 + scene.e2]).amax(0)
        h = r0 * (1.0 + 1e-3)
        grid = Grid(lo - h, h, int(math.ceil(float((hi - lo).max()) / h)) + 2)
        value = torch.zeros((L, 3), device=dev)
        tau = torch.zeros((L, 3), device=dev)
        n = torch.zeros(L, device=dev)
        radius = torch.full((L,), r0, dtype=torch.float32, device=dev)
        for it in range(scene.iterations):
            lam, lam_w = pt.sample_wavelengths(pcg32.iteration_wavelength_sample(it, seed, dev))
            le = pt.light_radiance(scene.leaves, lam)
            direct, vp = camera_pass(scene, it, seed, lam.expand(L, 4), le.expand(L, 4))
            r2 = radius * radius
            phi, count = photon_pass(scene, it, seed, lam, le, vp, r2, grid, budget)
            value = value + pt.to_xyz(direct * lam_w, lam.expand(L, 4))
            phi_xyz = pt.to_xyz(vp["rho"] / math.pi * phi * lam_w, lam.expand(L, 4))
            has = count > 0.0
            n_new = n + GAMMA * count
            r_new = torch.where(has, radius * torch.sqrt(n_new / torch.clamp(n + count, min=1e-8)),
                                radius)
            ratio = torch.where(has, r_new * r_new / torch.clamp(r2, min=1e-20), 1.0)
            tau = (tau + phi_xyz) * ratio[:, None]
            n = torch.where(has, n_new, n)
            radius = r_new
        photons = float(scene.iterations) * float(scene.photons)
        xyz = value / scene.iterations + tau / (photons * math.pi * radius * radius)[:, None]
        return torch.clamp(pt.develop(xyz.reshape(H, W, 3)), min=0.0)
