"""Photonmapper frames, written plainly over `sppm.py`: Mitsuba's
`photonmapper` integrator over diffuse surfaces differs from its `sppm` in
three places, and in nothing else (the streams, the photon paths, the grid
and the film are `sppm.py`'s):

- the camera pass takes no light sample: a pixel's first hit adds only the
  light it sees, and a pixel draws its jitter alone;
- the photons are gathered at every vertex, the first included (direct
  light comes from the photons), and a photon counts where the direction it
  came from lies on the visible point's side of its normal (wi . n > 0);
- the radius stays the first iteration's, so the frame is the iterations'
  mean of the light seen plus tau / (N pi r^2) with tau the summed flux.

The configuration's photonmapper XML is read as `scene.py` reads an sppm
one: the same sensor, shapes and light, its `photon_count` as the photons.
"""

import io
import math
import xml.etree.ElementTree as ET

import torch

from benchmark.reference import path as pt
from benchmark.reference import pcg32
from benchmark.reference import scene as sc
from benchmark.reference import sppm


def load(path, width=None, height=None, device="cpu"):
    """The scene of the photonmapper XML `path`."""
    root = ET.parse(path).getroot()
    integ = root.find("integrator")
    if integ is None or integ.get("type") != "photonmapper":
        raise ValueError("the reference reads a photonmapper integrator here")
    integ.set("type", "sppm")
    for node in integ:
        if node.get("name") == "photon_count":
            node.set("name", "photons")
    return sc.load(io.StringIO(ET.tostring(root, encoding="unicode")), width=width,
                   height=height, device=device)


def camera_pass(scene, it, seed, lam, le):
    """-> (the light each pixel sees directly (L, 4), its visible point:
    {p, n, valid, rho (the reflectance (L, 4))})."""
    W, H = scene.width, scene.height
    lane = torch.arange(W * H, dtype=torch.int64, device=scene.device)
    st = pcg32.iteration_stream(lane, 0x9E3779B9, it, 0, 0x85EBCA6B, seed)
    (jx, jy), _ = pcg32.next_2d(st)
    x = (lane % W).to(torch.float32) + jx
    y = (lane // W).to(torch.float32) + jy
    o, d, mint, maxt = pt.camera_rays(scene, x, y)
    hit = pt.Hit(scene, o, d, *pt.closest_hit(scene, o, d, mint, maxt))
    front = hit.wi_z > 0.0
    value = torch.where((hit.emits & front)[:, None], le, 0.0)
    rho = pt.sigmoid_spectrum(scene.leaves["materials"][scene.shape[hit.face]], lam)
    return value, {"p": hit.p, "n": hit.n, "valid": hit.valid & front, "rho": rho}


def gather(grid, vp, r2, ph_p, ph_wi, ph_n, ph_flux, ph_ok):
    """`sppm.gather` with the photonmapper's hemisphere test: the photon's
    wi against the visible point's normal. sppm's tests the photon's normal
    against the visible point's wi, and its own test of the photons (wi . n
    > 0) is symmetric, so the roles are swapped on both sides."""
    return sppm.gather(grid, {"p": vp["p"], "wi": vp["n"], "valid": vp["valid"]}, r2, ph_p,
                       ph_n, ph_wi, ph_flux, ph_ok)


def photon_pass(scene, it, seed, lam, le, vp, r2, grid, budget):
    """-> (flux sum (L, 4), count (L,)) of every visible point over the
    `budget` vertices of this iteration's photons, the first included."""
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
        grid = sppm.Grid(lo - h, h, int(math.ceil(float((hi - lo).max()) / h)) + 2)
        value = torch.zeros((L, 3), device=dev)
        tau = torch.zeros((L, 3), device=dev)
        radius = torch.full((L,), r0, dtype=torch.float32, device=dev)
        r2 = radius * radius
        for it in range(scene.iterations):
            lam, lam_w = pt.sample_wavelengths(pcg32.iteration_wavelength_sample(it, seed, dev))
            le = pt.light_radiance(scene.leaves, lam)
            direct, vp = camera_pass(scene, it, seed, lam.expand(L, 4), le.expand(L, 4))
            phi, _ = photon_pass(scene, it, seed, lam, le, vp, r2, grid, budget)
            value = value + pt.to_xyz(direct * lam_w, lam.expand(L, 4))
            tau = tau + pt.to_xyz(vp["rho"] / math.pi * phi * lam_w, lam.expand(L, 4))
        photons = float(scene.iterations) * float(scene.photons)
        xyz = value / scene.iterations + tau / (photons * math.pi * r2)[:, None]
        return torch.clamp(pt.develop(xyz.reshape(H, W, 3)), min=0.0)
