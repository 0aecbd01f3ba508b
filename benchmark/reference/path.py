"""Path frames and their gradients, written plainly: a unidirectional path
tracer with next-event estimation, power-2 multiple importance sampling and
Russian roulette (Veach; Mitsuba's `path` integrator), spectral with four
hero wavelengths, casting every ray against every triangle.

A lane is one sample of one pixel, lane = pixel * spp + sample. It draws
from its own PCG32 stream (`pcg32.path_stream`) in this order: the pixel
jitter (2), the wavelength (1), the lens (2, unused by a pinhole); then each
bounce the light sample (2), the lobe (1, unused by a diffuse surface), the
direction (2) and the roulette (1), whether or not the path is still alive.
The image is the gaussian-filtered mean of the lanes' XYZ, developed to
linear sRGB.

Every matrix product goes through `precision.matmul`: the camera's rotation,
the casts' plane and barycentric rows, and the XYZ-to-sRGB matrix. Under
`precision.tf32()` they are TF32 products, which is the control.
"""

import math

import numpy as np
import torch

from benchmark.reference import cie, pcg32, precision

EPSILON = float(np.finfo(np.float32).eps) / 2.0
RAY_EPS = EPSILON * 1500.0          # a spawned ray starts this far, times (1 + max |p|)
SHADOW_EPS = RAY_EPS * 10.0         # a shadow ray stops this share short of the light
TINY = float(np.finfo(np.float32).tiny)

# CIE XYZ to linear sRGB (BT.709 primaries, D65 white)
XYZ_TO_SRGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------

def sample_wavelengths(u):
    """Four hero wavelengths from one uniform number a lane: u and its
    shifts by 1/4, 2/4, 3/4 (mod 1), each warped to the pdf proportional to
    sech^2(0.0072 (lambda - 538)) on the visible range. -> (wavelengths,
    1 / pdf), each (L, 4)."""
    v = u[:, None] + torch.arange(4, dtype=torch.float32, device=u.device) / 4.0
    v = torch.where(v <= 1.0, v, v - 1.0)
    lam = 538.0 - torch.atanh(0.8569106254698279 - 1.8275019724092267 * v) * 138.88888888888889
    c = torch.cosh(0.0072 * (lam - 538.0))
    return lam, 253.82 * c * c


def on_grid(table, lam):
    """The piecewise-linear curve `table` (..., 95) on the CIE grid, at the
    wavelengths `lam`, held at its ends; `table` (95,) or (L, 95)."""
    x = torch.clamp((lam - cie.CIE_MIN) * ((cie.CIE_SAMPLES - 1) / (cie.CIE_MAX - cie.CIE_MIN)),
                    0.0, cie.CIE_SAMPLES - 1.0)
    i = torch.floor(x)
    f = x - i
    i0 = i.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=cie.CIE_SAMPLES - 1)
    return table[i0] * (1.0 - f) + table[i1] * f


def sigmoid_spectrum(c, lam):
    """The sigmoid model at `lam` (L, 4) with coefficients c (L, 3) or (3,)."""
    c = c if c.dim() == 2 else c[None, :]
    v = (c[:, 0:1] * lam + c[:, 1:2]) * lam + c[:, 2:3]
    return torch.clamp(0.5 + 0.5 * v / torch.sqrt(v * v + 1.0), min=0.0)


def cmf(lam):
    """The CIE 1931 observer at `lam`: (X, Y, Z), each like lam."""
    return tuple(on_grid(torch.as_tensor(t, dtype=torch.float32, device=lam.device), lam)
                 for t in (cie.CIE1931_X, cie.CIE1931_Y, cie.CIE1931_Z))


def to_xyz(spec, lam):
    """A lane's spectral value at its hero wavelengths -> XYZ (L, 3): the
    mean over the four of value x observer."""
    return torch.stack([(c * spec).mean(-1) for c in cmf(lam)], -1)


def light_radiance(leaves, lam):
    """The area light's emitted spectrum at `lam` (L, 4)."""
    return on_grid(leaves["rad_curve"][0], lam) * sigmoid_spectrum(leaves["rad_coeff"][0], lam)


def develop(xyz):
    """XYZ (..., 3) to linear sRGB (..., 3)."""
    m = torch.tensor(XYZ_TO_SRGB, dtype=torch.float32, device=xyz.device)
    return precision.matmul(xyz.reshape(-1, 3), m.T).reshape(xyz.shape)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def camera_rays(scene, x, y):
    """Pinhole rays through raster positions (x, y) (L,) of the film, the
    horizontal field of view `fov`: -> (origin (L, 3), direction (L, 3),
    mint, maxt) with the near and far planes as the ray's interval."""
    W, H = scene.width, scene.height
    aspect = W / H
    d = torch.stack([(1.0 - 2.0 * x / W) * scene.tan_half,
                     (1.0 - 2.0 * y / H) * (scene.tan_half / aspect),
                     torch.ones_like(x)], -1)
    d = normalize(d)
    mint, maxt = scene.near / d[:, 2], scene.far / d[:, 2]
    d = precision.matmul(d, scene.cam_rot.T)
    return scene.cam_origin.expand_as(d), d, mint, maxt


def _cast(scene, o, d, mint, maxt):
    """Every ray against every triangle: -> (t (L, F), valid (L, F)). The
    plane t = (n . p0 - n . o) / (n . d); the barycentrics of the point
    by the dual basis of the edges, b1 = a1 . (q - p0), b2 = a2 . (q - p0)."""
    F = scene.n.shape[0]
    po = precision.matmul(o, scene.cast_rows) - scene.cast_off      # (L, 3F)
    pd = precision.matmul(d, scene.cast_rows)
    nd = pd[:, :F]
    t = -po[:, :F] / nd
    b1 = po[:, F:2 * F] + t * pd[:, F:2 * F]
    b2 = po[:, 2 * F:] + t * pd[:, 2 * F:]
    valid = ((nd != 0.0) & (t > mint[:, None]) & (t < maxt[:, None])
             & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0))
    return t, valid


@torch.no_grad()
def closest_hit(scene, o, d, mint, maxt):
    """-> (t, triangle) of each ray's nearest hit in (mint, maxt); triangle
    -1 and t inf on a miss."""
    t, valid = _cast(scene, o, d, mint, maxt)
    t, face = torch.where(valid, t, torch.inf).min(dim=1)
    return t, torch.where(torch.isfinite(t), face, -1)


@torch.no_grad()
def occluded(scene, o, d, mint, maxt):
    """Whether anything lies on the ray in (mint, maxt)."""
    return _cast(scene, o, d, mint, maxt)[1].any(dim=1)


def onb(n):
    """Duff et al.'s orthonormal basis about the unit normal n (L, 3):
    -> (s, t)."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    t = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return s, t


def cosine_direction(u1, u2):
    """Malley's method: Shirley and Chiu's concentric map of the square to
    the disk, lifted to the hemisphere. -> local direction (L, 3)."""
    x, y = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    wide = x * x > y * y
    r = torch.where(wide, x, y)
    phi = torch.where(wide, (math.pi / 4.0) * (y / torch.where(x == 0.0, 1.0, x)),
                      math.pi / 2.0 - (math.pi / 4.0) * (x / torch.where(y == 0.0, 1.0, y)))
    centre = (x == 0.0) & (y == 0.0)
    r = torch.where(centre, 0.0, r)
    phi = torch.where(centre, 0.0, phi)
    dx, dy = r * torch.cos(phi), r * torch.sin(phi)
    return torch.stack([dx, dy, torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=1e-20))], -1)


def light_point(scene, u1, u2):
    """A point uniform in area on the light: its triangle by the area CDF on
    u2 (the sample rescaled within it), the point by the square-root warp on
    (u1, u2'). -> (point (L, 3), its triangle (L,))."""
    cdf = scene.light_cdf
    k = torch.clamp((u2[:, None] > cdf[None, :]).sum(1), max=cdf.shape[0] - 1)
    lo = torch.where(k > 0, cdf[torch.clamp(k - 1, min=0)], 0.0)
    hi = cdf[k]
    u2 = torch.clamp((u2 - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0 - 1e-7)
    f = scene.light_faces[k]
    s = torch.sqrt(torch.clamp(1.0 - u1, min=1e-20))
    b1, b2 = 1.0 - s, s * u2
    return scene.p0[f] + (scene.e1[f] * b1[:, None] + scene.e2[f] * b2[:, None]), f


def sample_light(scene, p, u1, u2):
    """Next-event estimation's light sample seen from p: -> (unit direction,
    distance, solid-angle pdf, 0 where the light faces away)."""
    q, f = light_point(scene, u1, u2)
    v = q - p
    dist2 = dot(v, v)
    dist = torch.sqrt(dist2)
    w = v / torch.clamp(dist, min=1e-20)[:, None]
    cos_l = dot(w, scene.n[f])
    pdf = torch.where((cos_l < 0.0) & (cos_l != 0.0),
                      dist2 / (scene.light_area * torch.clamp(-cos_l, min=1e-20)), 0.0)
    return w, dist, pdf


def light_pdf(scene, face, d, t):
    """The solid-angle pdf with which `sample_light` picks the point at
    distance t along d on the light's triangle `face`."""
    c = dot(d, scene.n[face]).abs()
    return torch.where(c != 0.0, t * t / (scene.light_area * torch.clamp(c, min=1e-20)), 0.0)


def mis(a, b):
    """The power-2 heuristic's weight of the technique with pdf a."""
    return torch.where(a * a > 0.0, a * a / torch.clamp(a * a + b * b, min=TINY), 0.0)


class Hit:
    """A surface point of each lane: position, unit normal, frame, the
    direction back along the ray in the frame, the triangle."""

    def __init__(self, scene, o, d, t, face):
        self.valid = face >= 0
        self.face = torch.clamp(face, min=0)
        self.t = t
        self.p = torch.where(self.valid[:, None], o + d * torch.where(self.valid, t, 0.0)[:, None],
                             o)
        self.n = scene.n[self.face]
        self.s, _ = onb(self.n)
        self.tt = torch.linalg.cross(self.n, self.s, dim=-1)
        self.wi_z = -dot(d, self.n)
        self.emits = self.valid & scene.emits[self.face]

    def local(self, w):
        return torch.stack([dot(w, self.s), dot(w, self.tt), dot(w, self.n)], -1)

    def world(self, v):
        return self.s * v[:, 0:1] + self.tt * v[:, 1:2] + self.n * v[:, 2:3]

    def spawn_mint(self):
        return RAY_EPS * (1.0 + self.p.abs().amax(-1))


# ---------------------------------------------------------------------------
# the path tracer
# ---------------------------------------------------------------------------

def trace(scene, leaves, lane, seed):
    """Lanes `lane` (L,) int64 of the frame with `seed` -> (XYZ (L, 3), the
    film positions x, y (L,), the pixels (L,) int64). Differentiable in
    `leaves`."""
    spp, W = scene.spp, scene.width
    st = pcg32.path_stream(lane, seed)
    jx, st = pcg32.next_float32(st)
    jy, st = pcg32.next_float32(st)
    u_lam, st = pcg32.next_float32(st)
    _, st = pcg32.next_2d(st)
    pixel = lane // spp
    x = (pixel % W).to(torch.float32) + jx
    y = (pixel // W).to(torch.float32) + jy
    lam, lam_w = sample_wavelengths(u_lam)
    le = light_radiance(leaves, lam)
    refl_of = leaves["materials"]

    o, d, mint, maxt = camera_rays(scene, x, y)
    hit = Hit(scene, o, d, *closest_hit(scene, o, d, mint, maxt))
    radiance = torch.where((hit.emits & (hit.wi_z > 0.0))[:, None], le, 0.0)
    beta = torch.ones_like(le)
    alive = hit.valid
    for depth in range(1, scene.max_depth):
        (ul1, ul2), st = pcg32.next_2d(st)
        _, st = pcg32.next_float32(st)
        (ub1, ub2), st = pcg32.next_2d(st)
        u_rr, st = pcg32.next_float32(st)
        refl = sigmoid_spectrum(refl_of[scene.shape[hit.face]], lam)
        front = hit.wi_z > 0.0

        # next-event estimation
        wl, dist, pdf_l = sample_light(scene, hit.p, ul1, ul2)
        try_l = alive & (pdf_l > 0.0)
        blocked = occluded(scene, hit.p, wl, torch.where(try_l, hit.spawn_mint(), 0.0),
                           torch.where(try_l, dist * (1.0 - SHADOW_EPS), -1.0))
        cos_o = dot(wl, hit.n)
        lit = front & (cos_o > 0.0)
        f = torch.where(lit[:, None], refl * (cos_o / math.pi)[:, None], 0.0)
        pdf_b = torch.where(lit, cos_o / math.pi, 0.0)
        w = mis(pdf_l, pdf_b).detach()
        contrib = beta * le / torch.clamp(pdf_l, min=1e-20)[:, None] * f * w[:, None]
        radiance = radiance + torch.where((try_l & ~blocked)[:, None], contrib, 0.0)

        # the diffuse lobe's direction, and what it hits
        wo = cosine_direction(ub1, ub2)
        pdf_wo = wo[:, 2] / math.pi
        ok = front & (pdf_wo > 0.0)
        pdf_wo = torch.where(ok, pdf_wo, 0.0)
        d = hit.world(wo)
        t2, f2 = closest_hit(scene, hit.p, d, torch.where(alive, hit.spawn_mint(), 0.0),
                             torch.where(alive, torch.inf, -1.0))
        nxt = Hit(scene, hit.p, d, t2, f2)
        beta = beta * torch.where(ok[:, None], refl, 0.0)

        seen = nxt.emits & (nxt.wi_z > 0.0)
        w = mis(pdf_wo, torch.where(nxt.emits, light_pdf(scene, nxt.face, d, t2), 0.0)).detach()
        radiance = radiance + torch.where((alive & seen)[:, None], beta * le * w[:, None], 0.0)
        alive = alive & ok & nxt.valid

        if depth + 1 >= scene.rr_depth:
            q = torch.clamp(beta.amax(-1), max=0.95).detach()
            alive = alive & (u_rr < q)
            beta = torch.where(alive[:, None], beta / torch.clamp(q, min=1e-8)[:, None], beta)
        hit = nxt
    return to_xyz(radiance * lam_w, lam), x, y, pixel


# ---------------------------------------------------------------------------
# the film
# ---------------------------------------------------------------------------

def film_reach(scene):
    """The filter's reach in whole pixels."""
    return 0 if scene.filter == "box" else int(math.ceil(4.0 * scene.stddev))


def new_film(scene):
    """(5, H + 2 r, W + 2 r) zeros: X, Y, Z, alpha and the filter weight,
    with a border of the filter's reach r."""
    r = film_reach(scene)
    return torch.zeros((5, scene.height + 2 * r, scene.width + 2 * r), device=scene.device)


def splat(scene, film, xyz, x, y, pixel):
    """Add each sample of `pixel` at film position (x, y) to the pixels its
    filter reaches: weight g(dx) g(dy) of the distances to the pixel's
    centre, g(u) = max(exp(-u^2 / (2 stddev^2)) - exp(-(4 stddev)^2 /
    (2 stddev^2)), 0) (a box filter: weight 1 in the sample's own pixel). A
    sample whose value is not finite adds 0 to X, Y, Z and its full weight.
    The sample's own pixel comes from its lane: x may round up to the next
    pixel's edge in float32."""
    r = film_reach(scene)
    Wp = scene.width + 2 * r
    px, py = (pixel % scene.width).to(torch.float32), (pixel // scene.width).to(torch.float32)
    vals = torch.cat([torch.where(torch.isfinite(xyz), xyz, 0.0),
                      torch.ones_like(xyz[:, :2])], -1)             # (L, 5)
    flat = film.view(5, -1)
    if scene.filter == "box":
        idx = ((py + r) * Wp + px + r).to(torch.int64)
        flat.index_add_(1, idx, vals.T)
        return film
    alpha = -1.0 / (2.0 * scene.stddev ** 2)
    cut = math.exp(alpha * (4.0 * scene.stddev) ** 2)

    def g(u):
        return torch.clamp(torch.exp(alpha * u * u) - cut, min=0.0)

    for oy in range(-r, r + 1):
        wy = g(py + oy + 0.5 - y)
        for ox in range(-r, r + 1):
            w = g(px + ox + 0.5 - x) * wy
            idx = ((py + oy + r) * Wp + px + ox + r).to(torch.int64)
            flat.index_add_(1, idx, (vals * w[:, None]).T)
    return film


def film_rgb(scene, film):
    """The film's pixels (H, W) developed: XYZ over the weight, to sRGB."""
    r = film_reach(scene)
    f = film[:, r:r + scene.height, r:r + scene.width]
    w = f[4]
    has = w != 0.0
    inv = torch.where(has, 1.0 / torch.where(has, w, 1.0), 0.0)
    return develop(f[:3].permute(1, 2, 0)) * inv[..., None]


def render_lanes(scene, leaves, seed, lane0, lane1, chunk, film=None):
    """Splat the lanes [lane0, lane1) into `film` (a new one by default),
    `chunk` lanes at a time."""
    film = new_film(scene) if film is None else film
    for c0 in range(lane0, lane1, chunk):
        lane = torch.arange(c0, min(c0 + chunk, lane1), dtype=torch.int64, device=scene.device)
        splat(scene, film, *trace(scene, leaves, lane, seed))
    return film


def render_rows(scene, seed, y0, y1, chunk=1 << 18):
    """Rows [y0, y1) of the frame with `seed`, developed (rows, W, 3): every
    sample the filter carries into them, from the rows within its reach."""
    r = film_reach(scene)
    lanes = scene.width * scene.spp
    with torch.no_grad():
        film = render_lanes(scene, scene.leaves, seed, max(0, y0 - r) * lanes,
                            min(scene.height, y1 + r) * lanes, chunk)
        return film_rgb(scene, film)[y0:y1]


def loss_and_grads(scene, leaves, target, seed, chunk=1 << 18, lanes=None):
    """The mean squared error of the frame with `seed` against `target`
    (H, W, 3), and its gradient with respect to `leaves` ({name: tensor}):
    the frame without a graph first, then dL/dfilm, then the frame again a
    chunk at a time under autograd, each chunk's film given dL/dfilm (the
    film is the sum of its chunks). The estimator's MIS weights and roulette
    probabilities are held constant. `lanes`: the frame's first `lanes`
    lanes alone (all by default). -> (loss, {name: gradient})."""
    n = scene.width * scene.height * scene.spp if lanes is None else lanes
    with torch.no_grad():
        film = render_lanes(scene, leaves, seed, 0, n, chunk)
    film.requires_grad_()
    loss = torch.mean((film_rgb(scene, film) - target) ** 2)
    (g_film,) = torch.autograd.grad(loss, film)
    params = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    for c0 in range(0, n, chunk):
        part = render_lanes(scene, params, seed, c0, min(c0 + chunk, n), chunk)
        torch.autograd.backward(part, g_film)
    return loss.detach(), {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                           for k, p in params.items()}
