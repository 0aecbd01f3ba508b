"""The cbox-sierpinski scene and its path frames, written plainly: the
Cornell box as `scene.py` reads it, with the Sierpinski tetrahedron of
Haines's Standard Procedural Databases (`tetra`) generated here from its
formula, and `path.py`'s estimator with casts blocked over faces and lanes,
so that a million faces fit on one card.

The tetrahedron: a regular tetrahedron of edge 1 standing on a face, base
(-1/2, 0, -sqrt(3)/6), (1/2, 0, -sqrt(3)/6), (0, 0, sqrt(3)/3), apex (0,
sqrt(2/3), 0); each level replaces every tetrahedron by its four half-size
corner copies, copy k with vertices (v_i + v_k) / 2. Its faces are wound
outward and placed by the shape's <transform> (scale, rotate, translate),
in float64, then rounded to float32 as the box's quads are.

The casts: the faces in blocks of `BLOCK_FACES` consecutive faces (the
formula's order keeps a block one small corner tetrahedron; the box's faces
are a block of their own), each with its bounding box grown by `BOX_PAD` of
the scene's reach. A ray is cast against a block only where its segment,
up to the nearest hit found so far, meets the block's box (in float64); then
against every face of the block, `LANE_BLOCK` rays at a time, with
`path.py`'s plane and dual-basis rows (its `precision.matmul`, so TF32 under
the control). Blocks go in face order and a nearer t alone replaces a hit,
so the nearest hit is `path.closest_hit`'s: the smallest t, then the lowest
face.
"""

import io
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, replace

import numpy as np
import torch

from benchmark.reference import path as pt
from benchmark.reference import pcg32, precision
from benchmark.reference import scene as sc

BLOCK_FACES = 4096       # faces a block: 1,024 tetrahedra of one corner copy
LANE_BLOCK = 16384       # rays cast against a block at a time (about 0.8 GB a temporary)
BOX_PAD = 1e-4           # a block's box grows by this share of the scene's reach

_TETRA = np.array([[-0.5, 0.0, -math.sqrt(3.0) / 6.0],
                   [0.5, 0.0, -math.sqrt(3.0) / 6.0],
                   [0.0, 0.0, math.sqrt(3.0) / 3.0],
                   [0.0, math.sqrt(2.0 / 3.0), 0.0]])


# ---------------------------------------------------------------------------
# the tetrahedron
# ---------------------------------------------------------------------------

def tetra_faces(level):
    """The faces of the level-`level` tetrahedron before its transform,
    (4^(level + 1), 3, 3) float64, each wound so that (b - a) x (c - a)
    points away from its tetrahedron's centre."""
    v = _TETRA[None]
    for _ in range(int(level)):
        v = (0.5 * (v[:, :, None, :] + v[:, None, :, :])).reshape(-1, 4, 3)
    faces = []
    for i in range(4):                      # the face opposite vertex i
        a, b, c = [j for j in range(4) if j != i]
        f = np.stack([v[:, a], v[:, b], v[:, c]], axis=1)
        n = np.cross(f[:, 1] - f[:, 0], f[:, 2] - f[:, 0])
        inward = (n * (v[:, i] - f[:, 0])).sum(-1) > 0.0
        f[inward] = f[inward][:, [0, 2, 1]]
        faces.append(f)
    return np.stack(faces, axis=1).reshape(-1, 3, 3)


def _matrix(node):
    """The 4x4 matrix of a shape's <transform> of scale, rotate (axis and
    angle in degrees, Rodrigues' formula) and translate, in document order
    (each op applied after the ones before it)."""
    m = np.eye(4)
    for op in node.find("transform"):
        xyz = np.array([float(op.get(k, 0.0)) for k in "xyz"])
        step = np.eye(4)
        if op.tag == "scale":
            v = op.get("value")
            step[:3, :3] = np.diag([float(v)] * 3 if v is not None else
                                   [float(op.get(k, 1.0)) for k in "xyz"])
        elif op.tag == "rotate":
            k = xyz / np.linalg.norm(xyz)
            a = math.radians(float(op.get("angle")))
            K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
            step[:3, :3] = np.eye(3) + math.sin(a) * K + (1.0 - math.cos(a)) * (K @ K)
        elif op.tag == "translate":
            step[:3, 3] = xyz
        else:
            raise ValueError(f"the reference does not read <{op.tag}> in a transform")
        m = step @ m
    return m


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

@dataclass
class Blocked:
    """A scene (`scene.Scene`, every face) with its casts' blocks: faces
    [first[k], first[k + 1]) form block k, with the plane and dual-basis
    rows `rows[k]` (3, 3 B) and offsets `off[k]` (3 B,) of `path._cast`,
    and its grown box lo[k], hi[k] (float64)."""
    scene: sc.Scene
    first: list
    rows: list
    off: list
    lo: torch.Tensor
    hi: torch.Tensor


def load(path, width=None, height=None, spp=None, max_depth=None, device="cpu"):
    """The scene of XML `path`: its `sierpinski` shapes generated here, the
    rest read by `scene.load`, with the configuration's overrides."""
    root = ET.parse(path).getroot()
    bsdfs = {n.get("id"): sc._props(n).get("reflectance", [0.5, 0.5, 0.5])
             for n in root if n.tag == "bsdf"}
    tets = [n for n in root if n.tag == "shape" and n.get("type") == "sierpinski"]
    for n in tets:
        root.remove(n)
    box = sc.load(io.StringIO(ET.tostring(root, encoding="unicode")), width=width,
                  height=height, spp=spp, max_depth=max_depth, device=device)

    dev = box.device
    f32 = dict(dtype=torch.float32, device=dev)
    p0 = [box.p0.cpu().double().numpy()]
    e1 = [box.e1.cpu().double().numpy()]
    e2 = [box.e2.cpu().double().numpy()]
    shape = [box.shape.cpu().numpy()]
    coeffs = [box.leaves["materials"].cpu().double().numpy()]
    first = [0]                     # the box's faces, one block
    F = len(p0[0])
    for n in tets:
        sc._only(n, ("integer", "transform", "ref"))
        m = _matrix(n)
        P = tetra_faces(int(sc._props(n)["level"])) @ m[:3, :3].T + m[:3, 3]
        P = P.astype(np.float32).astype(np.float64)
        p0.append(P[:, 0])
        e1.append((P[:, 1] - P[:, 0]).astype(np.float32).astype(np.float64))
        e2.append((P[:, 2] - P[:, 0]).astype(np.float32).astype(np.float64))
        shape.append(np.full(len(P), sum(map(len, coeffs))))
        coeffs.append(sc.fit_sigmoid(bsdfs[n.find("ref").get("id")])[None])
        first += list(range(F, F + len(P), BLOCK_FACES))
        F += len(P)
    first.append(F)
    p0, e1, e2 = np.concatenate(p0), np.concatenate(e1), np.concatenate(e2)
    cr = np.cross(e1, e2)
    nrm = cr / np.linalg.norm(cr, axis=1, keepdims=True)
    a1 = np.cross(e2, cr) / np.sum(cr * cr, axis=1, keepdims=True)
    a2 = np.cross(cr, e1) / np.sum(cr * cr, axis=1, keepdims=True)
    shape = np.concatenate(shape)

    def t(a):
        return torch.as_tensor(np.asarray(a), **f32)

    full = replace(box, p0=t(p0), e1=t(e1), e2=t(e2), n=t(nrm),
                   cast_rows=torch.zeros((3, 0), **f32), cast_off=torch.zeros(0, **f32),
                   shape=torch.as_tensor(shape, dtype=torch.int64, device=dev),
                   emits=torch.as_tensor(np.isin(np.arange(F), box.light_faces.cpu().numpy()),
                                         device=dev),
                   leaves=dict(box.leaves, materials=t(np.concatenate(coeffs))))
    V = np.stack([p0, p0 + e1, p0 + e2], axis=1)
    reach = float(np.abs(V).max())
    rows, off, lo, hi = [], [], [], []
    for a, b in zip(first[:-1], first[1:]):
        r = np.concatenate([nrm[a:b], a1[a:b], a2[a:b]])          # (3 B, 3)
        o = np.concatenate([np.sum(nrm[a:b] * p0[a:b], 1), np.sum(a1[a:b] * p0[a:b], 1),
                            np.sum(a2[a:b] * p0[a:b], 1)])
        rows.append(t(r.T).contiguous())
        off.append(t(o))
        lo.append(V[a:b].reshape(-1, 3).min(0) - BOX_PAD * reach)
        hi.append(V[a:b].reshape(-1, 3).max(0) + BOX_PAD * reach)
    return Blocked(scene=full, first=first, rows=rows, off=off,
                   lo=torch.as_tensor(np.array(lo), dtype=torch.float64, device=dev),
                   hi=torch.as_tensor(np.array(hi), dtype=torch.float64, device=dev))


# ---------------------------------------------------------------------------
# the casts
# ---------------------------------------------------------------------------

def _meets(o, rcp, lo, hi, mint, maxt):
    """Whether each ray's segment [mint, maxt] meets the box [lo, hi]
    (float64 slabs; a zero direction component has rcp +-inf, and a slab
    it lies in, 0 * inf, constrains nothing)."""
    t0 = (lo - o) * rcp
    t1 = (hi - o) * rcp
    near = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf).amax(-1)
    far = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf).amin(-1)
    return (torch.maximum(near, mint) <= torch.minimum(far, maxt)) & (mint <= maxt)


def _block_cast(bs, k, o, d, mint, maxt):
    """Rays against block k's faces: -> (t (L, B), valid (L, B))."""
    B = bs.first[k + 1] - bs.first[k]
    po = precision.matmul(o, bs.rows[k]) - bs.off[k]
    pd = precision.matmul(d, bs.rows[k])
    nd = pd[:, :B]
    t = -po[:, :B] / nd
    b1 = po[:, B:2 * B] + t * pd[:, B:2 * B]
    b2 = po[:, 2 * B:] + t * pd[:, 2 * B:]
    valid = ((nd != 0.0) & (t > mint[:, None]) & (t < maxt[:, None])
             & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0))
    return t, valid


def _walk(bs, o, d, mint, maxt, any_hit):
    """The blocks each ray meets, in face order: -> (t (L,), face (L,)) of the
    nearest hit in (mint, maxt), or with `any_hit` t 0 where some face is hit
    (then the ray is done)."""
    L = o.shape[0]
    dev = o.device
    best_t = torch.full((L,), math.inf, device=dev)
    best_f = torch.full((L,), -1, dtype=torch.int64, device=dev)
    o64, d64 = o.double(), d.double()
    rcp = 1.0 / d64
    m64, x64 = mint.double(), maxt.double()
    for k in range(len(bs.first) - 1):
        upper = torch.minimum(x64, best_t.double())
        rays = torch.nonzero(_meets(o64, rcp, bs.lo[k], bs.hi[k], m64, upper)).squeeze(1)
        for s in range(0, rays.shape[0], LANE_BLOCK):
            i = rays[s:s + LANE_BLOCK]
            t, valid = _block_cast(bs, k, o[i], d[i], mint[i], torch.minimum(maxt[i], best_t[i]))
            t, f = torch.where(valid, t, math.inf).min(dim=1)
            nearer = t < best_t[i]
            best_t[i] = torch.where(nearer, t, best_t[i])
            best_f[i] = torch.where(nearer, f + bs.first[k], best_f[i])
        if any_hit:
            best_t = torch.where(best_f >= 0, 0.0, best_t)
    return best_t, best_f


@torch.no_grad()
def closest_hit(bs, o, d, mint, maxt):
    """-> (t, triangle) of each ray's nearest hit in (mint, maxt); triangle
    -1 and t inf on a miss."""
    return _walk(bs, o, d, mint, maxt, any_hit=False)


@torch.no_grad()
def occluded(bs, o, d, mint, maxt):
    """Whether anything lies on the ray in (mint, maxt)."""
    return _walk(bs, o, d, mint, maxt, any_hit=True)[1] >= 0


# ---------------------------------------------------------------------------
# the path tracer: path.trace with the blocked casts
# ---------------------------------------------------------------------------

def trace(bs, leaves, lane, seed):
    """`path.trace` of lanes `lane` (L,) of the frame with `seed` over the
    blocked scene `bs`: the same draws, estimator and outputs."""
    scene = bs.scene
    spp, W = scene.spp, scene.width
    st = pcg32.path_stream(lane, seed)
    jx, st = pcg32.next_float32(st)
    jy, st = pcg32.next_float32(st)
    u_lam, st = pcg32.next_float32(st)
    _, st = pcg32.next_2d(st)
    pixel = lane // spp
    x = (pixel % W).to(torch.float32) + jx
    y = (pixel // W).to(torch.float32) + jy
    lam, lam_w = pt.sample_wavelengths(u_lam)
    le = pt.light_radiance(leaves, lam)
    refl_of = leaves["materials"]

    o, d, mint, maxt = pt.camera_rays(scene, x, y)
    hit = pt.Hit(scene, o, d, *closest_hit(bs, o, d, mint, maxt))
    radiance = torch.where((hit.emits & (hit.wi_z > 0.0))[:, None], le, 0.0)
    beta = torch.ones_like(le)
    alive = hit.valid
    for depth in range(1, scene.max_depth):
        (ul1, ul2), st = pcg32.next_2d(st)
        _, st = pcg32.next_float32(st)
        (ub1, ub2), st = pcg32.next_2d(st)
        u_rr, st = pcg32.next_float32(st)
        refl = pt.sigmoid_spectrum(refl_of[scene.shape[hit.face]], lam)
        front = hit.wi_z > 0.0

        # next-event estimation
        wl, dist, pdf_l = pt.sample_light(scene, hit.p, ul1, ul2)
        try_l = alive & (pdf_l > 0.0)
        blocked = occluded(bs, hit.p, wl, torch.where(try_l, hit.spawn_mint(), 0.0),
                           torch.where(try_l, dist * (1.0 - pt.SHADOW_EPS), -1.0))
        cos_o = pt.dot(wl, hit.n)
        lit = front & (cos_o > 0.0)
        f = torch.where(lit[:, None], refl * (cos_o / math.pi)[:, None], 0.0)
        pdf_b = torch.where(lit, cos_o / math.pi, 0.0)
        w = pt.mis(pdf_l, pdf_b)
        contrib = beta * le / torch.clamp(pdf_l, min=1e-20)[:, None] * f * w[:, None]
        radiance = radiance + torch.where((try_l & ~blocked)[:, None], contrib, 0.0)

        # the diffuse lobe's direction, and what it hits
        wo = pt.cosine_direction(ub1, ub2)
        pdf_wo = wo[:, 2] / math.pi
        ok = front & (pdf_wo > 0.0)
        pdf_wo = torch.where(ok, pdf_wo, 0.0)
        d = hit.world(wo)
        t2, f2 = closest_hit(bs, hit.p, d, torch.where(alive, hit.spawn_mint(), 0.0),
                             torch.where(alive, torch.inf, -1.0))
        nxt = pt.Hit(scene, hit.p, d, t2, f2)
        beta = beta * torch.where(ok[:, None], refl, 0.0)

        seen = nxt.emits & (nxt.wi_z > 0.0)
        w = pt.mis(pdf_wo, torch.where(nxt.emits, pt.light_pdf(scene, nxt.face, d, t2), 0.0))
        radiance = radiance + torch.where((alive & seen)[:, None], beta * le * w[:, None], 0.0)
        alive = alive & ok & nxt.valid

        if depth + 1 >= scene.rr_depth:
            q = torch.clamp(beta.amax(-1), max=0.95)
            alive = alive & (u_rr < q)
            beta = torch.where(alive[:, None], beta / torch.clamp(q, min=1e-8)[:, None], beta)
        hit = nxt
    return pt.to_xyz(radiance * lam_w, lam), x, y, pixel


@torch.no_grad()
def render_rows(bs, seed, y0, y1, chunk=1 << 20):
    """Rows [y0, y1) of the frame with `seed`, developed (rows, W, 3), as
    `path.render_rows` makes them: every sample the filter carries into
    them, from the rows within its reach."""
    scene = bs.scene
    r = pt.film_reach(scene)
    lanes = scene.width * scene.spp
    a, b = max(0, y0 - r) * lanes, min(scene.height, y1 + r) * lanes
    film = pt.new_film(scene)
    for c0 in range(a, b, chunk):
        lane = torch.arange(c0, min(c0 + chunk, b), dtype=torch.int64, device=scene.device)
        pt.splat(scene, film, *trace(bs, scene.leaves, lane, seed))
    return pt.film_rgb(scene, film)[y0:y1]
