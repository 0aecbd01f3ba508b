"""Veach's multiple-importance-sampling scene and its path frames, written
plainly: rectangles and icosphere lights generated here from their
formulas, several area lights picked uniformly, Mitsuba's `roughconductor`
(GGX) beside `diffuse`, and `path.py`'s estimator (NEE, power-2 MIS at
every emitter hit, roulette) with casts blocked over faces and lanes.

The shapes:
- `rectangle`: the square [-1, 1]^2 of the plane z = 0, normal +z, split
  into the triangles (0, 1, 2) and (3, 0, 2) of its corners (-1, -1),
  (1, -1), (1, 1), (-1, 1) with the texture coordinates (0, 0), (1, 0),
  (1, 1), (0, 1); placed by its <transform> (scale, rotate, translate), the
  normal by the inverse transpose.
- `sphere`: the icosahedron's 12 vertices (+-1, +-phi, 0) and their cyclic
  shifts, normalised, and its 20 faces, each face split four times into
  (a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca), every new vertex the
  normalised midpoint of its edge: 5,120 faces, each vertex's normal its
  own direction; then radius and centre. Consecutive runs of 256 faces are
  the children of one face of the icosahedron, so each is a block of the
  casts.
Positions are made in float64 and rounded once to float32; edges, normals
and tangents are taken from the rounded corners in float64, then rounded.

The shading frame, as the scene's meshes define it: the normal interpolated
from the vertex normals at the hit's barycentrics (both shapes have them),
the first tangent dp/du of the texture coordinates (a sphere has none: the
geometric normal's Duff et al. basis vector) made orthogonal to it. Every
direction of a BSDF or an emission test is taken in that frame.

Departures from Mitsuba that the reference shares with the program, since a
sample-for-sample comparison needs both sides to compute the same estimator:
- a light's next-event sample takes its pdf, and its one-sided emission
  test, from the shading normal interpolated at the sampled point; a BSDF
  ray that hits a light takes the light's pdf from the face's geometric
  normal, and its emission test from the shading frame;
- emission is one-sided (the side the shading normal faces);
- the GGX lobe samples the distribution of normals (Walter et al.'s polar
  form, pdf D(m) cos(m)), not the visible normals;
- a conductor's eta and k, given as RGB, are lifted to spectra by straight
  lines between the channels' anchor wavelengths (465, 532 and 630 nm for
  blue, green and red), held beyond them;
- a plain value v of a reflectance (a conductor's default specular
  reflectance 1) is the flat sigmoid spectrum c2 = (v' - 1/2) / sqrt(v'
  (1 - v')), v' = v held to [1e-4, 1 - 1e-4].

A lane draws as `path.py`'s do: the pixel jitter (2), the wavelength (1),
the lens (2, unused); each bounce the light sample (2: the light by u1 with
sample reuse, the face by u2 with sample reuse, the point by the square-root
warp), the lobe (1, unused by both BSDFs), the direction (2) and the
roulette (1). Every matrix product goes through `precision.matmul`.
"""

import io
import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import path as pt
from benchmark.reference import pcg32, precision
from benchmark.reference import scene as sc
from benchmark.reference import sierpinski as sp

SPHERE_LEVELS = 4        # the icosahedron split four times: 20 x 4^4 = 5,120 faces
BLOCK_FACES = 256        # a sphere's block: the faces of one face of the icosahedron
LANE_BLOCK = 1 << 17     # rays cast against a block at a time
BOX_PAD = 1e-4           # a box grows by this share of the scene's reach
ALPHA_MIN = 1e-4
TINY = 1e-20
F32_TINY = float(np.finfo(np.float32).tiny)
DIFFUSE, CONDUCTOR = 0, 1
ANCHORS = (465.0, 532.0, 630.0)

_PHI = (1.0 + math.sqrt(5.0)) / 2.0
_ICO_VERTS = np.array([[-1, _PHI, 0], [1, _PHI, 0], [-1, -_PHI, 0], [1, -_PHI, 0],
                       [0, -1, _PHI], [0, 1, _PHI], [0, -1, -_PHI], [0, 1, -_PHI],
                       [_PHI, 0, -1], [_PHI, 0, 1], [-_PHI, 0, -1], [-_PHI, 0, 1]])
_ICO_FACES = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
              (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
              (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
              (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]


# ---------------------------------------------------------------------------
# the shapes
# ---------------------------------------------------------------------------

def icosphere(levels=SPHERE_LEVELS):
    """The unit icosphere's faces, (20 * 4^levels, 3, 3) float64 corners,
    face f of a level split into faces 4f .. 4f + 3 of the next."""
    tris = _ICO_VERTS[np.array(_ICO_FACES)]
    tris = tris / np.linalg.norm(tris, axis=-1, keepdims=True)
    for _ in range(levels):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]

        def mid(p, q):
            m = p + q
            return m / np.linalg.norm(m, axis=-1, keepdims=True)

        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        tris = np.stack([np.stack(t, 1) for t in ((a, ab, ca), (b, bc, ab), (c, ca, bc),
                                                   (ab, bc, ca))], 1).reshape(-1, 3, 3)
    return tris


_RECT = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0]])
_RECT_UV = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
_RECT_TRIS = [(0, 1, 2), (3, 0, 2)]


def _shape_mesh(node):
    """(corners (F, 3, 3), vertex normals (F, 3, 3), texture coordinates (F,
    3, 2) or None) of a <shape>, placed, in float64."""
    kind = node.get("type")
    if kind == "rectangle":
        m = sp._matrix(node)
        P = _RECT[np.array(_RECT_TRIS)] @ m[:3, :3].T + m[:3, 3]
        n = np.linalg.inv(m[:3, :3]).T @ np.array([0.0, 0.0, 1.0])
        N = np.broadcast_to(n / np.linalg.norm(n), P.shape).copy()
        return P, N, _RECT_UV[np.array(_RECT_TRIS)]
    if kind == "sphere":
        sc._only(node, ("point", "float", "ref", "emitter", "bsdf"))
        props = sc._props(node)
        c = node.find("point")
        centre = np.array([float(c.get(k, 0.0)) for k in "xyz"]) if c is not None else np.zeros(3)
        unit = icosphere()
        return unit * float(props.get("radius", 1.0)) + centre, unit.copy(), None
    raise ValueError(f"the reference reads rectangles and spheres, not {kind}")


def _bsdf(node):
    """A <bsdf>: {kind, reflectance coefficients, alpha, eta, k,
    specular coefficients}."""
    kind = node.get("type")
    p = sc._props(node)
    if kind == "diffuse":
        return {"kind": DIFFUSE, "refl": sc.fit_sigmoid(p.get("reflectance", [0.5] * 3)),
                "alpha": 0.0, "eta": [0.0] * 3, "k": [0.0] * 3, "spec": np.zeros(3)}
    if kind == "roughconductor":
        if p.get("distribution") != "ggx" or "alpha_u" in p:
            raise ValueError("the reference reads an isotropic GGX roughconductor only")
        v = float(np.clip(float(p.get("specular_reflectance", 1.0)), 1e-4, 1.0 - 1e-4))
        return {"kind": CONDUCTOR, "refl": np.zeros(3), "alpha": float(p.get("alpha", 0.1)),
                "eta": p.get("eta", [0.0] * 3), "k": p.get("k", [1.0] * 3),
                "spec": np.array([0.0, 0.0, (v - 0.5) / math.sqrt(v * (1.0 - v))])}
    raise ValueError(f"the reference reads diffuse and roughconductor, not {kind}")


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

@dataclass
class Block:
    """Faces [first, first + count): the casts' plane and dual-basis rows
    (3, 3 B) and offsets (3 B,) of `path._cast`, and the grown box."""
    first: int
    count: int
    rows: torch.Tensor
    off: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


@dataclass
class Group:
    """Blocks cast only where a ray meets the group's box (a sphere's), in
    face order."""
    lo: torch.Tensor
    hi: torch.Tensor
    blocks: list


@dataclass
class Scene:
    """Per face (F rows, float32): p0, e1, e2, the unit geometric normal ng,
    the vertex normals n0, n1, n2, the tangent, the dual basis a1, a2;
    its material and emitter (-1: none). Per material: kind, reflectance
    and specular coefficients, alpha, eta and k (RGB). Per light: its faces
    with their area CDF, its area, its radiance (coefficients, curve). The
    camera and film as `path.camera_rays` and `path.splat` read them."""
    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    ng: torch.Tensor
    nv: torch.Tensor             # (F, 3, 3): n0, n1, n2
    tangent: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    material: torch.Tensor       # (F,) int64
    emitter: torch.Tensor        # (F,) int64
    kind: torch.Tensor           # (M,) int64
    refl: torch.Tensor           # (M, 3)
    spec: torch.Tensor           # (M, 3)
    alpha: torch.Tensor          # (M,)
    eta: torch.Tensor            # (M, 3)
    k: torch.Tensor              # (M, 3)
    lights: list                 # per light: {faces, cdf, area, coeff, curve}
    groups: list
    cam_origin: torch.Tensor
    cam_rot: torch.Tensor
    tan_half: float
    near: float
    far: float
    width: int
    height: int
    spp: int
    filter: str
    stddev: float
    max_depth: int
    rr_depth: int
    device: torch.device


def _f32(a):
    return np.asarray(a, np.float64).astype(np.float32).astype(np.float64)


def load(path, width=None, height=None, spp=None, max_depth=None, device="cpu"):
    """The scene of XML `path` with the configuration's overrides."""
    root = ET.parse(path).getroot()
    head = ET.Element("scene")
    head.extend([n for n in root if n.tag in ("integrator", "sensor")])
    d = sc.read_xml(io.StringIO(ET.tostring(head, encoding="unicode")))
    integ, sen = d["integrator"], d["sensor"]
    if integ["type"] != "path":
        raise ValueError(f"the reference renders path, not {integ['type']}")
    named = {n.get("id"): n for n in root if n.tag == "bsdf"}
    mats, mat_of = [], {}

    def material(node):
        key = id(node)
        if key not in mat_of:
            mat_of[key] = len(mats)
            mats.append(_bsdf(node))
        return mat_of[key]

    P, N, NG, T, mat, emi, lights = [], [], [], [], [], [], []
    for node in root:
        if node.tag in ("integrator", "sensor", "bsdf"):
            continue
        if node.tag != "shape":
            raise ValueError(f"the reference does not read <{node.tag}>")
        corners, normals, uv = _shape_mesh(node)
        corners = _f32(corners)
        normals = _f32(normals)
        e1, e2 = corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0]
        cr = np.cross(e1, e2)
        ng = cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-20)
        if uv is not None:      # dp/du of the texture coordinates
            d1, d2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
            det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
            tan = (d2[:, 1:2] * e1 - d1[:, 1:2] * e2) / det[:, None]
        else:                   # Duff et al.'s first basis vector of ng
            sign = np.where(ng[:, 2] >= 0.0, 1.0, -1.0)
            a = -1.0 / (sign + ng[:, 2])
            b = ng[:, 0] * ng[:, 1] * a
            tan = np.stack([1.0 + sign * ng[:, 0] ** 2 * a, sign * b, -sign * ng[:, 0]], -1)
        ref = node.find("ref")
        bs = node.find("bsdf")
        mat += [material(named[ref.get("id")] if ref is not None else bs)] * len(corners)
        em = node.find("emitter")
        if em is not None:
            if em.get("type") != "area":
                raise ValueError("the reference reads area emitters only")
            first = sum(map(len, P))
            area = 0.5 * np.linalg.norm(np.cross(e2, e1), axis=1)
            coeff, curve = sc.emitter_spectrum(sc._props(em)["radiance"])
            lights.append({"faces": np.arange(first, first + len(corners)),
                           "cdf": np.cumsum(area) / area.sum(), "area": area.sum(),
                           "coeff": coeff, "curve": curve})
        emi += [len(lights) - 1 if em is not None else -1] * len(corners)
        P.append(corners)
        N.append(normals)
        NG.append(ng)
        T.append(tan)
    P, N, T = np.concatenate(P), np.concatenate(N), np.concatenate(T)
    p0 = P[:, 0]
    e1, e2 = _f32(P[:, 1] - p0), _f32(P[:, 2] - p0)
    cr = np.cross(e1, e2)
    nrm = cr / np.linalg.norm(cr, axis=1, keepdims=True)
    a1 = np.cross(e2, cr) / np.sum(cr * cr, axis=1, keepdims=True)
    a2 = np.cross(cr, e1) / np.sum(cr * cr, axis=1, keepdims=True)
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), **f32)

    # the casts: each sphere a group of 256-face blocks, the rest one block
    reach = float(np.abs(P).max())
    pad = BOX_PAD * reach

    def box(a, b):
        V = P[a:b].reshape(-1, 3)
        return tuple(torch.as_tensor(v, dtype=torch.float64, device=dev)
                     for v in (V.min(0) - pad, V.max(0) + pad))

    def block(a, b):
        r = np.concatenate([nrm[a:b], a1[a:b], a2[a:b]])
        o = np.concatenate([np.sum(nrm[a:b] * p0[a:b], 1), np.sum(a1[a:b] * p0[a:b], 1),
                            np.sum(a2[a:b] * p0[a:b], 1)])
        return Block(a, b - a, t(r.T).contiguous(), t(o), *box(a, b))

    groups, f0 = [], 0
    emi = np.asarray(emi)
    while f0 < len(P):          # each run of faces of one light, or of no light
        f1 = f0 + int(np.argmax(np.append(emi[f0:] != emi[f0], True)))
        step = BLOCK_FACES if emi[f0] >= 0 else f1 - f0
        groups.append(Group(*box(f0, f1), [block(a, min(a + step, f1))
                                           for a in range(f0, f1, step)]))
        f0 = f1

    W = int(width or sen["width"])
    H = int(height or sen["height"])
    origin, target, up = sen["lookat"]
    fwd = (target - origin) / np.linalg.norm(target - origin)
    left = np.cross(up / np.linalg.norm(up), fwd)
    left /= np.linalg.norm(left)
    cam_up = np.cross(fwd, left)
    cam_up /= np.linalg.norm(cam_up)
    md = int(max_depth if max_depth is not None else integ.get("max_depth", -1))
    if md <= 0:
        raise ValueError("the reference renders a bounded depth (max_depth > 0)")
    return Scene(
        p0=t(p0), e1=t(e1), e2=t(e2), ng=t(np.concatenate(NG)), nv=t(N), tangent=t(T),
        a1=t(a1), a2=t(a2),
        material=torch.as_tensor(np.asarray(mat), dtype=torch.int64, device=dev),
        emitter=torch.as_tensor(emi, dtype=torch.int64, device=dev),
        kind=torch.as_tensor([m["kind"] for m in mats], dtype=torch.int64, device=dev),
        refl=t([m["refl"] for m in mats]), spec=t([m["spec"] for m in mats]),
        alpha=t([max(m["alpha"], ALPHA_MIN) for m in mats]),
        eta=t([m["eta"] for m in mats]), k=t([m["k"] for m in mats]),
        lights=[{"faces": torch.as_tensor(li["faces"], dtype=torch.int64, device=dev),
                 "cdf": t(li["cdf"]), "area": float(np.float32(li["area"])),
                 "coeff": t(li["coeff"]), "curve": t(li["curve"])} for li in lights],
        groups=groups,
        cam_origin=t(origin), cam_rot=t(np.stack([left, cam_up, fwd], axis=1)),
        tan_half=float(np.tan(np.deg2rad(sen["fov"]) / 2.0)),
        near=float(sen["near"]), far=float(sen["far"]), width=W, height=H,
        spp=int(spp or sen["spp"]), filter=sen["filter"], stddev=float(sen["stddev"]),
        max_depth=md, rr_depth=int(integ.get("rr_depth", 5)), device=dev)


# ---------------------------------------------------------------------------
# the casts
# ---------------------------------------------------------------------------

def _block_cast(blk, o, d, mint, maxt):
    """Rays against a block's faces: -> (t (L, B), valid (L, B))."""
    B = blk.count
    po = precision.matmul(o, blk.rows) - blk.off
    pd = precision.matmul(d, blk.rows)
    nd = pd[:, :B]
    t = -po[:, :B] / nd
    b1 = po[:, B:2 * B] + t * pd[:, B:2 * B]
    b2 = po[:, 2 * B:] + t * pd[:, 2 * B:]
    valid = ((nd != 0.0) & (t > mint[:, None]) & (t < maxt[:, None])
             & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0))
    return t, valid


def _walk(scene, o, d, mint, maxt, any_hit):
    """The groups and blocks each ray's segment meets, in face order: ->
    (t, face) of the nearest hit in (mint, maxt) (the smallest t, then the
    lowest face), or with `any_hit` t 0 where some face is hit."""
    L = o.shape[0]
    best_t = torch.full((L,), math.inf, device=o.device)
    best_f = torch.full((L,), -1, dtype=torch.int64, device=o.device)
    o64, rcp = o.double(), 1.0 / d.double()
    m64, x64 = mint.double(), maxt.double()
    for g in scene.groups:
        upper = torch.minimum(x64, best_t.double())
        rays = torch.nonzero(sp._meets(o64, rcp, g.lo, g.hi, m64, upper)).squeeze(1)
        if rays.numel() == 0:
            continue
        for blk in g.blocks:
            sub = rays
            if len(g.blocks) > 1:
                upper = torch.minimum(x64[rays], best_t[rays].double())
                sub = rays[sp._meets(o64[rays], rcp[rays], blk.lo, blk.hi, m64[rays], upper)]
            for s in range(0, sub.shape[0], LANE_BLOCK):
                i = sub[s:s + LANE_BLOCK]
                t, valid = _block_cast(blk, o[i], d[i], mint[i], torch.minimum(maxt[i], best_t[i]))
                t, f = torch.where(valid, t, math.inf).min(dim=1)
                nearer = t < best_t[i]
                best_t[i] = torch.where(nearer, t, best_t[i])
                best_f[i] = torch.where(nearer, f + blk.first, best_f[i])
            if any_hit:
                best_t = torch.where(best_f >= 0, 0.0, best_t)
    return best_t, best_f


def closest_hit(scene, o, d, mint, maxt):
    """-> (t, face) of each ray's nearest hit in (mint, maxt); face -1 and
    t inf on a miss."""
    return _walk(scene, o, d, mint, maxt, any_hit=False)


def occluded(scene, o, d, mint, maxt):
    """Whether anything lies on the ray in (mint, maxt)."""
    return _walk(scene, o, d, mint, maxt, any_hit=True)[1] >= 0


# ---------------------------------------------------------------------------
# vectors, frames and spectra
# ---------------------------------------------------------------------------

def sqrt(x):
    """The float32 square root, correctly rounded on any device."""
    return torch.sqrt(x.double()).float()


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    return v * (1.0 / sqrt(torch.clamp(dot(v, v), min=1e-30)))[..., None]


def duff_s(n):
    """Duff et al.'s first basis vector about the unit normal n (L, 3)."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    return torch.stack([1.0 + sign * nx * nx * a, sign * nx * ny * a, -sign * nx], -1)


def anchored(rgb, lam):
    """RGB (L, 3) at the channels' anchor wavelengths, straight lines between
    them, held beyond: -> (L, 4) at `lam`."""
    r, g, b = rgb[:, 0:1], rgb[:, 1:2], rgb[:, 2:3]
    t1 = torch.clamp((lam - ANCHORS[0]) / (ANCHORS[1] - ANCHORS[0]), 0.0, 1.0)
    t2 = torch.clamp((lam - ANCHORS[1]) / (ANCHORS[2] - ANCHORS[1]), 0.0, 1.0)
    return torch.where(lam < ANCHORS[1], b * (1.0 - t1) + g * t1, g * (1.0 - t2) + r * t2)


def radiance(light, lam):
    """Light `light`'s emitted spectrum at `lam` (L, 4)."""
    return pt.on_grid(light["curve"], lam) * pt.sigmoid_spectrum(light["coeff"], lam)


class Hit:
    """The surface point of each lane: position, geometric normal, shading
    frame (s, t, n), the direction back along the ray in that frame, the
    face, its material and emitter."""

    def __init__(self, scene, o, d, t, face):
        self.valid = face >= 0
        f = torch.clamp(face, min=0)
        self.face = f
        self.t = torch.where(self.valid, t, math.inf)
        self.p = torch.where(self.valid[:, None], o + d * torch.where(self.valid, t, 0.0)[:, None],
                             o)
        self.ng = torch.where(self.valid[:, None], scene.ng[f],
                              torch.tensor([0.0, 0.0, 1.0], device=o.device))
        q = self.p - scene.p0[f]
        b1, b2 = dot(scene.a1[f], q), dot(scene.a2[f], q)
        b0 = 1.0 - b1 - b2
        nv = scene.nv[f]
        n = normalize(nv[:, 0] * b0[:, None] + (nv[:, 1] * b1[:, None] + nv[:, 2] * b2[:, None]))
        tan = scene.tangent[f]
        s = tan - n * dot(n, tan)[:, None]
        s = normalize(torch.where((dot(s, s) < 1e-12)[:, None], duff_s(n), s))
        self.n, self.s = n, s
        self.tt = torch.linalg.cross(n, s, dim=-1)
        self.wi = self.local(-d)
        self.material = scene.material[f]
        self.emitter = torch.where(self.valid, scene.emitter[f], -1)

    def local(self, w):
        return torch.stack([dot(w, self.s), dot(w, self.tt), dot(w, self.n)], -1)

    def world(self, v):
        return self.s * v[:, 0:1] + self.tt * v[:, 1:2] + self.n * v[:, 2:3]

    def spawn_mint(self):
        return (1.0 + self.p.abs().amax(-1)) * pt.RAY_EPS


# ---------------------------------------------------------------------------
# the lights
# ---------------------------------------------------------------------------

def sample_lights(scene, p, ux, uy, lam):
    """Next-event estimation's sample from p (L, 3): the light by ux (uniform,
    the sample reused), its face by the area CDF on uy (reused), a point
    uniform in the face's area. -> (unit direction, distance, solid-angle
    pdf with the 1 / n selection, radiance over that pdf (L, 4)); pdf 0
    where the light faces away at the point."""
    n = len(scene.lights)
    index = torch.clamp((ux * n).to(torch.int64), max=n - 1)
    ux = (ux - index.to(torch.float32) / n) * n
    w = torch.zeros_like(p)
    dist = torch.zeros_like(ux)
    pdf = torch.zeros_like(ux)
    spec = torch.zeros((p.shape[0], 4), device=p.device)
    for e, light in enumerate(scene.lights):
        cdf = light["cdf"]
        k = torch.clamp(torch.searchsorted(cdf, uy), max=cdf.shape[0] - 1)
        lo = torch.where(k > 0, cdf[torch.clamp(k - 1, min=0)], 0.0)
        u2 = torch.clamp((uy - lo) / torch.clamp(cdf[k] - lo, min=1e-20), 0.0, 1.0 - 1e-7)
        f = light["faces"][k]
        r = sqrt(torch.clamp(1.0 - ux, min=1e-20))
        b1, b2 = 1.0 - r, r * u2
        q = scene.p0[f] + (scene.e1[f] * b1[:, None] + scene.e2[f] * b2[:, None])
        nv = scene.nv[f]
        b0 = 1.0 - b1 - b2
        nrm = normalize(nv[:, 0] * b0[:, None] + (nv[:, 1] * b1[:, None] + nv[:, 2] * b2[:, None]))
        v = q - p
        d2 = dot(v, v)
        dd = sqrt(d2)
        v = v * (1.0 / torch.clamp(dd, min=1e-20))[:, None]
        dn = dot(v, nrm)
        pe = torch.where(dn.abs() != 0.0,
                         (1.0 / max(light["area"], 1e-20)) * d2 / torch.clamp(dn.abs(), min=1e-20),
                         0.0)
        pe = torch.where(dn < 0.0, pe, 0.0)
        se = torch.where((pe > 0.0)[:, None],
                         radiance(light, lam) / torch.clamp(pe, min=1e-20)[:, None], 0.0)
        pick = index == e
        w = torch.where(pick[:, None], v, w)
        dist = torch.where(pick, dd, dist)
        pdf = torch.where(pick, pe, pdf)
        spec = torch.where(pick[:, None], se, spec)
    if n > 1:
        pdf = pdf * (1.0 / n)
        spec = spec * n
    return w, dist, pdf, spec


def light_pdf(scene, hit, d):
    """The solid-angle pdf with which `sample_lights` picks the point of a
    BSDF ray's hit on a light, by the face's geometric normal, with the
    1 / n selection; 0 where the hit is no light."""
    pdf = torch.zeros_like(hit.t)
    dp = dot(d, hit.ng).abs()
    for e, light in enumerate(scene.lights):
        pe = torch.where(dp != 0.0, (1.0 / max(light["area"], 1e-20)) * hit.t * hit.t
                         / torch.clamp(dp, min=1e-20), 0.0)
        pdf = torch.where(hit.emitter == e, pe, pdf)
    if len(scene.lights) > 1:
        pdf = pdf / len(scene.lights)
    return torch.where(hit.emitter >= 0, pdf, 0.0)


def emitted(scene, hit, lam):
    """The radiance a hit light sends back along the ray: from the side its
    shading normal faces; 0 where the hit is no light."""
    out = torch.zeros((hit.t.shape[0], 4), device=lam.device)
    front = hit.wi[:, 2] > 0.0
    for e, light in enumerate(scene.lights):
        out = torch.where(((hit.emitter == e) & front)[:, None], radiance(light, lam), out)
    return out


# ---------------------------------------------------------------------------
# the BSDFs: diffuse and Mitsuba's roughconductor (GGX, Smith)
# ---------------------------------------------------------------------------

def ggx_d(m, alpha):
    """The isotropic GGX distribution D(m), 0 below the horizon."""
    mz = m[:, 2]
    c2 = torch.clamp(mz * mz, min=1e-20)
    e = (m[:, 0] * m[:, 0] / (alpha * alpha) + m[:, 1] * m[:, 1] / (alpha * alpha)) / c2
    root = (1.0 + e) * c2
    d = 1.0 / (math.pi * alpha * alpha * root * root)
    return torch.where((mz > 0.0) & (d * mz > 1e-20), d, 0.0)


def smith_g1(v, m, alpha):
    """Smith's GGX masking of direction v for the normal m."""
    xy = (alpha * v[:, 0]) ** 2 + (alpha * v[:, 1]) ** 2
    tan2 = xy / torch.clamp(v[:, 2] ** 2, min=1e-20)
    g = 2.0 / (1.0 + sqrt(1.0 + tan2))
    g = torch.where(xy == 0.0, 1.0, g)
    return torch.where(dot(v, m) * v[:, 2] <= 0.0, 0.0, g)


def ggx_sample(u1, u2, alpha):
    """A normal drawn from D(m) cos(m) (Walter et al., 2007, the polar form):
    -> (m (L, 3), pdf)."""
    phi = torch.atan(torch.tan(math.pi + 2.0 * math.pi * u2)) + math.pi * torch.floor(
        2.0 * u2 + 0.5)
    sp_, cp = torch.sin(phi), torch.cos(phi)
    a2 = 1.0 / ((cp / alpha) ** 2 + (sp_ / alpha) ** 2)
    tan2 = a2 * u1 / torch.clamp(1.0 - u1, min=1e-20)
    ct = 1.0 / sqrt(1.0 + tan2)
    tmp = 1.0 + tan2 / a2
    pdf = (1.0 / math.pi) / (alpha * alpha * ct * ct * ct * tmp * tmp)
    pdf = torch.where(pdf < 1e-20, 0.0, pdf)
    st = sqrt(torch.clamp(1.0 - ct * ct, min=1e-20))
    return torch.stack([st * cp, st * sp_, ct], -1), pdf


def fresnel_conductor(c, eta, k):
    """The unpolarised Fresnel reflectance of a conductor eta + i k at the
    cosine c (L,), for eta, k (L, 4)."""
    c = c[:, None]
    c2 = c * c
    s2 = 1.0 - c2
    s4 = s2 * s2
    t1 = eta * eta - k * k - s2
    ab = sqrt(torch.clamp(t1 * t1 + 4.0 * k * k * eta * eta, min=1e-20))
    a = sqrt(torch.clamp(0.5 * (ab + t1), min=1e-20))
    t_1 = ab + c2
    t_2 = 2.0 * c * a
    rs = (t_1 - t_2) / torch.clamp(t_1 + t_2, min=1e-20)
    t_3 = ab * c2 + s4
    t_4 = t_2 * s2
    rp = rs * (t_3 - t_4) / torch.clamp(t_3 + t_4, min=1e-20)
    return 0.5 * (rs + rp)


class Surface:
    """The BSDF of each lane's hit at wavelengths `lam`."""

    def __init__(self, scene, hit, lam):
        m = hit.material
        self.conductor = scene.kind[m] == CONDUCTOR
        self.refl = pt.sigmoid_spectrum(scene.refl[m], lam)
        self.spec = pt.sigmoid_spectrum(scene.spec[m], lam)
        self.alpha = scene.alpha[m]
        self.eta = anchored(scene.eta[m], lam)
        self.k = anchored(scene.k[m], lam)

    def eval(self, wi, wo):
        """f cos(theta_o) (L, 4)."""
        ci, co = wi[:, 2], wo[:, 2]
        ok = (ci > 0.0) & (co > 0.0)
        diffuse = self.refl * (co / math.pi)[:, None]
        h = normalize(wi + wo)
        D = ggx_d(h, self.alpha)
        G = smith_g1(wi, h, self.alpha) * smith_g1(wo, h, self.alpha)
        glossy = (fresnel_conductor(dot(wi, h), self.eta, self.k) * self.spec
                  * (D * G / (4.0 * torch.clamp(ci, min=TINY)))[:, None])
        glossy = torch.where((D > 0.0)[:, None], glossy, 0.0)
        return torch.where(ok[:, None], torch.where(self.conductor[:, None], glossy, diffuse), 0.0)

    def pdf(self, wi, wo):
        """The solid-angle pdf with which `sample` draws wo."""
        ci, co = wi[:, 2], wo[:, 2]
        h = normalize(wi + wo)
        glossy = ggx_d(h, self.alpha) * h[:, 2] / (4.0 * torch.clamp(dot(wo, h), min=TINY))
        glossy = torch.where((dot(wi, h) > 0.0) & (dot(wo, h) > 0.0), glossy, 0.0)
        ok = (ci > 0.0) & (co > 0.0)
        return torch.where(ok, torch.where(self.conductor, glossy, co / math.pi), 0.0)

    def sample(self, wi, u1, u2):
        """-> (wo, pdf, weight f cos / pdf (L, 4), valid)."""
        ci = wi[:, 2]
        # diffuse: the cosine-weighted hemisphere
        wd = pt.cosine_direction(u1, u2)
        pd = wd[:, 2] / math.pi
        vd = (ci > 0.0) & (pd > 0.0)
        # conductor: a GGX normal, the mirror direction about it
        mv, pm = ggx_sample(u1, u2, self.alpha)
        wg = mv * (2.0 * dot(wi, mv))[:, None] - wi
        vg = (ci > 0.0) & (pm != 0.0) & (wg[:, 2] > 0.0)
        G = smith_g1(wi, mv, self.alpha) * smith_g1(wg, mv, self.alpha)
        ws = G * dot(wi, mv) / torch.clamp(ci * mv[:, 2], min=TINY)
        pg = pm / torch.clamp(4.0 * dot(wg, mv), min=TINY)
        weight_g = fresnel_conductor(dot(wi, mv), self.eta, self.k) * self.spec * ws[:, None]
        c = self.conductor
        wo = torch.where(c[:, None], wg, wd)
        valid = torch.where(c, vg, vd)
        pdf = torch.where(valid, torch.where(c, pg, pd), 0.0)
        weight = torch.where(valid[:, None], torch.where(c[:, None], weight_g, self.refl), 0.0)
        return wo, pdf, weight, valid


def mis(a, b):
    """The power-2 heuristic's weight of the technique with pdf a."""
    a2, b2 = a * a, b * b
    return torch.where(a2 > 0.0, a2 / torch.clamp(a2 + b2, min=F32_TINY), 0.0)


# ---------------------------------------------------------------------------
# the path tracer
# ---------------------------------------------------------------------------

@torch.no_grad()
def trace(scene, lane, seed):
    """Lanes `lane` (L,) int64 of the frame with `seed` -> (XYZ (L, 3), the
    film positions x, y (L,), the pixels (L,) int64)."""
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

    o, d, mint, maxt = pt.camera_rays(scene, x, y)
    hit = Hit(scene, o, d, *closest_hit(scene, o, d, mint, maxt))
    result = torch.where(hit.valid[:, None], emitted(scene, hit, lam), 0.0)
    beta = torch.ones_like(result)
    alive = hit.valid
    for depth in range(1, scene.max_depth):
        (ul1, ul2), st = pcg32.next_2d(st)
        u_lobe, st = pcg32.next_float32(st)
        (ub1, ub2), st = pcg32.next_2d(st)
        u_rr, st = pcg32.next_float32(st)
        bsdf = Surface(scene, hit, lam)

        # next-event estimation (both BSDFs are smooth)
        wl, dist, pdf_l, spec = sample_lights(scene, hit.p, ul1, ul2, lam)
        try_l = alive & (pdf_l > 0.0)
        blocked = occluded(scene, hit.p, wl, torch.where(try_l, hit.spawn_mint(), 0.0),
                           torch.where(try_l, dist * (1.0 - pt.SHADOW_EPS), -1.0))
        wo_l = hit.local(wl)
        f = bsdf.eval(hit.wi, wo_l)
        w = mis(pdf_l, bsdf.pdf(hit.wi, wo_l))
        result = result + torch.where((try_l & ~blocked)[:, None], beta * spec * f * w[:, None],
                                      0.0)

        # the BSDF's direction, and what it hits
        wo, pdf_b, weight, valid = bsdf.sample(hit.wi, ub1, ub2)
        dw = hit.world(wo)
        t2, f2 = closest_hit(scene, hit.p, dw, torch.where(alive, hit.spawn_mint(), 0.0),
                             torch.where(alive, math.inf, -1.0))
        nxt = Hit(scene, hit.p, dw, t2, f2)
        beta = beta * weight
        w = mis(pdf_b, light_pdf(scene, nxt, dw))
        seen = alive & nxt.valid & (nxt.emitter >= 0)
        result = result + torch.where(seen[:, None], beta * emitted(scene, nxt, lam) * w[:, None],
                                      0.0)
        alive = alive & valid & nxt.valid

        if depth + 1 >= scene.rr_depth:
            q = torch.clamp(beta.amax(-1), max=0.95)
            alive = alive & ~(u_rr >= q)
            beta = torch.where(alive[:, None], beta / torch.clamp(q, min=1e-8)[:, None], beta)
        hit = nxt
    return pt.to_xyz(result * lam_w, lam), x, y, pixel


@torch.no_grad()
def render_rows(scene, seed, y0, y1, chunk=1 << 20):
    """Rows [y0, y1) of the frame with `seed`, developed (rows, W, 3), as
    `path.render_rows` makes them: every sample the filter carries into
    them, from the rows within its reach."""
    r = pt.film_reach(scene)
    lanes = scene.width * scene.spp
    a, b = max(0, y0 - r) * lanes, min(scene.height, y1 + r) * lanes
    film = pt.new_film(scene)
    for c0 in range(a, b, chunk):
        lane = torch.arange(c0, min(c0 + chunk, b), dtype=torch.int64, device=scene.device)
        pt.splat(scene, film, *trace(scene, lane, seed))
    return pt.film_rgb(scene, film)[y0:y1]
