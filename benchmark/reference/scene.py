"""The scene as the reference reads it: the Mitsuba XML of a configuration,
parsed here, the Cornell box's quads, the colours lifted to spectra and the
camera's frame. Only what the benchmark's scenes use is read (a perspective
camera, diffuse surfaces, one area light, a gaussian or box film, the path
and sppm integrators); anything else raises, so a later configuration that
needs more brings its own reference code.

Spectra follow Jakob and Hanika's sigmoid model: a reflectance is
sigmoid(c0 lambda^2 + c1 lambda + c2), sigmoid(v) = 1/2 + v / (2 sqrt(1 +
v^2)). The coefficients of an sRGB colour solve, by Newton's method here,
"the spectrum lit by D65 and integrated against the CIE 1931 observer at
the 95 table wavelengths gives back the colour"; an emitter's sRGB radiance
is the colour over twice its largest channel, so lifted, times D65 scaled by
that factor.
"""

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import cie

# The Cornell box as measured (cornell.edu, millimetres): each mesh a list
# of quads, each quad split into the triangles (0, 1, 2) and (3, 0, 2).
CORNELL = {
    "cbox_floor": [
        [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2), (549.6, 0.0, 559.2)]],
    "cbox_ceiling": [
        [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2), (0.0, 548.8, 0.0)]],
    "cbox_back": [
        [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2), (556.0, 548.8, 559.2)]],
    "cbox_greenwall": [
        [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0), (0.0, 548.8, 559.2)]],
    "cbox_redwall": [
        [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2), (556.0, 548.8, 0.0)]],
    "cbox_luminaire": [
        [(343.0, 548.8, 227.0), (343.0, 548.8, 332.0), (213.0, 548.8, 332.0),
         (213.0, 548.8, 227.0)]],
    "cbox_smallbox": [
        [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0), (240.0, 165.0, 272.0), (290.0, 165.0, 114.0)],
        [(290.0, 0.0, 114.0), (290.0, 165.0, 114.0), (240.0, 165.0, 272.0), (240.0, 0.0, 272.0)],
        [(130.0, 0.0, 65.0), (130.0, 165.0, 65.0), (290.0, 165.0, 114.0), (290.0, 0.0, 114.0)],
        [(82.0, 0.0, 225.0), (82.0, 165.0, 225.0), (130.0, 165.0, 65.0), (130.0, 0.0, 65.0)],
        [(240.0, 0.0, 272.0), (240.0, 165.0, 272.0), (82.0, 165.0, 225.0), (82.0, 0.0, 225.0)]],
    "cbox_largebox": [
        [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0), (314.0, 330.0, 456.0), (472.0, 330.0, 406.0)],
        [(423.0, 0.0, 247.0), (423.0, 330.0, 247.0), (472.0, 330.0, 406.0), (472.0, 0.0, 406.0)],
        [(472.0, 0.0, 406.0), (472.0, 330.0, 406.0), (314.0, 330.0, 456.0), (314.0, 0.0, 456.0)],
        [(314.0, 0.0, 456.0), (314.0, 330.0, 456.0), (265.0, 330.0, 296.0), (265.0, 0.0, 296.0)],
        [(265.0, 0.0, 296.0), (265.0, 330.0, 296.0), (423.0, 330.0, 247.0), (423.0, 0.0, 247.0)]],
}

# linear sRGB (BT.709 primaries, D65 white) to CIE XYZ
SRGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                        [0.212671, 0.715160, 0.072169],
                        [0.019334, 0.119193, 0.950227]])


# ---------------------------------------------------------------------------
# the XML
# ---------------------------------------------------------------------------

def _numbers(text):
    return [float(v) for v in text.replace(",", " ").split()]


def _props(node):
    """The node's scalar properties: {name: value}."""
    out = {}
    for ch in node:
        name = ch.get("name")
        if ch.tag in ("float", "integer"):
            out[name] = float(ch.get("value"))
        elif ch.tag == "string":
            out[name] = ch.get("value")
        elif ch.tag == "rgb":
            out[name] = _numbers(ch.get("value"))
    return out


def _only(node, tags):
    for ch in node:
        if ch.tag not in tags:
            raise ValueError(f"the reference does not read <{ch.tag}> in <{node.tag}>")


def _to_world(node):
    """(translation, lookat) of a shape's or sensor's <transform>."""
    tr = node.find("transform")
    if tr is None:
        return np.zeros(3), None
    move, look = np.zeros(3), None
    for op in tr:
        if op.tag == "translate":
            move = move + np.array([float(op.get(k, 0.0)) for k in "xyz"])
        elif op.tag == "lookat":
            look = tuple(np.array(_numbers(op.get(k))) for k in ("origin", "target", "up"))
        else:
            raise ValueError(f"the reference does not read <{op.tag}> in a transform")
    return move, look


def read_xml(path):
    """The scene file as a plain description: {integrator, sensor, shapes}."""
    root = ET.parse(path).getroot()
    bsdfs = {}
    desc = {"shapes": []}
    for node in root:
        if node.tag == "integrator":
            desc["integrator"] = dict(_props(node), type=node.get("type"))
        elif node.tag == "sensor":
            if node.get("type") != "perspective":
                raise ValueError("the reference reads a perspective sensor only")
            film = node.find("film")
            rf = film.find("rfilter")
            _, look = _to_world(node)
            desc["sensor"] = {
                "fov": _props(node).get("fov", 30.0), "lookat": look,
                "near": _props(node).get("near_clip", 1e-2),
                "far": _props(node).get("far_clip", 1e4),
                "spp": _props(node.find("sampler")).get("sample_count", 4),
                "width": _props(film).get("width", 640), "height": _props(film).get("height", 320),
                "filter": rf.get("type") if rf is not None else "gaussian",
                "stddev": _props(rf).get("stddev", 0.5) if rf is not None else 0.5}
        elif node.tag == "bsdf":
            if node.get("type") != "diffuse":
                raise ValueError("the reference reads diffuse surfaces only")
            bsdfs[node.get("id")] = _props(node).get("reflectance", [0.5, 0.5, 0.5])
        elif node.tag == "shape":
            if node.get("type") != "obj":
                raise ValueError("the reference reads obj shapes only")
            _only(node, ("string", "transform", "ref", "emitter"))
            move, _ = _to_world(node)
            em = node.find("emitter")
            if em is not None and em.get("type") != "area":
                raise ValueError("the reference reads area emitters only")
            desc["shapes"].append({
                "mesh": Path(_props(node)["filename"]).stem, "move": move,
                "reflectance": bsdfs[node.find("ref").get("id")],
                "radiance": None if em is None else _props(em)["radiance"]})
        else:
            raise ValueError(f"the reference does not read <{node.tag}>")
    return desc


# ---------------------------------------------------------------------------
# colours to spectra
# ---------------------------------------------------------------------------

_GRID = np.linspace(cie.CIE_MIN, cie.CIE_MAX, cie.CIE_SAMPLES)
_CMF = np.stack([cie.CIE1931_X, cie.CIE1931_Y, cie.CIE1931_Z]).astype(np.float64)
_D65 = cie.D65_DATA.astype(np.float64)
# the colour of a spectrum s on the grid: XYZ_TO_SRGB @ _LIT @ s, white (s = 1) at Y = 1
_LIT = _D65 * _CMF / np.sum(_D65 * _CMF[1])
_XYZ_TO_SRGB = np.linalg.inv(SRGB_TO_XYZ)


def fit_sigmoid(rgb):
    """The nm-domain coefficients (c0, c1, c2) whose sigmoid spectrum gives
    back the linear sRGB colour `rgb`: Newton's method on the polynomial
    a x^2 + b x + c of x = (lambda - 360) / 470, started from the flat
    spectrum of the colour's luminance, each step halved until the residual
    falls."""
    rgb = np.clip(np.asarray(rgb, np.float64), 0.0, None)
    if rgb.max() < 1e-6:
        return np.array([0.0, 0.0, -1e4])
    x = (_GRID - cie.CIE_MIN) / (cie.CIE_MAX - cie.CIE_MIN)
    basis = np.stack([x * x, x, np.ones_like(x)])           # (3, 95)
    A = _XYZ_TO_SRGB @ _LIT                                  # (3, 95)

    def residual(p):
        v = p @ basis
        return A @ (0.5 + 0.5 * v / np.sqrt(1.0 + v * v)) - rgb

    y = float(np.clip(SRGB_TO_XYZ[1] @ rgb, 1e-4, 1.0 - 1e-4))
    p = np.array([0.0, 0.0, (y - 0.5) / np.sqrt(y * (1.0 - y))])
    r = residual(p)
    for _ in range(200):
        if np.abs(r).max() < 1e-15:
            break
        v = p @ basis
        J = A @ (basis * (0.5 * (1.0 + v * v) ** -1.5)).T     # (3, 3)
        step = np.linalg.solve(J, r)
        for _ in range(40):
            q = p - step
            rq = residual(q)
            if np.abs(rq).max() < np.abs(r).max():
                break
            step = step * 0.5
        else:
            break
        p, r = q, rq
    a, b, c = p
    span, lo = cie.CIE_MAX - cie.CIE_MIN, cie.CIE_MIN
    return np.array([a / span ** 2, b / span - 2.0 * lo * a / span ** 2,
                     a * lo ** 2 / span ** 2 - b * lo / span + c])


def emitter_spectrum(rgb):
    """An emitter's sRGB radiance -> (coefficients (3,), curve on the CIE
    grid (95,)): the colour over twice its largest channel, lifted, and D65
    times that factor."""
    rgb = np.asarray(rgb, np.float64)
    s = 2.0 * float(rgb.max())
    coeff = fit_sigmoid(rgb / s if s != 0.0 else rgb)
    return coeff, _D65 * cie.D65_TABLE_NORMALIZATION * s


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

@dataclass
class Scene:
    """Triangles (F, 3) float32: p0, e1, e2, unit normal n (of e1 x e2); the
    plane and dual-basis rows the casts use; each triangle's shape and
    whether it emits. `leaves` holds the differentiable parameters:
    materials (shapes, 3) (each shape's reflectance coefficients, a row per
    shape), rad_coeff (1, 3) and rad_curve (1, 95) (the light). The light's
    triangles with their area CDF; the camera; the film and the
    integrator's settings."""
    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    n: torch.Tensor
    cast_rows: torch.Tensor      # (3, 3F): [n | a1 | a2] columns, a1 . e1 = a2 . e2 = 1
    cast_off: torch.Tensor       # (3F,): n . p0, a1 . p0, a2 . p0
    shape: torch.Tensor          # (F,) int64
    emits: torch.Tensor          # (F,) bool
    leaves: dict
    light_faces: torch.Tensor    # (K,) int64
    light_cdf: torch.Tensor      # (K,) float32
    light_area: float
    cam_origin: torch.Tensor     # (3,)
    cam_rot: torch.Tensor        # (3, 3): camera to world, columns left, up, forward
    tan_half: float
    near: float
    far: float
    width: int
    height: int
    spp: int
    filter: str
    stddev: float
    integrator: str
    max_depth: int
    rr_depth: int
    photons: int
    iterations: int
    bsphere_radius: float
    device: torch.device


def load(path, width=None, height=None, spp=None, max_depth=None, device="cpu"):
    """The scene of XML `path`, with the configuration's overrides."""
    d = read_xml(path)
    integ, sen = d["integrator"], d["sensor"]
    if integ["type"] not in ("path", "sppm"):
        raise ValueError(f"the reference renders path and sppm, not {integ['type']}")
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)

    tris, shape_of, coeffs = [], [], []
    light = None
    for i, sh in enumerate(d["shapes"]):
        quads = np.asarray(CORNELL[sh["mesh"]], np.float64)
        # the quads of one mesh: (0, 1, 2) then (3, 0, 2), quad after quad
        mesh = np.stack([quads[:, [0, 1, 2]], quads[:, [3, 0, 2]]], axis=1).reshape(-1, 3, 3)
        mesh = (mesh + sh["move"]).astype(np.float32).astype(np.float64)
        tris.append(mesh)
        shape_of += [i] * len(mesh)
        coeffs.append(fit_sigmoid(sh["reflectance"]))
        if sh["radiance"] is not None:
            if light is not None:
                raise ValueError("the reference reads one area light")
            light = (i, sh["radiance"])
    P = np.concatenate(tris)                                   # (F, 3, 3)
    p0, e1, e2 = P[:, 0], P[:, 1] - P[:, 0], P[:, 2] - P[:, 0]
    e1, e2 = e1.astype(np.float32).astype(np.float64), e2.astype(np.float32).astype(np.float64)
    cr = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(cr, axis=1)
    n = cr / np.linalg.norm(cr, axis=1, keepdims=True)
    a1 = np.cross(e2, cr) / np.sum(cr * cr, axis=1, keepdims=True)
    a2 = np.cross(cr, e1) / np.sum(cr * cr, axis=1, keepdims=True)
    rows = np.concatenate([n, a1, a2])                         # (3F, 3)
    off = np.concatenate([np.sum(n * p0, 1), np.sum(a1 * p0, 1), np.sum(a2 * p0, 1)])
    shape = np.asarray(shape_of)

    li, rad = light
    faces = np.nonzero(shape == li)[0]
    cdf = np.cumsum(area[faces]) / area[faces].sum()
    rc, curve = emitter_spectrum(rad)

    W = int(width or sen["width"])
    H = int(height or sen["height"])
    origin, target, up = sen["lookat"]
    fwd = (target - origin) / np.linalg.norm(target - origin)
    left = np.cross(up / np.linalg.norm(up), fwd)
    left /= np.linalg.norm(left)
    cam_up = np.cross(fwd, left)
    cam_up /= np.linalg.norm(cam_up)

    lo, hi = P.reshape(-1, 3).min(0), P.reshape(-1, 3).max(0)
    radius = max(8.94e-5, float(np.linalg.norm(hi - 0.5 * (lo + hi))) * (1.0 + 8.94e-5))
    md = int(max_depth if max_depth is not None else integ.get("max_depth", -1))
    if md <= 0:
        raise ValueError("the reference renders a bounded depth (max_depth > 0)")

    def t(a):
        return torch.as_tensor(np.asarray(a), **f32)

    return Scene(
        p0=t(p0), e1=t(e1), e2=t(e2), n=t(n), cast_rows=t(rows.T).contiguous(), cast_off=t(off),
        shape=torch.as_tensor(shape, dtype=torch.int64, device=dev),
        emits=torch.as_tensor(shape == li, device=dev),
        leaves={"materials": t(coeffs), "rad_coeff": t(rc[None]), "rad_curve": t(curve[None])},
        light_faces=torch.as_tensor(faces, dtype=torch.int64, device=dev), light_cdf=t(cdf),
        light_area=float(np.float32(area[faces].sum())),
        cam_origin=t(origin), cam_rot=t(np.stack([left, cam_up, fwd], axis=1)),
        tan_half=float(np.tan(np.deg2rad(sen["fov"]) / 2.0)),
        near=float(sen["near"]), far=float(sen["far"]), width=W, height=H,
        spp=int(spp or sen["spp"]), filter=sen["filter"], stddev=float(sen["stddev"]),
        integrator=integ["type"], max_depth=md, rr_depth=int(integ.get("rr_depth", 5)),
        photons=int(integ.get("photons", 0)), iterations=int(integ.get("iterations", 1)),
        bsphere_radius=float(np.float32(radius)), device=dev)
