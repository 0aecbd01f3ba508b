"""Scene compiler: plugin-dict graph -> CompiledScene (tables of tensors).

The host side of `misaki_tpu.scene.compiler`, in NumPy, for the subset of
plugins this port renders: obj / rectangle / sphere shapes, the `diffuse`
BSDF, `area` and `constant` emitters, the perspective sensor with an
`hdrfilm` or `rgbfilm` and a box or gaussian filter, and the `path`
integrator. On those scenes it produces the same arrays as the JAX compiler.
Plugins outside the subset raise NotImplementedError with their name.

Two differences from the JAX compiler:
  * every scene gets the cluster accel (`accel/cluster.py`), built from the
    float32 geometry rows; there is no brute-force threshold and no BVH2;
  * there are no backend-dependent texture caps (no bitmaps in the subset).
"""

from pathlib import Path

import numpy as np

from misaki_tpu_torch.accel.cluster import CLUSTER_FACES, build_clusters
from misaki_tpu_torch.core import transform as tr
from misaki_tpu_torch.core.cie_data import CIE_MAX, CIE_MIN, D65_DATA, D65_TABLE_NORMALIZATION
from misaki_tpu_torch.core.srgb_upsample import fit_srgb_coeffs
from misaki_tpu_torch.core.table import sigmoid_inverse
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.obj_loader import load_obj
from misaki_tpu_torch.scene.types import (
    BSDF_DIFFUSE,
    Camera,
    CompiledScene,
    EF_CDF_HI,
    EF_CDF_LO,
    EF_COLS,
    EF_E1,
    EF_E2,
    EF_HAS_N,
    EF_N0,
    EF_NG,
    EF_P0,
    EM_AREA,
    EM_CONSTANT,
    EmitterTable,
    FC_BSDF,
    FC_E1,
    FC_E2,
    FC_EMITTER,
    FC_HAS_N,
    FC_HAS_UV,
    FC_N0,
    FC_NG,
    FC_P0,
    FC_TANGENT,
    FC_UV0,
    Geometry,
    MaterialTable,
    MC_DISTR,
    MC_ETA,
    MC_KIND,
    MC_K_RGB,
    MC_REFL,
    N_FACE_COLS,
    N_MAT_COLS,
)

FACE_BLOCK = 128   # face padding multiple of the geometry rows
_CIE_GRID = np.linspace(CIE_MIN, CIE_MAX, 95)
_SIGMOID_ONE = 1e5  # sigmoid(1e5) == 1.0 in float32

_BSDF_TYPES = {
    "diffuse", "roughconductor", "conductor", "roughdielectric",
    "dielectric", "null", "twosided", "roughplastic", "mask",
    "disney", "disney_brdf", "principled",
}
_INTEGRATOR_TYPES = {"path", "aov", "debug", "volpath", "direct",
                     "sppm", "photonmapper"}


# ---------------------------------------------------------------------------
# texture slots
# ---------------------------------------------------------------------------

def _color_to_coeff(plugin):
    """srgb / uniform plugin -> sigmoid coefficient triple."""
    t = plugin["type"]
    p = plugin["props"]
    if t == "srgb":
        return fit_srgb_coeffs(np.asarray(p["color"], np.float64))
    if t == "uniform":
        return np.array([0.0, 0.0, float(sigmoid_inverse(p["value"]))])
    raise ValueError(f"Cannot encode texture '{t}' as a reflectance spectrum")


def _uv_rows(to_uv):
    m = np.asarray(to_uv, np.float64)
    return np.array([m[0, 0], m[0, 1], m[0, 3], m[1, 0], m[1, 1], m[1, 3]])


def spectral_slot(obj, name, default):
    """13-column spectral texture slot for property `name` of plugin `obj`
    (Properties::texture coercion semantics, properties.cpp:194-234)."""
    child = None
    for n, ch in obj["children"]:
        if n == name:
            child = ch
    slot = np.zeros(13)
    slot[7:13] = [1, 0, 0, 0, 1, 0]  # identity uv transform
    if child is None:
        v = obj["props"].get(name, default)
        slot[1:4] = [0.0, 0.0, float(sigmoid_inverse(v))]
        return slot
    if child["type"] == "checkerboard":
        c0 = c1 = None
        for n2, ch2 in child["children"]:
            if n2 == "color0":
                c0 = ch2
            if n2 == "color1":
                c1 = ch2
        # checkerboard.cpp defaults: color0=0.4, color1=0.2
        slot[0] = 1.0
        slot[1:4] = (_color_to_coeff(c0) if c0 is not None
                     else np.array([0.0, 0.0, sigmoid_inverse(0.4)]))
        slot[4:7] = (_color_to_coeff(c1) if c1 is not None
                     else np.array([0.0, 0.0, sigmoid_inverse(0.2)]))
        slot[7:13] = _uv_rows(child["props"].get("to_uv", tr.identity()))
        return slot
    if child["type"] == "bitmap":
        raise NotImplementedError("bitmap texture")
    slot[1:4] = _color_to_coeff(child)
    return slot


class _MaterialBuilder:
    """One packed row per BSDF plugin; this port compiles `diffuse` only."""

    def __init__(self):
        self.rows = []
        self._cache = {}

    def compile(self, obj):
        key = id(obj)
        if key in self._cache:
            return self._cache[key]
        if obj["type"] != "diffuse":
            raise NotImplementedError(f"BSDF '{obj['type']}'")
        row = np.zeros(N_MAT_COLS)
        row[MC_ETA] = 1.5
        row[MC_K_RGB : MC_K_RGB + 3] = 1.0
        row[MC_DISTR] = 0  # beckmann
        row[MC_KIND] = BSDF_DIFFUSE
        row[MC_REFL : MC_REFL + 13] = spectral_slot(obj, "reflectance", 0.5)
        idx = len(self.rows)
        self.rows.append(row)
        self._cache[key] = idx
        return idx

    def finalize(self):
        if not self.rows:
            self.compile({"type": "diffuse", "props": {}, "children": []})
        B = len(self.rows)
        params = np.zeros((N_MAT_COLS, max(8, B)), np.float32)
        params[:, :B] = np.stack(self.rows, axis=-1)
        return MaterialTable(params=params)

    def kinds_present(self):
        return tuple(sorted({int(r[MC_KIND]) for r in self.rows})) or (BSDF_DIFFUSE,)


# ---------------------------------------------------------------------------
# emitter radiance spectra -> (coeff, curve)
# ---------------------------------------------------------------------------

def _radiance_model(obj):
    """Emitter radiance plugin -> (sigmoid coeff (3,), curve (95,)).

    area.cpp / constant.cpp default: Texture::D65(1).
    """
    rad = None
    for n, ch in obj["children"]:
        if n in ("radiance", "intensity"):
            rad = ch
    one = np.array([0.0, 0.0, _SIGMOID_ONE])
    d65 = D65_DATA * D65_TABLE_NORMALIZATION
    if rad is None:
        return one, d65
    t = rad["type"]
    p = rad["props"]
    if t == "srgb_d65":
        # srgb_d65.cpp:15-40 — normalize by 2*max, fold into the d65 scale
        color = np.asarray(p["color"], np.float64)
        s = float(color.max()) * 2.0
        if s != 0.0:
            color = color / s
        coeff = fit_srgb_coeffs(color)
        return coeff, d65 * (float(p.get("scale", 1.0)) * s)
    if t == "d65":
        return one, d65 * float(p.get("scale", 1.0))
    if t == "uniform":
        return one, np.full(95, float(p["value"]))
    if t == "regular":
        values = np.asarray(p["values"], np.float64)
        src = np.linspace(p["lambda_min"], p["lambda_max"], len(values))
        curve = np.interp(_CIE_GRID, src, values, left=values[0], right=values[-1])
        return one, curve
    if t == "srgb":
        return fit_srgb_coeffs(np.asarray(p["color"], np.float64)), np.ones(95)
    raise ValueError(f"Unsupported emitter radiance '{t}'")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def _find_child(obj, type_names, name=None):
    for n, ch in obj["children"]:
        if ch["type"] in type_names and (name is None or n == name):
            return ch
    return None


def _load_mesh_for_shape(shape, base_dir):
    p = shape["props"]
    to_world = p.get("to_world", None)
    if shape["type"] == "obj":
        from misaki_tpu_torch.utils.fresolver import get_file_resolver

        fname = p["filename"]
        path = get_file_resolver().resolve(fname, base_dir)
        if path.exists():
            return load_obj(
                path, to_world, p.get("filp_tex_coords", p.get("flip_tex_coords", True))
            )
        mesh = procedural.get_procedural_mesh(Path(fname).name, to_world)
        if mesh is None:
            raise FileNotFoundError(
                f"Mesh '{fname}' not found and no procedural substitute exists"
            )
        return mesh
    if shape["type"] == "rectangle":
        return procedural.get_procedural_mesh("rectangle.obj", to_world)
    # sphere
    radius = float(p.get("radius", 1.0))
    center = np.asarray(p.get("center", (0, 0, 0)), np.float64)
    m = procedural.sphere_standin(radius, center, sub=4)
    if to_world is not None:
        m = procedural._tris_mesh(m["positions"], m["normals"], m["uvs"], to_world)
    return m


def compile_scene(desc, spp=None, width=None, height=None, max_depth=None):
    """Lower a loaded scene description to a CompiledScene (tables on CPU;
    `.to(device)` moves them)."""
    base_dir = desc.get("base_dir", ".")
    materials = _MaterialBuilder()

    # ---------------- integrator / sensor / film / sampler ----------------
    integ = _find_child(desc, _INTEGRATOR_TYPES) or {
        "type": "path", "props": {}, "children": [],
    }
    sensor = _find_child(desc, {"perspective"})
    if sensor is None:
        raise ValueError("Scene needs a perspective sensor")
    sp = sensor["props"]
    film = _find_child(sensor, {"hdrfilm", "rgbfilm"}) or {
        "type": "hdrfilm", "props": {}, "children": [],
    }
    sampler = _find_child(sensor, {"independent"}) or {
        "type": "independent", "props": {}, "children": [],
    }
    W = int(width or film["props"].get("width", 640))
    H = int(height or film["props"].get("height", 320))
    # crop window (film.cpp:14-21), in the film's declared pixel space and
    # rescaled with width/height overrides
    W_prop = max(int(film["props"].get("width", 640)), 1)
    H_prop = max(int(film["props"].get("height", 320)), 1)
    fx, fy = W / W_prop, H / H_prop
    crop_x = int(round(int(film["props"].get("crop_offset_x", 0)) * fx))
    crop_y = int(round(int(film["props"].get("crop_offset_y", 0)) * fy))
    crop_w = max(int(round(int(film["props"].get("crop_width", W_prop)) * fx)), 1)
    crop_h = max(int(round(int(film["props"].get("crop_height", H_prop)) * fy)), 1)
    crop_x = min(max(crop_x, 0), W - 1)
    crop_y = min(max(crop_y, 0), H - 1)
    crop_w = min(crop_w, W - crop_x)
    crop_h = min(crop_h, H - crop_y)
    n_spp = int(spp or sampler["props"].get("sample_count", 4))
    rfilter = _find_child(film, {"gaussian", "box"})
    filter_type = rfilter["type"] if rfilter else "gaussian"
    filter_stddev = float(rfilter["props"].get("stddev", 0.5)) if rfilter else 0.5

    fov = float(sp.get("fov", 30.0))
    near = float(sp.get("near_clip", 1e-2))
    far = float(sp.get("far_clip", 1e4))
    cam_to_world = np.asarray(sp.get("to_world", tr.identity()), np.float64)
    c2s = tr.camera_to_sample(W, H, fov, near, far)
    camera = Camera(
        to_world=cam_to_world.astype(np.float32),
        sample_to_camera=np.linalg.inv(c2s).astype(np.float32),
        near=np.float32(near),
        far=np.float32(far),
    )

    # ---------------- shapes + geometry + area emitters ----------------
    shape_rows = []
    emitter_objs = []  # (kind, shape_idx, plugin)
    face_blocks = []
    for name, ch in desc["children"]:
        if ch["type"] in ("obj", "rectangle", "sphere"):
            for n2, ch2 in ch["children"]:
                if ch2["type"] in ("homogeneous", "heterogeneous"):
                    raise NotImplementedError(f"medium '{ch2['type']}'")
            mesh = _load_mesh_for_shape(ch, base_dir)
            bsdf_obj = _find_child(ch, _BSDF_TYPES) or {
                "type": "diffuse", "props": {}, "children": [],
            }
            bsdf_idx = materials.compile(bsdf_obj)
            em = _find_child(ch, {"area"})
            emitter_idx = -1
            if em is not None:
                emitter_idx = len(emitter_objs)
                emitter_objs.append((EM_AREA, len(shape_rows), em))
            shape_rows.append({"bsdf": bsdf_idx, "emitter": emitter_idx})
            face_blocks.append(mesh)
        elif ch["type"] == "constant":
            emitter_objs.append((EM_CONSTANT, -1, ch))
        elif ch["type"] in ("envmap", "point"):
            raise NotImplementedError(f"emitter '{ch['type']}'")

    if not face_blocks:
        raise ValueError("Scene has no shapes")

    P = np.concatenate([b["positions"] for b in face_blocks], axis=0).astype(np.float64)
    Nrm = np.concatenate([b["normals"] for b in face_blocks], axis=0).astype(np.float64)
    UV = np.concatenate([b["uvs"] for b in face_blocks], axis=0).astype(np.float64)
    shape_idx = np.concatenate(
        [np.full(len(b["positions"]), i, np.int32) for i, b in enumerate(face_blocks)]
    )
    has_n = np.concatenate(
        [np.full(len(b["positions"]), b["has_normals"], bool) for b in face_blocks]
    )
    has_uv = np.concatenate(
        [np.full(len(b["positions"]), b["has_uvs"], bool) for b in face_blocks]
    )
    F = len(P)
    p0 = P[:, 0]
    e1 = P[:, 1] - P[:, 0]
    e2 = P[:, 2] - P[:, 0]
    Fpad = max(FACE_BLOCK, -(-F // FACE_BLOCK) * FACE_BLOCK)

    def comp_rows(a):
        out = np.zeros((3, Fpad), np.float32)
        out[:, :F] = a.T
        return out

    # geometric normal + raw dp_du tangent (mesh.cpp:62-79)
    ng = np.cross(e1, e2)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    duv1 = UV[:, 1] - UV[:, 0]
    duv2 = UV[:, 2] - UV[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    inv_det = np.where(det != 0.0, 1.0 / np.where(det == 0.0, 1.0, det), 0.0)
    dp_du_uv = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_det[:, None]
    # canonical ONB fallback (coordinate_system on ng)
    sign = np.where(ng[:, 2] >= 0.0, 1.0, -1.0)
    a_ = -1.0 / (sign + ng[:, 2])
    b_ = ng[:, 0] * ng[:, 1] * a_
    s_canon = np.stack(
        [1.0 + sign * ng[:, 0] ** 2 * a_, sign * b_, -sign * ng[:, 0]], -1
    )
    use_uv = has_uv & (det != 0.0)
    tangent = np.where(use_uv[:, None], dp_du_uv, s_canon)

    shape_bsdf = np.asarray([r["bsdf"] for r in shape_rows], np.int32)
    shape_emitter = np.asarray([r["emitter"] for r in shape_rows], np.int32)

    face_tab = np.zeros((N_FACE_COLS, Fpad), np.float32)
    face_tab[FC_NG : FC_NG + 3, :F] = ng.T
    face_tab[FC_TANGENT : FC_TANGENT + 3, :F] = tangent.T
    face_tab[FC_N0 : FC_N0 + 9, :F] = Nrm.reshape(F, 9).T
    face_tab[FC_UV0 : FC_UV0 + 6, :F] = UV.reshape(F, 6).T
    face_tab[FC_BSDF, :F] = shape_bsdf[shape_idx]
    face_tab[FC_EMITTER, :F] = shape_emitter[shape_idx] + 1  # 0 = none
    face_tab[FC_HAS_N, :F] = has_n
    face_tab[FC_HAS_UV, :F] = has_uv
    face_tab[FC_E1 : FC_E1 + 3, :F] = e1.T
    face_tab[FC_E2 : FC_E2 + 3, :F] = e2.T
    face_tab[FC_P0 : FC_P0 + 3, :F] = p0.T
    # FC_MED_INT / FC_MED_EXT stay 0: no media in this port's subset

    geom = Geometry(
        p0=comp_rows(p0), e1=comp_rows(e1), e2=comp_rows(e2), face_tab=face_tab
    )

    # scene bbox -> bounding sphere (constant.cpp set_scene)
    lo = P.reshape(-1, 3).min(axis=0)
    hi = P.reshape(-1, 3).max(axis=0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - center))
    radius = max(8.94e-5, radius * (1.0 + 8.94e-5))

    # ---------------- emitters ----------------
    face_area = 0.5 * np.linalg.norm(np.cross(e2, e1), axis=-1)
    em_kind, em_shape, em_pos = [], [], []
    em_coeff, em_curve = [], []
    em_face_global, em_face_cdf, em_area = [], [], []
    env_idx = -1
    for ei, (kind, s_idx, obj) in enumerate(emitter_objs):
        em_kind.append(kind)
        em_shape.append(s_idx)
        em_pos.append(np.asarray(obj["props"].get("position", (0, 0, 0)), np.float64))
        coeff, curve = _radiance_model(obj)
        em_coeff.append(coeff)
        em_curve.append(curve)
        if kind == EM_AREA:
            fidx = np.nonzero(shape_idx == s_idx)[0]
            areas = face_area[fidx]
            total = float(areas.sum())
            cdf = np.cumsum(areas) / max(total, 1e-30)
            em_face_global.append(fidx.astype(np.int32))
            em_face_cdf.append(cdf.astype(np.float32))
            em_area.append(total)
        else:
            em_face_global.append(np.zeros(1, np.int32))
            em_face_cdf.append(np.ones(1, np.float32))
            em_area.append(4.0 * np.pi * radius * radius)
            env_idx = ei

    n_emitters = len(em_kind)
    fmax = max([len(f) for f in em_face_global], default=1)
    fg_pad = np.zeros((max(n_emitters, 1), fmax), np.int32)
    fc_pad = np.ones((max(n_emitters, 1), fmax), np.float32)
    for i, (fg, fc) in enumerate(zip(em_face_global, em_face_cdf)):
        fg_pad[i, : len(fg)] = fg
        fg_pad[i, len(fg):] = fg[-1] if len(fg) else 0
        fc_pad[i, : len(fc)] = fc

    # compact per-emitter face pack for NEE area sampling: bracketing CDF
    # values + the face columns the sampler needs
    fp_pad = np.zeros((max(n_emitters, 1), EF_COLS, fmax), np.float32)
    fp_pad[:, EF_CDF_HI, :] = 1.0
    for i, (fg, fc) in enumerate(zip(em_face_global, em_face_cdf)):
        nf = len(fg)
        fp_pad[i, EF_CDF_LO, 1:nf] = fc[:-1]
        fp_pad[i, EF_CDF_HI, :nf] = fc
        fp_pad[i, EF_P0:EF_P0 + 3, :nf] = face_tab[FC_P0:FC_P0 + 3, fg]
        fp_pad[i, EF_E1:EF_E1 + 3, :nf] = face_tab[FC_E1:FC_E1 + 3, fg]
        fp_pad[i, EF_E2:EF_E2 + 3, :nf] = face_tab[FC_E2:FC_E2 + 3, fg]
        fp_pad[i, EF_NG:EF_NG + 3, :nf] = face_tab[FC_NG:FC_NG + 3, fg]
        fp_pad[i, EF_N0:EF_N0 + 9, :nf] = face_tab[FC_N0:FC_N0 + 9, fg]
        fp_pad[i, EF_HAS_N, :nf] = face_tab[FC_HAS_N, fg]

    def stack_or(rows, shape):
        return np.stack(rows).astype(np.float32) if rows else np.zeros(shape, np.float32)

    emitters = EmitterTable(
        kind=np.asarray(em_kind, np.int32).reshape(-1),
        shape=np.asarray(em_shape, np.int32).reshape(-1),
        rad_coeff=stack_or(em_coeff, (0, 3)),
        rad_curve=stack_or(em_curve, (0, 95)),
        position=stack_or(em_pos, (0, 3)),
        face_global=fg_pad,
        face_cdf=fc_pad,
        face_pack=fp_pad,
        area=np.asarray(em_area, np.float32).reshape(-1),
        bsphere_center=center.astype(np.float32),
        bsphere_radius=np.float32(radius),
    )

    ip = integ["props"]
    return CompiledScene(
        geometry=geom,
        cluster=cluster_from_geometry(geom, F),
        materials=materials.finalize(),
        emitters=emitters,
        camera=camera,
        shape_bsdf=shape_bsdf,
        shape_emitter=shape_emitter,
        film_width=crop_w,
        film_height=crop_h,
        crop_x=crop_x,
        crop_y=crop_y,
        spp=n_spp,
        max_depth=int(max_depth if max_depth is not None else ip.get("max_depth", -1)),
        rr_depth=int(ip.get("rr_depth", 5)),
        hide_emitters=bool(ip.get("hide_emitters", False)),
        integrator=integ["type"],
        filter_type=filter_type,
        filter_stddev=filter_stddev,
        film_format=film["type"],
        n_faces=F,
        n_shapes=len(shape_rows),
        n_emitters=n_emitters,
        has_environment=env_idx >= 0,
        environment_idx=env_idx,
        emitter_kinds=tuple(int(k) for k in em_kind),
        bsdf_kinds=materials.kinds_present(),
    ).to("cpu")


def cluster_from_geometry(geom, n_faces):
    """The cluster accel over the first `n_faces` columns of the float32
    geometry rows, carrying the face table in cluster order."""
    rows = [np.asarray(g, np.float32)[:, :n_faces].T for g in (geom.p0, geom.e1, geom.e2)]
    return build_clusters(*rows, target=CLUSTER_FACES,
                          face_tab=np.asarray(geom.face_tab)[:, :n_faces])


def load_and_compile(path, params=None, **kw):
    from misaki_tpu_torch.scene.loader import load_file

    return compile_scene(load_file(path, params), **kw)
