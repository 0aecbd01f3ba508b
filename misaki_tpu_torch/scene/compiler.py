"""Scene compiler: plugin-dict graph -> CompiledScene (tables of tensors).

The host side of `misaki_tpu.scene.compiler`, in NumPy, for the plugins this
port renders: obj / rectangle / sphere shapes; every BSDF of misaki_tpu
(diffuse, roughconductor, conductor, roughdielectric, dielectric,
roughplastic, disney / principled, null, and the twosided and mask
adapters) with plain, checkerboard or `bitmap` textures; `area`, `constant`,
`envmap` and `point` emitters; the perspective sensor with an `hdrfilm` or
`rgbfilm` and a box or gaussian filter; and the settings of the `path`,
`direct`, `debug`, `aov`, `volpath`, `sppm` and `photonmapper` integrators;
`homogeneous` media on a shape's interior or exterior, with a `constvolume`
or `gridvolume` density (`.vol` version 3 float32 or `.npy` grids). On those
scenes it produces the same arrays as the JAX compiler.

Three differences from the JAX compiler:
  * every scene gets the cluster accel (`accel/cluster.py`), built from the
    float32 geometry rows; there is no brute-force threshold and no BVH2;
  * the texture caps are the JAX compiler's paged-backend values, always
    (`BITMAP_MAX_RES`, `ENV_MAX_RES`, `ENV_RGB_MAX_RES`): a texel fetch here
    is a gather, which costs the same at any table size. There are no
    environment overrides and no pages;
  * a `sierpinski` shape (`<integer name="level">`, scene/procedural.py),
    which misaki_tpu has not, compiles to the tables that an OBJ of its
    vertices gives both compilers.
"""

from pathlib import Path

import numpy as np
import torch

from misaki_tpu_torch.accel.cluster import CLUSTER_FACES, build_clusters
from misaki_tpu_torch.core import microfacet
from misaki_tpu_torch.core import transform as tr
from misaki_tpu_torch.core.cie_data import CIE_MAX, CIE_MIN, D65_DATA, D65_TABLE_NORMALIZATION
from misaki_tpu_torch.core.srgb_upsample import fit_srgb_coeffs, srgb_model_mean
from misaki_tpu_torch.core.table import sigmoid_inverse
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.obj_loader import load_obj
from misaki_tpu_torch.scene.types import (
    bitmap_level_table,
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_NULL,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
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
    EM_ENVMAP,
    EM_POINT,
    EmitterTable,
    FC_BSDF,
    FC_E1,
    FC_E2,
    FC_EMITTER,
    FC_HAS_N,
    FC_HAS_UV,
    FC_MED_EXT,
    FC_MED_INT,
    FC_N0,
    FC_NG,
    FC_P0,
    FC_TANGENT,
    FC_UV0,
    Geometry,
    MASK_FLAG,
    MaterialTable,
    MC_ALPHA_U,
    MC_ALPHA_V,
    MC_DISTR,
    MC_DS_ANISO,
    MC_DS_CC_GLOSS,
    MC_DS_CLEARCOAT,
    MC_DS_METALLIC,
    MC_DS_SHEEN,
    MC_DS_SHEEN_TINT,
    MC_DS_SPEC_TINT,
    MC_DS_SPECULAR,
    MC_DS_SUBSURFACE,
    MC_ETA,
    MC_ETA_RGB,
    MC_FDR,
    MC_KIND,
    MC_K_RGB,
    MC_MASK,
    MC_NONLINEAR,
    MC_OPACITY,
    MC_REFL,
    MC_SPEC_REFL,
    MC_SPEC_TRANS,
    MC_SSW,
    MC_TWOSIDED,
    MED_HOMOGENEOUS,
    MediumTable,
    N_FACE_COLS,
    N_MAT_COLS,
    SCALAR_SLOT_COLS,
    SPEC_SLOT_COLS,
)

FACE_BLOCK = 128   # face padding multiple of the geometry rows
_CIE_GRID = np.linspace(CIE_MIN, CIE_MAX, 95)
_SIGMOID_ONE = 1e5  # sigmoid(1e5) == 1.0 in float32

# Texture caps: misaki_tpu's values on its paged backend.
BITMAP_MAX_RES = 1024             # bitmap base level, longest side
ENV_MAX_RES = (1024, 2048)        # envmap importance-sampling tables (H, W)
ENV_RGB_MAX_RES = (4096, 8192)    # envmap radiance texels (H, W)
_LUM = np.array([0.212671, 0.715160, 0.072169])

_BSDF_TYPES = {
    "diffuse", "roughconductor", "conductor", "roughdielectric",
    "dielectric", "null", "twosided", "roughplastic", "mask",
    "disney", "disney_brdf", "principled",
}
_SHAPE_TYPES = ("obj", "rectangle", "sphere", "sierpinski")
_INTEGRATOR_TYPES = {"path", "aov", "debug", "volpath", "direct",
                     "sppm", "photonmapper"}
_EMITTER_TYPES = {"constant": EM_CONSTANT, "envmap": EM_ENVMAP, "point": EM_POINT}
_DIST_MAP = {"beckmann": microfacet.BECKMANN, "ggx": microfacet.GGX}
# Disney's scalar parameters other than roughness, by slot
_DISNEY_SLOTS = (
    ("subsurface", MC_DS_SUBSURFACE), ("metallic", MC_DS_METALLIC),
    ("specular", MC_DS_SPECULAR), ("specular_tint", MC_DS_SPEC_TINT),
    ("anisotropic", MC_DS_ANISO), ("sheen", MC_DS_SHEEN),
    ("sheen_tint", MC_DS_SHEEN_TINT), ("clearcoat", MC_DS_CLEARCOAT),
    ("clearcoat_gloss", MC_DS_CC_GLOSS),
)


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


def spectral_slot(obj, name, default, bitmaps=None):
    """13-column spectral texture slot for property `name` of plugin `obj`
    (Properties::texture coercion semantics, properties.cpp:194-234).
    `bitmaps` (a _BitmapBuilder) loads the bitmap textures of a scene."""
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
        slot[0] = 2.0  # SLOT_BITMAP
        slot[1] = float(_load_bitmap(bitmaps, child))
        slot[7:13] = _uv_rows(child["props"].get("to_uv", tr.identity()))
        return slot
    slot[1:4] = _color_to_coeff(child)
    return slot


def scalar_slot(obj, name, default, bitmaps=None):
    """9-column scalar texture slot [mode, vA, vB, uvT(6)] for property
    `name` of plugin `obj` (roughness-like parameters)."""
    child = None
    for n, ch in obj["children"]:
        if n == name:
            child = ch
    slot = np.zeros(9)
    slot[3:9] = [1, 0, 0, 0, 1, 0]
    if child is None:
        slot[1] = slot[2] = float(obj["props"].get(name, default))
        return slot
    if child["type"] == "uniform":
        slot[1] = slot[2] = float(child["props"]["value"])
        return slot
    if child["type"] == "bitmap":
        slot[0] = 2.0  # SLOT_BITMAP
        slot[1] = float(_load_bitmap(bitmaps, child))
        slot[3:9] = _uv_rows(child["props"].get("to_uv", tr.identity()))
        return slot
    if child["type"] == "checkerboard":
        vals = {"color0": 0.4, "color1": 0.2}
        for n2, ch2 in child["children"]:
            if n2 in vals and ch2["type"] == "uniform":
                vals[n2] = float(ch2["props"]["value"])
        slot[0] = 1.0
        slot[1] = vals["color0"]
        slot[2] = vals["color1"]
        slot[3:9] = _uv_rows(child["props"].get("to_uv", tr.identity()))
        return slot
    raise ValueError(f"Unsupported scalar texture '{child['type']}'")


def _load_bitmap(bitmaps, child):
    if bitmaps is None:
        raise ValueError("bitmap texture outside a scene compile")
    return bitmaps.load(child["props"]["filename"])


# ---------------------------------------------------------------------------
# image files
# ---------------------------------------------------------------------------

def _read_rgbe_hdr(path):
    """Radiance .hdr (RGBE) reader -> (H, W, 3) float32 linear RGB, for the
    `-Y H +X W` orientation with flat or new-style RLE scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; the next line is the resolution
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("not a Radiance HDR file")
    res_end = data.find(b"\n", pos + 2)
    res = data[pos + 2: res_end].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res}")
    H, W = int(res[1]), int(res[3])
    buf = np.frombuffer(data[res_end + 1:], np.uint8)
    out = np.zeros((H, W, 4), np.uint8)
    p = 0
    for y in range(H):
        if p + 4 > len(buf):
            raise ValueError("truncated HDR scanline data")
        # new-style RLE header: (2, 2, hi, lo) with hi<<8|lo == W; a flat
        # scanline whose first pixel starts with (2, 2, ...) is told apart
        # by the width check
        is_rle = (
            8 <= W <= 0x7FFF
            and buf[p] == 2 and buf[p + 1] == 2
            and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == W
        )
        if not is_rle:
            if buf[p] == 1 and buf[p + 1] == 1 and buf[p + 2] == 1:
                raise ValueError("old-style RLE .hdr scanlines unsupported")
            if p + W * 4 > len(buf):
                raise ValueError("truncated HDR scanline data")
            out[y] = buf[p: p + W * 4].reshape(W, 4)
            p += W * 4
            continue
        p += 4  # scanline header
        for ch in range(4):
            x = 0
            while x < W:
                n = int(buf[p])
                p += 1
                if n > 128:  # run
                    out[y, x: x + n - 128, ch] = buf[p]
                    p += 1
                    x += n - 128
                else:  # literal
                    out[y, x: x + n, ch] = buf[p: p + n]
                    p += n
                    x += n
    mant = out[..., :3].astype(np.float32)
    exp = out[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return mant * scale[..., None]


def read_image_rgb(path):
    """Read an image file -> (H, W, 3) float32 *linear* RGB. `.hdr` files are
    decoded here; other formats need the imageio package. Integer images
    are sRGB-decoded, float images are linear."""
    path = Path(path)
    if path.suffix.lower() == ".hdr":
        return _read_rgbe_hdr(path)
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(f"reading '{path.suffix}' images needs the imageio package, "
                          f"which is not installed (.hdr files need nothing)") from e
    raw = np.asarray(iio.imread(str(path)))
    if raw.ndim == 2:
        raw = np.repeat(raw[..., None], 3, -1)
    raw = raw[..., :3]
    if raw.dtype == np.uint8:
        rgb = raw.astype(np.float32) / 255.0
        srgb_encoded = True
    elif raw.dtype == np.uint16:
        rgb = raw.astype(np.float32) / 65535.0
        srgb_encoded = True
    else:
        rgb = raw.astype(np.float32)
        srgb_encoded = False
    if srgb_encoded:
        rgb = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return np.ascontiguousarray(rgb, np.float32)


# ---------------------------------------------------------------------------
# bitmap textures (textures/bitmap.cpp) -> mip-chained linear-RGB table
# ---------------------------------------------------------------------------

def _box_down2(img):
    """2x box downsample with edge padding for odd dims."""
    H, W = img.shape[:2]
    if H % 2 or W % 2:
        img = np.pad(img, ((0, H % 2), (0, W % 2), (0, 0)), mode="edge")
    return img.reshape(img.shape[0] // 2, 2, img.shape[1] // 2, 2, 3).mean(axis=(1, 3))


class _BitmapBuilder:
    """Loads bitmap textures, builds their mip chains (base level cut to
    BITMAP_MAX_RES by 2x box steps) and packs them into one texel-major
    (Npad, 3) table plus the static metadata (scene/types.py `bitmaps`,
    `bitmap_meta`)."""

    def __init__(self, base_dir):
        self.base_dir = base_dir
        self.levels = []   # per texture: list of (H, W, 3) float32 levels
        self._cache = {}

    def load(self, filename):
        if filename in self._cache:
            return self._cache[filename]
        from misaki_tpu_torch.utils.fresolver import get_file_resolver

        path = get_file_resolver().resolve(filename, self.base_dir)
        try:
            rgb = read_image_rgb(path)
        except (OSError, ValueError) as e:
            raise ValueError(f"bitmap: cannot load '{filename}': {e}") from e
        rgb = np.asarray(rgb, np.float64)
        while max(rgb.shape[:2]) > BITMAP_MAX_RES:
            rgb = _box_down2(rgb)
        chain = [rgb.astype(np.float32)]
        while min(chain[-1].shape[:2]) > 1:
            chain.append(_box_down2(chain[-1]).astype(np.float32))
        tid = len(self.levels)
        self.levels.append(chain)
        self._cache[filename] = tid
        return tid

    def finalize(self):
        """-> (table (Npad, 3) float32, meta tuple)."""
        if not self.levels:
            return np.zeros((8, 3), np.float32), ()
        meta = []
        flat = []
        off = 0
        for chain in self.levels:
            lv = []
            for img in chain:
                H, W = img.shape[:2]
                flat.append(img.reshape(-1, 3))
                lv.append((off, W, H))
                off += H * W
            meta.append((chain[0].shape[1], chain[0].shape[0], tuple(lv)))
        texels = np.concatenate(flat, axis=0)
        npad = max(8, -(-len(texels) // 8) * 8)
        table = np.zeros((npad, 3), np.float32)
        table[: len(texels)] = texels
        return table, tuple(meta)


# ---------------------------------------------------------------------------
# envmap (emitters/envmap.cpp) -> radiance texels + importance tables
# ---------------------------------------------------------------------------

def _box_down(img, cap):
    """Box-average `img` by integer factors until it fits `cap` (H, W)."""
    h, w = img.shape[:2]
    fy = -(-h // cap[0])
    fx = -(-w // cap[1])
    if fy <= 1 and fx <= 1:
        return img
    py, px = (-h) % fy, (-w) % fx
    img = np.pad(img, ((0, py), (0, px), (0, 0)), mode="edge")
    return img.reshape(img.shape[0] // fy, fy, img.shape[1] // fx, fx, 3).mean(axis=(1, 3))


def _load_envmap(obj, base_dir, max_res=ENV_MAX_RES):
    """<emitter type="envmap"> -> (rgb (He, We, 3), pmf, marg_cdf, cond_cdf,
    to_world rotation, its inverse). The radiance texels keep their
    resolution up to ENV_RGB_MAX_RES; the luminance x sin(theta) sampling
    tables are built from a copy cut to `max_res`, and the pdf describes
    that coarser distribution (pmf > 0 everywhere), so NEE stays unbiased."""
    fname = obj["props"].get("filename")
    rgb = None
    if fname:
        # a missing or undecodable file raises (envmap.cpp:18-19)
        from misaki_tpu_torch.utils.fresolver import get_file_resolver

        path = get_file_resolver().resolve(fname, base_dir)
        try:
            rgb = read_image_rgb(path)
        except (OSError, ValueError) as e:
            raise ValueError(f"envmap: cannot load '{fname}': {e}") from e
    if rgb is None:
        rgb = np.full((1, 2, 3), 0.5, np.float32)
    rgb = rgb.astype(np.float64) * float(obj["props"].get("scale", 1.0))
    rgb_native = _box_down(rgb, ENV_RGB_MAX_RES)
    rgb = _box_down(rgb, max_res)
    He = rgb.shape[0]

    lum = rgb @ _LUM
    sin_t = np.sin((np.arange(He) + 0.5) / He * np.pi)
    w = np.maximum(lum, 0.0) * sin_t[:, None] + 1e-12
    pmf = w / w.sum()
    row_mass = pmf.sum(axis=1)
    marg_cdf = np.cumsum(row_mass)
    marg_cdf[-1] = 1.0
    cond_cdf = np.cumsum(pmf / row_mass[:, None], axis=1)
    cond_cdf[:, -1] = 1.0

    M = obj["props"].get("to_world")
    R = np.eye(3) if M is None else np.asarray(M, np.float64)[:3, :3]
    # strip scale so the inverse is a pure rotation
    norms = np.linalg.norm(R, axis=0)
    R = R / np.where(norms > 0, norms, 1.0)
    return (
        rgb_native.astype(np.float32),
        pmf.astype(np.float32),
        marg_cdf.astype(np.float32),
        cond_cdf.astype(np.float32),
        R.astype(np.float32),
        np.linalg.inv(R).astype(np.float32),
    )


def _read_volume_file(path):
    """Density grid reader: Mitsuba's binary .vol format (header 'VOL',
    version 3, encoding 1 (float32), xres / yres / zres, channels, bbox;
    x fastest) or a plain .npy of shape (D, H, W). Returns (data (D, H, W)
    float32, bbox_min (3,), bbox_max (3,)); a grid of several channels
    becomes their mean."""
    import struct

    if str(path).endswith(".npy"):
        data = np.load(path).astype(np.float32)
        if data.ndim != 3:
            raise ValueError(f"gridvolume npy must be 3-D, got {data.shape}")
        return data, np.zeros(3), np.ones(3)
    with open(path, "rb") as f:
        if f.read(3) != b"VOL":
            raise ValueError(f"{path}: not a .vol file")
        version = f.read(1)[0]
        if version != 3:
            raise ValueError(f"{path}: unsupported .vol version {version}")
        enc, xres, yres, zres, channels = struct.unpack("<iiiii", f.read(20))
        if enc != 1:
            raise ValueError(f"{path}: only float32 (.vol type 1) supported")
        bbox = struct.unpack("<6f", f.read(24))
        n = xres * yres * zres * channels
        data = np.frombuffer(f.read(4 * n), np.float32).reshape(zres, yres, xres, channels)
        data = data.mean(axis=-1) if channels > 1 else data[..., 0]
    return (data.astype(np.float32), np.asarray(bbox[:3], np.float64),
            np.asarray(bbox[3:], np.float64))


class _MediaBuilder:
    """Medium rows and the flat density-volume table
    (misaki_tpu/scene/compiler.py:968-1048, :1264-1312)."""

    def __init__(self, base_dir):
        self.base_dir = base_dir
        self.rows = []
        self.grids = []   # flat float32 arrays
        self.meta = []    # (offset, W, H, D, world_to_unit 12 floats)

    def compile(self, obj):
        """One `homogeneous` / `heterogeneous` plugin -> its medium id. The
        sigmoid spectrum model spans [0, 1] and extinction can exceed 1, so
        the colour is fitted normalised and its amplitude carried apart."""
        def rgb_of(name):
            for n, ch in obj["children"]:
                if n == name and "color" in ch["props"]:
                    return np.asarray(ch["props"]["color"], np.float64)
            return np.zeros(3)

        sigma_s, sigma_a = rgb_of("sigma_s"), rgb_of("sigma_a")
        s_amp = max(1.0, float(np.max(sigma_s)))
        a_amp = max(1.0, float(np.max(sigma_a)))
        # a `density` volume: constvolume folds its value into `scale`,
        # gridvolume registers a grid and the medium becomes heterogeneous
        scale = float(obj["props"].get("scale", 1.0))
        vol_idx = -1
        for n, ch in obj["children"]:
            if n != "density" or ch["type"] not in ("constvolume", "gridvolume"):
                continue
            if ch["type"] == "constvolume":
                scale *= float(ch["props"].get("value", 1.0))
            else:
                vol_idx = self.register_grid_volume(ch)
        self.rows.append({
            "kind": MED_HOMOGENEOUS, "sigma_s": sigma_s, "sigma_a": sigma_a,
            "sigma_s_coeff": fit_srgb_coeffs(sigma_s / s_amp),
            "sigma_a_coeff": fit_srgb_coeffs(sigma_a / a_amp),
            "sigma_s_amp": s_amp, "sigma_a_amp": a_amp, "scale": scale,
            "g": float(obj["props"].get("g", 0.0)), "density_vol": vol_idx,
        })
        return len(self.rows) - 1

    def register_grid_volume(self, ch):
        """gridvolume: a density grid mapped to world by an optional
        to_world (volume.h m_world_to_local + m_bbox) -> its volume id."""
        fname = ch["props"].get("filename")
        if fname is None:
            raise ValueError("gridvolume: a `filename` is required")
        from misaki_tpu_torch.utils.fresolver import get_file_resolver

        data, bbox_min, bbox_max = _read_volume_file(
            get_file_resolver().resolve(fname, self.base_dir))
        D, H, W = data.shape
        to_world = np.asarray(ch["props"].get("to_world", tr.identity()), np.float64)
        # world -> unit cube: inv(to_world), then the bbox normalisation
        norm = np.eye(4)
        ext = np.maximum(bbox_max - bbox_min, 1e-12)
        norm[:3, :3] = np.diag(1.0 / ext)
        norm[:3, 3] = -bbox_min / ext
        w2u = (norm @ np.linalg.inv(to_world))[:3, :].astype(np.float32)
        offset = sum(g.size for g in self.grids)
        self.grids.append(data.reshape(-1).astype(np.float32))
        self.meta.append((offset, W, H, D, tuple(float(x) for x in w2u.reshape(-1))))
        return len(self.meta) - 1

    def finalize(self):
        """-> (MediumTable, volumes (Npad,) float32, volume_meta)."""
        rows = self.rows

        def col(key, dtype, shape):
            if not rows:
                return np.zeros(shape, dtype)
            vals = [r[key] for r in rows]
            return (np.stack(vals) if shape[1:] else np.asarray(vals)).astype(dtype)

        media = MediumTable(
            kind=col("kind", np.int32, (0,)),
            sigma_s=col("sigma_s", np.float32, (0, 3)),
            sigma_a=col("sigma_a", np.float32, (0, 3)),
            sigma_s_coeff=col("sigma_s_coeff", np.float32, (0, 3)),
            sigma_a_coeff=col("sigma_a_coeff", np.float32, (0, 3)),
            sigma_s_amp=col("sigma_s_amp", np.float32, (0,)),
            sigma_a_amp=col("sigma_a_amp", np.float32, (0,)),
            scale=col("scale", np.float32, (0,)),
            g=col("g", np.float32, (0,)),
            density_vol=col("density_vol", np.int32, (0,)),
        )
        volumes = np.zeros(8, np.float32)
        if self.grids:
            flat = np.concatenate(self.grids)
            volumes = np.zeros(max(8, -(-flat.size // 128) * 128), np.float32)
            volumes[: flat.size] = flat
        return media, volumes, tuple(self.meta)


def _fresnel_diffuse_reflectance(eta):
    """fresnel.h:93-125 in float64: the Egan-Hilgeman (eta < 1) and
    d'Eon-Irving (eta >= 1) fits of the hemispherically integrated Fresnel
    reflectance."""
    eta = float(eta)
    if eta < 1.0:
        return -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / eta
    ie = 1.0 / eta
    return (0.919317 - 3.4793 * ie + 6.75335 * ie**2
            - 7.80989 * ie**3 + 4.98554 * ie**4 - 1.36881 * ie**5)


def _slot_mean(slot13):
    """Mean reflectance of a spectral slot (Texture::mean, which steers
    roughplastic's lobe choice): the sigmoid model's mean for a plain colour,
    the two colours' average for a checkerboard, and 0.5 for a bitmap, whose
    mean depends on its texels (the weight only steers sampling)."""
    if abs(slot13[0] - 2.0) < 0.25:
        return 0.5
    mA = float(srgb_model_mean(np.asarray(slot13[1:4])))
    if slot13[0] > 0.5:
        return 0.5 * (mA + float(srgb_model_mean(np.asarray(slot13[4:7]))))
    return mA


class _MaterialBuilder:
    """One packed row per BSDF plugin (misaki_tpu's layout). `twosided` and
    `mask` are adapters, flattened into a copy of their nested row with the
    twosided flag or the mask's opacity slot set."""

    def __init__(self, bitmaps=None):
        self.rows = []
        self._cache = {}
        self.bitmaps = bitmaps

    def _spectral(self, obj, name, default, row, base):
        row[base: base + SPEC_SLOT_COLS] = spectral_slot(obj, name, default, self.bitmaps)

    def _add(self, key, row):
        self.rows.append(row)
        self._cache[key] = len(self.rows) - 1
        return self._cache[key]

    def compile(self, obj):
        key = id(obj)
        if key in self._cache:
            return self._cache[key]
        t = obj["type"]
        p = obj["props"]
        if t == "twosided":
            nested = [ch for _, ch in obj["children"] if ch["type"] != "twosided"]
            if not nested:
                raise ValueError("twosided: a nested one-sided material is required")
            row = self.rows[self.compile(nested[0])].copy()
            row[MC_TWOSIDED] = 1.0
            return self._add(key, row)
        if t == "mask":
            # mask.cpp: an opacity texture over ONE nested BSDF; the kernels
            # make the null lobe from MC_MASK / MC_OPACITY
            nested = [ch for _, ch in obj["children"]
                      if ch["type"] in _BSDF_TYPES and ch["type"] != "mask"]
            if len(nested) != 1:
                raise ValueError("mask: exactly one nested BSDF required")
            row = self.rows[self.compile(nested[0])].copy()
            row[MC_MASK] = 1.0
            self._spectral(obj, "opacity", 0.5, row, MC_OPACITY)
            return self._add(key, row)

        row = np.zeros(N_MAT_COLS)
        row[MC_ETA] = 1.5
        row[MC_K_RGB: MC_K_RGB + 3] = 1.0
        row[MC_DISTR] = _DIST_MAP.get(p.get("distribution", "beckmann"), microfacet.BECKMANN)
        if t == "diffuse":
            row[MC_KIND] = BSDF_DIFFUSE
            self._spectral(obj, "reflectance", 0.5, row, MC_REFL)
        elif t in ("roughconductor", "conductor"):
            row[MC_KIND] = BSDF_ROUGH_CONDUCTOR if t == "roughconductor" else BSDF_CONDUCTOR
            self._spectral(obj, "specular_reflectance", 1.0, row, MC_SPEC_REFL)
            self._alphas(obj, p, row)
            row[MC_ETA_RGB: MC_ETA_RGB + 3], row[MC_K_RGB: MC_K_RGB + 3] = \
                self._conductor_ior(obj, p)
        elif t in ("roughdielectric", "dielectric"):
            row[MC_KIND] = BSDF_ROUGH_DIELECTRIC if t == "roughdielectric" else BSDF_DIELECTRIC
            self._spectral(obj, "specular_reflectance", 1.0, row, MC_SPEC_REFL)
            self._spectral(obj, "specular_transmittance", 1.0, row, MC_SPEC_TRANS)
            if t == "roughdielectric":
                self._alphas(obj, p, row)
            int_ior = 1.5046 if t == "roughdielectric" else 1.49
            row[MC_ETA] = float(p.get("int_ior", int_ior)) / float(p.get("ext_ior", 1.00028))
        elif t == "roughplastic":
            row[MC_KIND] = BSDF_PLASTIC
            self._spectral(obj, "diffuse_reflectance", 0.5, row, MC_REFL)
            self._spectral(obj, "specular_reflectance", 1.0, row, MC_SPEC_REFL)
            self._alphas(obj, p, row)
            eta = float(p.get("int_ior", 1.49)) / float(p.get("ext_ior", 1.00028))
            row[MC_ETA] = eta
            row[MC_NONLINEAR] = 1.0 if p.get("nonlinear", False) else 0.0
            row[MC_FDR] = _fresnel_diffuse_reflectance(eta)
            d_mean = _slot_mean(row[MC_REFL: MC_REFL + SPEC_SLOT_COLS])
            s_mean = _slot_mean(row[MC_SPEC_REFL: MC_SPEC_REFL + SPEC_SLOT_COLS])
            row[MC_SSW] = s_mean / max(d_mean + s_mean, 1e-9)
        elif t in ("disney", "disney_brdf", "principled"):
            # bsdfs/disney_brdf.cpp:12-27: eleven textured parameters, each
            # 0.5 by default. base_color takes the reflectance slot and
            # roughness both alpha slots (the kernel turns it into GGX
            # alphas); the other nine have slots of their own.
            row[MC_KIND] = BSDF_DISNEY
            self._spectral(obj, "base_color", 0.5, row, MC_REFL)
            r_slot = scalar_slot(obj, "roughness", 0.5, self.bitmaps)
            row[MC_ALPHA_U: MC_ALPHA_U + SCALAR_SLOT_COLS] = r_slot
            row[MC_ALPHA_V: MC_ALPHA_V + SCALAR_SLOT_COLS] = r_slot
            for name, base in _DISNEY_SLOTS:
                row[base: base + SCALAR_SLOT_COLS] = scalar_slot(obj, name, 0.5, self.bitmaps)
        elif t == "null":
            row[MC_KIND] = BSDF_NULL
        else:
            raise ValueError(f"Unsupported BSDF plugin '{t}'")
        return self._add(key, row)

    def _alphas(self, obj, p, row):
        """alpha_u / alpha_v where either is given, else `alpha` for both."""
        if "alpha_u" in p or any(n == "alpha_u" for n, _ in obj["children"]):
            names = ("alpha_u", "alpha_v")
        else:
            names = ("alpha", "alpha")
        for name, base in zip(names, (MC_ALPHA_U, MC_ALPHA_V)):
            row[base: base + SCALAR_SLOT_COLS] = scalar_slot(obj, name, 0.1, self.bitmaps)

    @staticmethod
    def _conductor_ior(obj, p):
        """(eta, k) RGB triples: the `eta` / `k` children's colours, or the
        properties; (0, 0, 0) and (1, 1, 1) by default."""
        eta, k = np.zeros(3), np.ones(3)
        for name, ch in obj["children"]:
            if name == "eta" and "color" in ch["props"]:
                eta = np.asarray(ch["props"]["color"], np.float64)
            if name == "k" and "color" in ch["props"]:
                k = np.asarray(ch["props"]["color"], np.float64)
        if "eta" in p:
            eta = np.asarray(p["eta"], np.float64)
        if "k" in p:
            k = np.asarray(p["k"], np.float64)
        return eta, k

    def finalize(self):
        if not self.rows:
            self.compile({"type": "diffuse", "props": {}, "children": []})
        B = len(self.rows)
        params = np.zeros((N_MAT_COLS, max(8, B)), np.float32)
        params[:, :B] = np.stack(self.rows, axis=-1)
        return MaterialTable(params=params)

    def kinds_present(self):
        """Sorted tuple of the BSDF kinds the rows use, with the MASK_FLAG
        pseudo-kind where a row is mask-wrapped: the kernels compute only
        these models."""
        if not self.rows:
            return (BSDF_DIFFUSE,)
        kinds = {int(r[MC_KIND]) for r in self.rows}
        if any(r[MC_MASK] > 0.5 for r in self.rows):
            kinds.add(MASK_FLAG)
        return tuple(sorted(kinds))

    def bitmap_slot_bases(self):
        """Static tuple of slot base columns that reference a bitmap."""
        bases = []
        for base in (MC_REFL, MC_SPEC_REFL, MC_SPEC_TRANS,
                     MC_ALPHA_U, MC_ALPHA_V, MC_OPACITY,
                     MC_DS_SUBSURFACE, MC_DS_METALLIC, MC_DS_SPECULAR,
                     MC_DS_SPEC_TINT, MC_DS_ANISO, MC_DS_SHEEN,
                     MC_DS_SHEEN_TINT, MC_DS_CLEARCOAT, MC_DS_CC_GLOSS):
            if any(abs(r[base] - 2.0) < 0.25 for r in self.rows):
                bases.append(base)
        return tuple(bases)


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
    if shape["type"] == "sierpinski":
        if "level" not in p:
            raise ValueError('a sierpinski shape needs <integer name="level">')
        return procedural.sierpinski(p["level"], to_world)
    # sphere
    radius = float(p.get("radius", 1.0))
    center = np.asarray(p.get("center", (0, 0, 0)), np.float64)
    m = procedural.sphere_standin(radius, center, sub=4)
    if to_world is not None:
        m = procedural._tris_mesh(m["positions"], m["normals"], m["uvs"], to_world)
    return m


def target_device(device, caller):
    """`device` as a torch.device; raises where it is CUDA and no CUDA
    device exists (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA device is available; pass device='cpu' "
                           "to build the scene for the CPU")
    return device


def compile_scene(desc, spp=None, width=None, height=None, max_depth=None, device="cuda"):
    """Lower a loaded scene description to a CompiledScene whose tables lie
    on `device`: the card unless the caller asks for the CPU. Raises where
    the device is CUDA and no CUDA device exists."""
    device = target_device(device, "compile_scene")
    base_dir = desc.get("base_dir", ".")
    bitmap_builder = _BitmapBuilder(base_dir)
    materials = _MaterialBuilder(bitmap_builder)

    # ---------------- integrator / sensor / film / sampler ----------------
    integ = _find_child(desc, _INTEGRATOR_TYPES) or {
        "type": "path", "props": {}, "children": [],
    }
    # the aov integrator nests a radiance integrator (aov.cpp renders its
    # channels beside the AOVs); without one it is volpath where the scene
    # has media and path otherwise (set once the shapes are read)
    aov_nested = None
    if integ["type"] == "aov":
        child = _find_child(integ, {"path", "volpath", "direct"})
        if child is not None:
            aov_nested = child["type"]
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

    # ---------------- shapes + geometry + area emitters + media ----------------
    media = _MediaBuilder(base_dir)
    shape_rows = []
    emitter_objs = []  # (kind, shape_idx, plugin)
    face_blocks = []
    for name, ch in desc["children"]:
        if ch["type"] in _SHAPE_TYPES:
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
            # one medium row per medium child, in the shape's order
            side = {"interior": -1, "exterior": -1}
            for n2, ch2 in ch["children"]:
                if ch2["type"] in ("homogeneous", "heterogeneous"):
                    mid = media.compile(ch2)
                    if n2 in side:
                        side[n2] = mid
            shape_rows.append({"bsdf": bsdf_idx, "emitter": emitter_idx, **side})
            face_blocks.append(mesh)
        elif ch["type"] in _EMITTER_TYPES:
            emitter_objs.append((_EMITTER_TYPES[ch["type"]], -1, ch))

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
    shape_interior = np.asarray([r["interior"] for r in shape_rows], np.int32)
    shape_exterior = np.asarray([r["exterior"] for r in shape_rows], np.int32)
    face_tab[FC_MED_INT, :F] = shape_interior[shape_idx] + 1  # 0 = none
    face_tab[FC_MED_EXT, :F] = shape_exterior[shape_idx] + 1

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
    # envmap table stubs, replaced when the scene has one
    env_rgb = np.full((1, 2, 3), 0.5, np.float32)
    env_pmf = np.full((1, 2), 0.5, np.float32)
    env_marg = np.ones(1, np.float32)
    env_cond = np.asarray([[0.5, 1.0]], np.float32)
    env_rot = np.eye(3, dtype=np.float32)
    env_rot_inv = np.eye(3, dtype=np.float32)
    for ei, (kind, s_idx, obj) in enumerate(emitter_objs):
        em_kind.append(kind)
        em_shape.append(s_idx)
        em_pos.append(np.asarray(obj["props"].get("position", (0, 0, 0)), np.float64))
        if kind == EM_ENVMAP:
            coeff, curve = np.array([0.0, 0.0, _SIGMOID_ONE]), np.ones(95)
            env_rgb, env_pmf, env_marg, env_cond, env_rot, env_rot_inv = (
                _load_envmap(obj, base_dir))
        else:
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
            if kind != EM_POINT:
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
        env_rgb=env_rgb,
        env_pmf=env_pmf,
        env_marg_cdf=env_marg,
        env_cond_cdf=env_cond,
        env_to_world=env_rot,
        env_to_local=env_rot_inv,
    )
    bitmap_table, bitmap_meta = bitmap_builder.finalize()
    media_table, volumes, volume_meta = media.finalize()
    if aov_nested is None:
        aov_nested = "volpath" if media.rows else "path"

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
        bitmaps=bitmap_table,
        bitmap_meta=bitmap_meta,
        bitmap_levels=bitmap_level_table(bitmap_meta),
        bitmap_slots=materials.bitmap_slot_bases(),
        aovs=tuple(ip["aovs"].split(",")) if ip.get("aovs") else (),
        aov_nested=aov_nested,
        direct_light_samples=int(ip.get("light_samples", 1)),
        direct_bsdf_samples=int(ip.get("bsdf_samples", 1)),
        # photon mapping (sppm.cpp:349-353, photonmapper.cpp:67-69):
        # `photon_count` is the photonmapper's name, `photons` the sppm one
        ppm_photons=int(ip.get("photon_count", ip.get("photons", 16384))),
        ppm_iterations=int(ip.get("iterations", 8)),
        ppm_radius=float(ip.get("initial_radius", ip.get("photon_radius", 0.0))),
        media=media_table,
        volumes=volumes,
        volume_meta=volume_meta,
    ).to(device)


def cluster_from_geometry(geom, n_faces):
    """The cluster accel over the first `n_faces` columns of the float32
    geometry rows, carrying the face table in cluster order."""
    rows = [np.asarray(g, np.float32)[:, :n_faces].T for g in (geom.p0, geom.e1, geom.e2)]
    return build_clusters(*rows, target=CLUSTER_FACES,
                          face_tab=np.asarray(geom.face_tab)[:, :n_faces])


def load_and_compile(path, params=None, device="cuda", **kw):
    """Load a scene file and compile it onto `device` (see compile_scene)."""
    from misaki_tpu_torch.scene.loader import load_file

    return compile_scene(load_file(path, params), device=device, **kw)
