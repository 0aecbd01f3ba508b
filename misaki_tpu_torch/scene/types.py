"""Compiled scene representation: dataclasses of tensors + static metadata.

The same tables as `misaki_tpu.scene.types`, with the same packed column
layouts, so a scene compiled by either package holds the same numbers. Each
table dataclass carries its tensors on one device; `CompiledScene.to(device)`
moves them all.
"""

from dataclasses import dataclass, field, fields, replace
from typing import Any

import numpy as np
import torch

# BSDF kinds
BSDF_DIFFUSE = 0
BSDF_ROUGH_CONDUCTOR = 1
BSDF_ROUGH_DIELECTRIC = 2
BSDF_DIELECTRIC = 3
BSDF_CONDUCTOR = 4
BSDF_NULL = 5
BSDF_PLASTIC = 6
BSDF_DISNEY = 7

# Emitter kinds
EM_AREA = 0
EM_CONSTANT = 1
EM_POINT = 2
EM_ENVMAP = 3

# ---- packed face-table column indices (Geometry.face_tab rows) ----
FC_NG = 0          # 0-2  geometric normal
FC_TANGENT = 3     # 3-5  raw dp_du (UV-derived or canonical ONB fallback)
FC_N0 = 6          # 6-14 vertex shading normals n0, n1, n2
FC_UV0 = 15        # 15-20 vertex texcoords uv0, uv1, uv2
FC_BSDF = 21       # material id (float-encoded int)
FC_EMITTER = 22    # emitter id + 1 (0 = none)
FC_HAS_N = 23      # 0/1
FC_HAS_UV = 24     # 0/1
FC_E1 = 25         # 25-27 edge1
FC_E2 = 28         # 28-30 edge2
FC_P0 = 31         # 31-33 first vertex
FC_MED_INT = 34    # interior medium id + 1 (0 = none)
FC_MED_EXT = 35    # exterior medium id + 1 (0 = none)
N_FACE_COLS = 36

# ---- packed material-table column indices (MaterialTable.params rows) ----
# A "spectral slot" is 13 columns [mode, cA(3), cB(3), uvT(2x3)]; a "scalar
# slot" is 9 columns [mode, vA, vB, uvT(2x3)].
MC_KIND = 0
MC_TWOSIDED = 1
MC_DISTR = 2
MC_ETA = 3
MC_ETA_RGB = 4     # 4-6
MC_K_RGB = 7       # 7-9
MC_REFL = 10       # 10-22 spectral slot: reflectance
MC_SPEC_REFL = 23  # 23-35 spectral slot: specular reflectance
MC_SPEC_TRANS = 36  # 36-48 spectral slot: specular transmittance
MC_ALPHA_U = 49    # 49-57 scalar slot
MC_ALPHA_V = 58    # 58-66 scalar slot
MC_SSW = 67
MC_NONLINEAR = 68
MC_FDR = 69
MC_MASK = 70
MC_OPACITY = 71    # 71-83 spectral slot: opacity
MC_DS_SUBSURFACE = 84
MC_DS_METALLIC = 93
MC_DS_SPECULAR = 102
MC_DS_SPEC_TINT = 111
MC_DS_ANISO = 120
MC_DS_SHEEN = 129
MC_DS_SHEEN_TINT = 138
MC_DS_CLEARCOAT = 147
MC_DS_CC_GLOSS = 156
N_MAT_COLS = 165

MASK_FLAG = 100

SPEC_SLOT_COLS = 13
SCALAR_SLOT_COLS = 9

# ---- compact per-emitter face-pack columns (EmitterTable.face_pack) ----
EF_CDF_LO = 0
EF_CDF_HI = 1
EF_P0 = 2          # 2-4
EF_E1 = 5          # 5-7
EF_E2 = 8          # 8-10
EF_NG = 11         # 11-13
EF_N0 = 14         # 14-22 vertex shading normals
EF_HAS_N = 23
EF_COLS = 24


def _to(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(value), device=device)
    return value


def bitmap_level_table(meta):
    """The (T, most levels, 3) int32 table of each texture's levels'
    (offset, W, H) from the static `bitmap_meta`."""
    table = np.zeros((len(meta), max((len(m[2]) for m in meta), default=1), 3), np.int32)
    for t, (_, _, levels) in enumerate(meta):
        table[t, :len(levels)] = levels
    return table


class _Tables:
    """Dataclass mixin: tensor fields move together with `.to(device)`;
    other fields (static metadata) are kept."""

    def to(self, device):
        kw = {}
        for f in fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if isinstance(v, _Tables) else _to(v, device)
        return replace(self, **kw)


@dataclass(frozen=True)
class Geometry(_Tables):
    """All triangles of all shapes, world-space component rows (lane-last),
    padded to a multiple of 128 faces."""

    p0: Any        # (3, Fpad) float32
    e1: Any        # (3, Fpad)
    e2: Any        # (3, Fpad)
    face_tab: Any  # (N_FACE_COLS, Fpad) float32


@dataclass(frozen=True)
class ClusterAccel(_Tables):
    """Cluster-BVH tables (accel/cluster.py build_clusters). `bounds`, `tri`
    and `tab` are misaki_tpu's cluster tables (the plain twins walk them);
    `nodes` and `leaf_tri` are the BVH2 the CUDA kernels traverse."""

    bounds: Any    # (8, Cpad) f32 rows [lo(3) hi(3) 0 0]; pads +inf/-inf
    tri: Any       # (C, B, 10) f32 cols [p0(3) e1(3) e2(3) fid]; pad fid -1
    tab: Any       # (C, T, B) f32 — face_tab columns in cluster order
    # (N, 16) f32, one 64-byte node per row: [c0 lo.x hi.x lo.y hi.y |
    # c1 lo.x hi.x lo.y hi.y | c0 lo.z hi.z, c1 lo.z hi.z | ref0 ref1 s 0],
    # the refs int32 bits: >= 0 an inner node, < 0 a leaf ~(start*8 + count);
    # s, on node 0 only: the largest |vertex coordinate| (0 elsewhere)
    nodes: Any
    # (F, 12) f32, the faces in leaf order: [p0 fid | e1 cluster | e2 slot],
    # cluster and slot as int32 bits (the face's column of `tab`)
    leaf_tri: Any
    n_clusters: int = 0


@dataclass(frozen=True)
class MaterialTable(_Tables):
    params: Any    # (N_MAT_COLS, Bpad) float32 — differentiable leaf


@dataclass(frozen=True)
class EmitterTable(_Tables):
    kind: Any           # (E,) int32
    shape: Any          # (E,) int32 — owning shape for area lights (-1 else)
    rad_coeff: Any      # (E, 3) float32 — sigmoid coefficients (nm domain)
    rad_curve: Any      # (E, 95) float32 — curve on the CIE grid
    position: Any       # (E, 3) float32
    face_global: Any    # (E, Fmax) int32
    face_cdf: Any       # (E, Fmax) float32
    face_pack: Any      # (E, EF_COLS, Fmax) float32
    area: Any           # (E,) float32
    bsphere_center: Any  # (3,) float32
    bsphere_radius: Any  # () float32
    # Environment map (lat-long HDR, 2D luminance x sin(theta) importance
    # tables). At most one per scene; scenes without one carry small stubs.
    # The radiance texels may be finer than the sampling tables.
    env_rgb: Any        # (He, We, 3) float32 — scaled linear RGB texels
    env_pmf: Any        # (Hs, Ws) float32 — discrete texel pmf (sums to 1)
    env_marg_cdf: Any   # (Hs,) float32 — row marginal CDF
    env_cond_cdf: Any   # (Hs, Ws) float32 — per-row conditional CDF
    env_to_world: Any   # (3, 3) float32 — rotation part of to_world
    env_to_local: Any   # (3, 3) float32 — inverse rotation


@dataclass(frozen=True)
class Camera(_Tables):
    to_world: Any          # (4, 4) float32
    sample_to_camera: Any  # (4, 4) float32
    near: Any              # () float32
    far: Any               # () float32


@dataclass(frozen=True)
class CompiledScene(_Tables):
    geometry: Geometry
    cluster: ClusterAccel
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    shape_bsdf: Any        # (S,) int32
    shape_emitter: Any     # (S,) int32 (-1 = none)
    film_width: int
    film_height: int
    spp: int
    max_depth: int
    rr_depth: int
    hide_emitters: bool
    integrator: str
    filter_type: str       # "gaussian" | "box"
    filter_stddev: float
    film_format: str       # "hdrfilm" | "rgbfilm"
    n_faces: int
    n_shapes: int
    n_emitters: int
    has_environment: bool
    environment_idx: int
    emitter_kinds: tuple
    bsdf_kinds: tuple = (BSDF_DIFFUSE,)
    crop_x: int = 0
    crop_y: int = 0
    # Bitmap textures: every texture's mip chain flattened into one
    # texel-major (Npad, 3) linear-RGB table (the transpose of misaki_tpu's
    # (3, Npad) atlas); meta is a static tuple of per-texture
    # (W0, H0, ((offset, W, H), ...per level)).
    bitmaps: Any = field(default_factory=lambda: np.zeros((8, 3), np.float32))
    bitmap_meta: tuple = ()
    # the levels of bitmap_meta as a (T, most levels, 3) int32 table of
    # (offset, W, H) on the scene's device, rows past a texture's last level
    # 0 (bitmap_level_table)
    bitmap_levels: Any = field(default_factory=lambda: np.zeros((0, 1, 3), np.int32))
    # static tuple of material-slot base columns that reference a bitmap;
    # the other slots skip the texel fetch
    bitmap_slots: tuple = ()
    # integrator settings (misaki_tpu/scene/compiler.py:1375-1384): the
    # `aov` integrator's "name:type" entries and its nested radiance
    # integrator; the `direct` integrator's sample counts per strategy
    aovs: tuple = ()
    aov_nested: str = "path"
    direct_light_samples: int = 1
    direct_bsdf_samples: int = 1
    # differentiable rendering (misaki_tpu_torch.diff): microfacet alpha and
    # the Disney slots carry gradients only when set; training flips it with
    # scene.replace(diff_mode=True)
    diff_mode: bool = False
    device: Any = field(default=torch.device("cpu"))

    def to(self, device):
        return replace(super().to(device), device=torch.device(device))

    def replace(self, **kw):
        return replace(self, **kw)
