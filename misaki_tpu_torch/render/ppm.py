"""The `sppm` and `photonmapper` integrators: the counterpart of
`misaki_tpu.render.ppm` (reference: integrators/sppm.cpp:1-356,
photonmapper.cpp:1-250).

Each iteration is a camera pass (one sample per pixel; a visible point
parked at the first diffuse-lobe hit), a photon pass (`ppm_photons`
photons traced from the emitters depth by depth, each depth splatted
against every visible point) and a per-pixel update of the gather radius
and the flux (sppm.cpp:296-318). Per-pixel state accumulates in XYZ, since
each iteration draws its own hero wavelengths, shared by the camera and the
photon lanes.

Density estimation sums, for every visible point, the photons of one depth
within its radius and hemisphere. On a CUDA tensor `density_estimate`
launches the hand-written grid design of `csrc/ppm_density.cu`: the photons
binned into a uniform grid by a stable radix sort, then each live visible
point tests only the photons of the cells its radius reaches. The grid
(`Grid`, from the scene's bounding sphere and the initial radius) is made
once a frame in `render_ppm`, so no estimate waits on the host. On a CPU
tensor the estimate takes the plain twin `density_plain`, misaki_tpu's
blocked form (a (B, L) mask and a (4, B) x (B, L) matmul per 2048-photon
block, misaki_tpu/render/ppm.py:282-338). Both take the same float32
expressions and the kernel is built without fused multiply-add, so their
masks and counts agree to the bit; only the order of the flux sums differs.
`density_binned_plain` walks the kernel's grid in plain PyTorch, for the
tests.

Glossy visible points (sppm only: parked at the depth cap on a rough
conductor, rough dielectric or Disney lobe, sppm.cpp:146-151) are estimated
with their full BSDF evaluated per pair, in plain PyTorch on every device
(`_density_glossy`): over the glossy visible points only, in photon
sub-blocks of a power of two that divides the photon count, so no block
overlaps another.

Launches per iteration at depth budget D: closest hit 2D (D on the camera
pass, D on the photon pass), any hit D in sppm (the camera pass's NEE) and
none in the photonmapper, the density kernel D - 1 in sppm (depths >= 1)
and D in the photonmapper; texel fetches for bitmaps and an envmap as the
path integrator makes them, one more for envmap photon emission.
"""

import ctypes
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from misaki_tpu_torch.accel import traverse
from misaki_tpu_torch.bsdf import kernels as bsdf
from misaki_tpu_torch.core import frame, rng, vec
from misaki_tpu_torch.core import math as m
from misaki_tpu_torch.core import spectrum as spec
from misaki_tpu_torch.emitter import kernels as emitter
from misaki_tpu_torch.render import camera as cam
from misaki_tpu_torch.render import interaction as inter
from misaki_tpu_torch.scene.types import (
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
    EM_ENVMAP,
)
from misaki_tpu_torch.utils import cuda_build, tracing
from misaki_tpu_torch.utils.logging import get_logger

SRC = cuda_build.CSRC / "ppm_density.cu"

PHOTON_BLOCK = 2048     # the photon count is rounded up to a multiple of it
GLOSSY_LANES = 1 << 22  # pair lanes of one glossy sub-block (photons x visible points)
_GLOSSY_KINDS = (BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_DISNEY)
_M32 = 0xFFFFFFFF

GRID_AXIS = 128   # most cells of the density grid an axis
# the gather's margin r' = sqrt(r2) * REL_MARGIN + ABS_MARGIN, each step in
# float32 (csrc/ppm_density.cu derives it): 1 + 2^-16 and 2^-64
REL_MARGIN = 1.0 + 2.0 ** -16
ABS_MARGIN = 2.0 ** -64


def depth_budget(scene, depth_cap):
    """Vertices a camera or photon path visits: max_depth where it is set,
    else depth_cap + 1, at most depth_cap + 1 (misaki_tpu/render/ppm.py:71-73)."""
    d = scene.max_depth if scene.max_depth > 0 else depth_cap + 1
    return max(min(d, depth_cap + 1), 1)


def photon_count(scene):
    """Photons a pass: `ppm_photons` rounded up to a multiple of
    PHOTON_BLOCK (misaki_tpu/render/ppm.py:408), which the image's
    normalisation counts."""
    return -(-scene.ppm_photons // PHOTON_BLOCK) * PHOTON_BLOCK


def launches_per_iteration(scene, budget):
    """The kernel launches of one iteration at depth budget `budget`, as
    this module's loops make them: {"closest", "anyhit", "density",
    "fetch"}. Texel fetches: one per bitmap of each bitmap slot at every
    material evaluation (each camera vertex, each photon continuation); with
    an envmap, one for photon emission, one for each NEE sample (sppm) and,
    where the environment is shown, one for the primary escape and one for
    each camera continuation's escape."""
    sppm = scene.integrator == "sppm"
    bitmaps = len(scene.bitmap_slots) * len(scene.bitmap_meta)
    fetch = (2 * budget - 1) * bitmaps
    if scene.has_environment and scene.emitter_kinds[scene.environment_idx] == EM_ENVMAP:
        fetch += 1 + (budget if sppm else 0) + (0 if scene.hide_emitters else budget)
    return {"closest": 2 * budget, "anyhit": budget if sppm else 0,
            "density": budget - 1 if sppm else budget, "fetch": fetch}


def _kind_mask(kind, kinds, wanted):
    ok = torch.zeros_like(kind, dtype=torch.bool)
    for k in wanted:
        if k in kinds:
            ok = ok | (kind == k)
    return ok


def _has_glossy(kinds):
    return any(k in kinds for k in _GLOSSY_KINDS)


def _map_tree(fn, p):
    """fn applied to every lane tensor of a material-params dict; static
    entries kept."""
    if isinstance(p, dict):
        return {k: _map_tree(fn, v) for k, v in p.items()}
    return fn(p) if isinstance(p, torch.Tensor) else p


def _lane_rng(lane, mult, it, lane_offset, mix, seed):
    """misaki_tpu's per-iteration PCG32 streams: initstate (seed * mult + it,
    lane + lane_offset), initseq (lane ^ (it * mix), seed | 1), in uint32."""
    return rng.seed((((seed * mult) + it) & _M32, (lane + lane_offset) & _M32),
                    (lane ^ ((it * mix) & _M32), (seed | 1) & _M32))


def _camera_pass(scene, it, seed, wavelengths, budget, sppm_mode, rad):
    """One camera sample per pixel (misaki_tpu/render/ppm.py:122-279).
    Returns (value (4, L): emitted, environment and NEE radiance of this
    iteration; the visible-point record {p, wi (world, toward the camera), n,
    beta, rho, valid, glossy, mat}; primary_hit (L,) for alpha)."""
    W, H = scene.film_width, scene.film_height
    L = W * H
    dev = wavelengths.device
    lane = torch.arange(L, dtype=torch.int64, device=dev)
    state = _lane_rng(lane, 0x9E3779B9, it, 0, 0x85EBCA6B, seed)
    jitter, state = rng.next_2d(state)
    px = (lane % W).to(torch.float32) + jitter[0]
    py = (lane // W).to(torch.float32) + jitter[1]
    ray = cam.sample_ray(scene.camera, (px + scene.crop_x, py + scene.crop_y),
                         torch.zeros(L, device=dev))
    d = ray["d"]
    hit = traverse.intersect(scene, ray["o"], d, ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, ray["o"], d, wavelengths)
    # camera-ray coverage drives alpha: specular geometry and visible
    # emitters store no visible point but are covered
    primary_hit = si["valid"]

    z, one = torch.zeros(L, device=dev), torch.ones(L, device=dev)
    value = torch.zeros((4, L), device=dev)
    beta = torch.ones((4, L), device=dev)
    active = si["valid"]
    specular = torch.zeros(L, dtype=torch.bool, device=dev)
    glossy_vps = sppm_mode and _has_glossy(scene.bsdf_kinds)
    vp = {"p": (z, z, z), "wi": (z, z, one), "n": (z, z, one),
          "beta": torch.zeros((4, L), device=dev), "rho": torch.zeros((4, L), device=dev),
          "valid": torch.zeros(L, dtype=torch.bool, device=dev),
          "glossy": torch.zeros(L, dtype=torch.bool, device=dev), "mat": None}
    show_env = scene.has_environment and not scene.hide_emitters
    if show_env:
        env = emitter.eval_environment(scene, d, wavelengths, rad)
        value = value + torch.where((~si["valid"])[None, :], env, 0.0)

    kinds = scene.bsdf_kinds
    for depth in range(budget):
        with tracing.span(tracing.BOUNCE):
            # emitted radiance on the first hit or through a delta chain
            # (sppm.cpp:121-124)
            em_ok = active & (si["emitter"] >= 0)
            see_emitter = em_ok if depth == 0 else em_ok & specular
            if not scene.hide_emitters or depth > 0:
                em_val = emitter.eval_emitter(scene, si["emitter"], si["wi"], si["uv"],
                                              wavelengths, rad)
                value = value + torch.where(see_emitter[None, :], beta * em_val, 0.0)

            p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths,
                                     duv=(si["duv_dx"], si["duv_dy"]))

            if sppm_mode:
                # visibility-tested light sampling at every smooth vertex
                # (sppm.cpp:126-144); photons of depth >= 1 carry the rest
                u_nee, state = rng.next_2d(state)
                ds = emitter.sample_emitter_direct(scene, si["p"], wavelengths, u_nee, rad)
                possible = active & p["smooth"] & (ds["pdf"] > 0.0)
                sh_mint = m.RayEpsilon * (1.0 + vec.max_abs(si["p"]))
                occ = traverse.ray_test(scene, si["p"], ds["d"],
                                        torch.where(possible, sh_mint, 0.0),
                                        torch.where(possible, ds["dist"] * (1.0 - m.ShadowEpsilon),
                                                    -1.0))
                f_nee = bsdf.eval_bsdf(p, si["wi"], frame.to_local(si["sh"], ds["d"]))
                value = value + torch.where((possible & ~occ)[None, :], beta * ds["spec"] * f_nee,
                                            0.0)

            # park the visible point at the first diffuse-lobe hit on a side the
            # camera can shade, the normal flipped to the camera's side for
            # twosided materials
            front = frame.cos_theta(si["wi"]) > 0.0
            shadeable = front | p["twosided"]
            store = (active & _kind_mask(p["kind"], kinds, (BSDF_DIFFUSE, BSDF_PLASTIC))
                     & shadeable & ~vp["valid"])
            n_sh = vec.where(front, si["sh"]["n"], vec.neg(si["sh"]["n"]))
            # in sppm, a glossy visible point where the path reaches the depth
            # cap on a glossy lobe (sppm.cpp:146-151), with its material stored
            last = depth == budget - 1
            store_g = torch.zeros_like(store)
            if glossy_vps and last:
                store_g = (active & _kind_mask(p["kind"], kinds, _GLOSSY_KINDS) & shadeable
                           & ~vp["valid"])
                # misaki_tpu's _where_tree of p over a zero tree (ppm.py:97-119)
                vp["mat"] = _map_tree(lambda x: torch.where(
                    store_g[None, :] if x.dim() == 2 else store_g, x, torch.zeros_like(x)), p)
            store_any = store | store_g
            vp.update(
                p=vec.where(store_any, si["p"], vp["p"]),
                wi=vec.where(store_any, vec.neg(d), vp["wi"]),
                n=vec.where(store_any, n_sh, vp["n"]),
                beta=torch.where(store_any[None, :], beta, vp["beta"]),
                # rho stays 0 on glossy lanes
                rho=torch.where(store[None, :], p["reflectance"], vp["rho"]),
                valid=vp["valid"] | store_any,
                glossy=vp["glossy"] | store_g,
            )
            active = active & ~store_any
            if last:
                break

            # continue through non-diffuse lobes (sppm.cpp:153-174)
            u1, state = rng.next_float32(state)
            u2, state = rng.next_2d(state)
            u_rr, state = rng.next_float32(state)
            bs = bsdf.sample_bsdf(p, si["wi"], u1, u2)
            active = active & bs["valid"] & (bs["pdf"] > 0.0)
            beta_new = beta * bs["weight"]
            q = torch.clamp(beta_new.amax(dim=0), max=0.95)
            active = active & ~(u_rr >= q)
            beta = torch.where(active[None, :], beta_new / torch.clamp(q, min=1e-8)[None, :], beta)
            specular = bs["delta"]
            wo_world = frame.to_world(si["sh"], bs["wo"])
            hit = traverse.intersect(scene, si["p"], wo_world,
                                     torch.where(active, inter.spawn_ray_mint(si["p"]), 0.0),
                                     torch.where(active, torch.inf, -1.0), coherent=False)
            if show_env:
                env = emitter.eval_environment(scene, wo_world, wavelengths, rad)
                value = value + torch.where((active & (hit["prim"] < 0))[None, :], beta * env, 0.0)
            si = inter.compute_interaction(scene, hit, si["p"], wo_world, wavelengths)
            d = wo_world
            active = active & si["valid"]

    return value, vp, primary_hit


# ---------------------------------------------------------------------------
# density estimation
# ---------------------------------------------------------------------------

def density_plain(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok, sppm_mode):
    """Plain PyTorch twin of the density kernel, misaki_tpu's blocked form
    (misaki_tpu/render/ppm.py:282-338), the CPU path and the kernel's oracle.

    A pair (photon j, visible point i) passes when |p_j - p_i|^2 < r2_i, the
    transport hemisphere test holds (sppm: the photon's normal . the visible
    point's camera direction > 0; the photonmapper: the photon's wi . the
    visible point's normal > 0), the photon is alive with wi . n > 0 and the
    visible point is valid and not glossy. vp: {p, wi, n (vec3), valid,
    glossy (L,)}; radius2 (L,); photons: p, wi, n (vec3 of (P,)), flux
    (4, P), ok (P,) bool. Returns (phi (4, L): the passing pairs' flux sums,
    count (L,)). The flux sum of each 2048-photon block is one matmul."""
    L = radius2.shape[0]
    P = ph_ok.shape[0]
    wiz = ph_wi[0] * ph_n[0] + ph_wi[1] * ph_n[1] + ph_wi[2] * ph_n[2]
    ok = ph_ok & (wiz > 0.0)
    live = vp["valid"] & ~vp["glossy"]
    a = vp["wi"] if sppm_mode else vp["n"]
    e = ph_n if sppm_mode else ph_wi
    phi = torch.zeros((4, L), device=radius2.device)
    count = torch.zeros(L, device=radius2.device)
    for s in range(0, P, PHOTON_BLOCK):
        b = slice(s, s + PHOTON_BLOCK)
        dx = ph_p[0][b, None] - vp["p"][0][None, :]                # (B, L)
        dy = ph_p[1][b, None] - vp["p"][1][None, :]
        dz = ph_p[2][b, None] - vp["p"][2][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        cosw = e[0][b, None] * a[0][None, :] + e[1][b, None] * a[1][None, :] \
            + e[2][b, None] * a[2][None, :]
        mask = ((d2 < radius2[None, :]) & (cosw > 0.0) & ok[b, None]
                & live[None, :]).to(torch.float32)
        phi = phi + torch.matmul(ph_flux[:, b], mask)
        count = count + mask.sum(dim=0)
    return phi, count


class Grid(NamedTuple):
    """The density estimate's uniform grid: float32 origin `lo` (3,) and
    inverse cell size `inv_h`, `dims` (nx, ny, nz) cells. A coordinate x
    lies in cell clamp(floor((x - lo) * inv_h), 0, n - 1) of its axis, a
    point in cell (z * ny + y) * nx + x."""
    lo: tuple
    inv_h: np.float32
    dims: tuple

    @property
    def n_cells(self):
        return self.dims[0] * self.dims[1] * self.dims[2]


def density_grid(center, radius, r0):
    """The grid over the cube of half-side `radius` about `center` (3,):
    cells of h = max(r0, 2 radius / GRID_AXIS), at most GRID_AXIS an axis.
    A point outside the cube falls into a border cell; no estimate depends
    on the grid, only the number of pairs it tests."""
    R = max(float(radius), 0.0)
    h = max(float(r0), 2.0 * R / GRID_AXIS)
    if not h > 0.0:
        h = 1.0
    inv_h = np.float32(1.0 / h)
    if not inv_h > 0.0:
        inv_h = np.float32(np.finfo(np.float32).tiny)
    n = int(min(GRID_AXIS, max(1, math.ceil(2.0 * R * float(inv_h)))))
    lo = tuple(np.float32(float(c) - R) for c in np.asarray(center, np.float64).reshape(3))
    return Grid(lo, inv_h, (n, n, n))


def initial_radius(scene):
    """The gather radius of the first iteration: `ppm_radius`, or where it is
    not set a fraction of the scene's bounding sphere
    (misaki_tpu/render/ppm.py:582-585)."""
    r0 = float(scene.ppm_radius)
    if r0 <= 0.0:
        r0 = 0.025 * float(torch.clamp(scene.emitters.bsphere_radius, min=1e-3))
    return r0


def scene_grid(scene, r0):
    """The grid of a frame: the scene's bounding sphere's cube, cells of the
    initial radius `r0` (the radius only shrinks in sppm)."""
    em = scene.emitters
    return density_grid(torch.as_tensor(em.bsphere_center).cpu().numpy(),
                        float(em.bsphere_radius), r0)


def _cells(x, lo, inv_h, n):
    """The cell of each coordinate x (float32) on an axis of `n` cells: the
    kernel's cell_of, fmax / fmin passing NaN over as fmaxf / fminf do."""
    t = (x - lo) * inv_h
    t = torch.fmin(torch.fmax(t, torch.zeros_like(t)), torch.full_like(t, float(n - 1)))
    return torch.floor(t).to(torch.int64)


def density_binned_plain(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok, sppm_mode, grid,
                         stats=None):
    """The grid design of the density kernel in plain PyTorch, for the tests
    and the profile: the photons that may contribute keyed by cell and
    stably sorted (the others keyed past every cell), the offsets of every
    cell, and each live visible point's cells cell(p - r') .. cell(p + r')
    walked in (z, y) rows, with the twin's pair test on every photon found.
    The contract of `density_plain`. `stats`, a dict, gets "pair_tests"."""
    dev = radius2.device
    L, P = radius2.shape[0], ph_ok.shape[0]
    nx, ny, _ = grid.dims
    n_cells = grid.n_cells
    f32 = dict(dtype=torch.float32, device=dev)
    lo = [torch.tensor(v, **f32) for v in grid.lo]
    inv_h = torch.tensor(grid.inv_h, **f32)
    wiz = ph_wi[0] * ph_n[0] + ph_wi[1] * ph_n[1] + ph_wi[2] * ph_n[2]
    ok = torch.nonzero(ph_ok & (wiz > 0.0)).squeeze(1)
    key = torch.full((P,), n_cells, dtype=torch.int64, device=dev)
    c = [_cells(ph_p[k][ok], lo[k], inv_h, grid.dims[k]) for k in range(3)]
    key[ok] = (c[2] * ny + c[1]) * nx + c[0]
    sorted_key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(sorted_key, torch.arange(n_cells + 1, device=dev))

    ids = torch.nonzero(vp["valid"] & ~vp["glossy"]).squeeze(1)
    r2 = radius2[ids]
    rr = m.sqrt(r2) * torch.tensor(REL_MARGIN, **f32) + torch.tensor(ABS_MARGIN, **f32)
    p = [vp["p"][k][ids] for k in range(3)]
    c0 = [_cells(p[k] - rr, lo[k], inv_h, grid.dims[k]) for k in range(3)]
    c1 = [_cells(p[k] + rr, lo[k], inv_h, grid.dims[k]) for k in range(3)]

    def ragged(lengths):
        """(owner, k): for each owner its items k = 0 .. lengths - 1."""
        owner = torch.repeat_interleave(torch.arange(lengths.shape[0], device=dev), lengths)
        start = torch.cumsum(lengths, 0) - lengths
        return owner, torch.arange(owner.shape[0], device=dev) - start[owner]

    # the rows (z, y) of each visible point's box, then the photons of each
    # row's span [offsets[row + x0], offsets[row + x1 + 1])
    span_y = c1[1] - c0[1] + 1
    v, k = ragged((c1[2] - c0[2] + 1) * span_y)
    row = ((c0[2][v] + k // span_y[v]) * ny + c0[1][v] + k % span_y[v]) * nx
    start, end = offsets[row + c0[0][v]], offsets[row + c1[0][v] + 1]
    r, k = ragged(end - start)
    v, j = v[r], perm[start[r] + k]
    i = ids[v]
    if stats is not None:
        stats["pair_tests"] = int(j.shape[0])

    a = vp["wi"] if sppm_mode else vp["n"]
    e = ph_n if sppm_mode else ph_wi
    dx = ph_p[0][j] - vp["p"][0][i]
    dy = ph_p[1][j] - vp["p"][1][i]
    dz = ph_p[2][j] - vp["p"][2][i]
    d2 = dx * dx + dy * dy + dz * dz
    cosw = e[0][j] * a[0][i] + e[1][j] * a[1][i] + e[2][j] * a[2][i]
    hit = (d2 < r2[v]) & (cosw > 0.0)
    phi = torch.zeros((4, L), device=dev).index_add_(1, i[hit], ph_flux[:, j[hit]])
    count = torch.zeros(L, device=dev).index_add_(
        0, i[hit], torch.ones(int(hit.sum()), device=dev))
    return phi, count


def build():
    """Compile csrc/ppm_density.cu with nvcc for sm_90a (once per source
    hash) and load it. Returns the ctypes library."""
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    return cuda_build.load_library(SRC, {
        "density_workspace_bytes": ([i64, i64], i64),
        "density_launch": ([p, i64, p, i64, i32, f32, f32, f32, f32, i32, i32, i32, p, i64, p, p,
                            p, p, p, p], i32),
    })


def pack_inputs(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok):
    """The kernel's inputs: photons (14, P) [p, wi, n, flux, alive] and
    visible points (11, L) [p, wi, n, r2, valid and not glossy], float32."""
    ph = torch.stack([*ph_p, *ph_wi, *ph_n, *ph_flux, ph_ok.to(torch.float32)])
    vps = torch.stack([*vp["p"], *vp["wi"], *vp["n"], radius2,
                       (vp["valid"] & ~vp["glossy"]).to(torch.float32)])
    return ph, vps


def check_packed(ph, vps):
    if ph.dtype != torch.float32 or vps.dtype != torch.float32 or ph.shape[0] != 14 \
            or vps.shape[0] != 11 or not (ph.is_contiguous() and vps.is_contiguous()):
        raise ValueError("the density kernel takes contiguous float32 (14, P) photons and "
                         f"(11, L) visible points, got {tuple(ph.shape)}, {tuple(vps.shape)}")


def grid_args(grid):
    """The grid as the launchers take it: lo_x, lo_y, lo_z, inv_h, nx, ny, nz."""
    return (*(float(v) for v in grid.lo), float(grid.inv_h), *(int(n) for n in grid.dims))


def density_launch(lib, ph, vps, sppm_mode, grid, stats=None, pair_tests=False):
    """One estimate of library `lib` on packed CUDA inputs over `grid`:
    (phi (4, L), count (L,)). `stats`, a dict, gets "cuda_launches" (the
    kernels one estimate enqueues) and, with `pair_tests`, "pair_tests" (a
    device tensor: the pairs the gather tested). While tracing is on, the
    kernels add to `density.alive`, `density.contributing` and
    `density.live`."""
    check_packed(ph, vps)
    L, P = vps.shape[1], ph.shape[1]
    phi = torch.empty((4, L), dtype=torch.float32, device=vps.device)
    count = torch.empty(L, dtype=torch.float32, device=vps.device)
    if L == 0:
        return phi, count
    n_bytes = lib.density_workspace_bytes(P, grid.n_cells)
    if n_bytes < 0:
        raise ValueError(f"no density workspace for {P} photons and {grid.n_cells} cells")
    work = torch.empty(n_bytes, dtype=torch.uint8, device=vps.device)
    tests = torch.zeros(1, dtype=torch.int64, device=vps.device) if pair_tests else None
    launches = ctypes.c_int(0)
    stream = torch.cuda.current_stream(vps.device).cuda_stream
    cuda_build.check_launch(lib.density_launch(
        ph.data_ptr(), P, vps.data_ptr(), L, int(bool(sppm_mode)), *grid_args(grid),
        work.data_ptr(), n_bytes, phi.data_ptr(), count.data_ptr(),
        None if tests is None else tests.data_ptr(),
        tracing.device_counter(vps.device, tracing.DENSITY_ALIVE), ctypes.byref(launches),
        stream),
        "density kernel")
    if stats is not None:
        stats["cuda_launches"] = launches.value
        if pair_tests:
            stats["pair_tests"] = tests
    return phi, count


def density_estimate(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok, sppm_mode, grid=None):
    """One photon depth's density estimate against every visible point (the
    contract of `density_plain`). CPU tensors take the plain twin (`grid`
    unused); CUDA tensors launch the kernel over `grid`, which they need.
    While tracing is on, P and L go to `density.photons` and
    `density.visible_points`, and the kernel (on the CPU, torch ops) counts
    the photons alive, those alive with wi . n > 0 and the live visible
    points."""
    with tracing.span(tracing.DENSITY):
        dev = radius2.device
        tracing.add(tracing.DENSITY_PHOTONS, ph_ok.shape[0])
        tracing.add(tracing.DENSITY_VPS, radius2.shape[0])
        if dev.type == "cpu":
            if tracing.enabled():
                wiz = ph_wi[0] * ph_n[0] + ph_wi[1] * ph_n[1] + ph_wi[2] * ph_n[2]
                tracing.add(tracing.DENSITY_ALIVE, ph_ok.sum())
                tracing.add(tracing.DENSITY_CONTRIBUTING, (ph_ok & (wiz > 0.0)).sum())
                tracing.add(tracing.DENSITY_LIVE, (vp["valid"] & ~vp["glossy"]).sum())
            return density_plain(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok, sppm_mode)
        if dev.type != "cuda":
            raise ValueError(f"no density kernel for device {dev}")
        if grid is None:
            raise ValueError("the density kernel needs a grid (`scene_grid` of the frame)")
        stats = {}
        out = density_launch(build(),
                             *pack_inputs(vp, radius2, ph_p, ph_wi, ph_n, ph_flux, ph_ok),
                             sppm_mode, grid, stats=stats)
        tracing.launches["density"] += 1
        tracing.launches["density_cuda"] += stats.get("cuda_launches", 0)
        return out


def glossy_block(n_vps, n_photons):
    """Photons of one glossy sub-block: the power of two nearest below
    GLOSSY_LANES / n_vps, between 1 and PHOTON_BLOCK, so that it divides the
    rounded photon count and no sub-block overlaps another."""
    g = 1 << max((GLOSSY_LANES // max(n_vps, 1)).bit_length() - 1, 0)
    return max(1, min(g, PHOTON_BLOCK, n_photons))


def _density_glossy(vp, radius2, ph_p, ph_sh, ph_wi_local, ph_flux, ph_ok):
    """The pair sum at glossy visible points with their full BSDF
    (sppm.cpp:263-268; misaki_tpu/render/ppm.py:341-400): the stored BSDF
    evaluated at the photon's shading frame (wi the photon's local incoming
    direction, wo the camera direction in the photon's frame), divided by
    cos_theta(wo). Only the glossy visible points are evaluated, every
    photon against all of them in sub-blocks of `glossy_block` photons;
    each sub-block is summed over its photons, then the sub-blocks in order,
    as misaki_tpu sums its blocks. Returns (phi (4, L), count (L,))."""
    with tracing.span(tracing.DENSITY):
        L = radius2.shape[0]
        P = ph_ok.shape[0]
        dev = radius2.device
        phi = torch.zeros((4, L), device=dev)
        count = torch.zeros(L, device=dev)
        sel = torch.nonzero(vp["valid"] & vp["glossy"]).squeeze(1)
        n = sel.numel()
        if n == 0 or P == 0:
            return phi, count
        G = glossy_block(n, P)

        def tile(x):     # a visible point's value, once per photon of the sub-block
            x = x[..., sel]
            return x.repeat(1, G) if x.dim() == 2 else x.repeat(G)

        mat = _map_tree(tile, vp["mat"])
        wi_cam = tuple(tile(c) for c in vp["wi"])
        vpp = tuple(tile(c) for c in vp["p"])
        r2 = tile(radius2)
        acc_phi = torch.zeros((4, n), device=dev)
        acc_count = torch.zeros(n, device=dev)
        for s in range(0, P, G):

            def each(x):  # a photon's value, once per visible point
                return x[..., s:s + G].repeat_interleave(n, dim=-1)

            sh = {k: tuple(each(c) for c in ph_sh[k]) for k in ("s", "t", "n")}
            wo = tuple(sh[k][0] * wi_cam[0] + sh[k][1] * wi_cam[1] + sh[k][2] * wi_cam[2]
                       for k in ("s", "t", "n"))
            f = bsdf.eval_bsdf(mat, tuple(each(c) for c in ph_wi_local), wo)   # f * cos(wo)
            cz = wo[2]
            safe = torch.abs(cz) > 1e-4
            f = torch.where(safe[None, :], f / torch.where(safe, cz, 1.0)[None, :], 0.0)
            dx, dy, dz = (each(ph_p[k]) - vpp[k] for k in range(3))
            pair = (dx * dx + dy * dy + dz * dz < r2) & each(ph_ok)
            contrib = torch.where(pair[None, :], f * each(ph_flux), 0.0)
            hits = (pair & (torch.abs(f).amax(dim=0) > 0.0)).to(torch.float32)
            acc_phi = acc_phi + contrib.reshape(4, -1, n).sum(dim=1)
            acc_count = acc_count + hits.reshape(-1, n).sum(dim=0)
        phi[:, sel] = acc_phi
        count[sel] = acc_count
        return phi, count


def _photon_pass(scene, it, seed, wavelengths, vp, radius2, budget, sppm_mode, grid):
    """Trace `photon_count(scene)` photons and splat each depth against the
    visible points over `grid` (misaki_tpu/render/ppm.py:403-489); no photon
    is stored beyond the live wavefront. Returns (phi (4, L) of the diffuse visible
    points, phi_g (4, L) of the glossy ones, count (L,))."""
    P = photon_count(scene)
    dev = radius2.device
    lane = torch.arange(P, dtype=torch.int64, device=dev)
    # the iteration's hero wavelengths, broadcast to the photon lanes
    wavelengths = wavelengths[:, :1].expand(4, P).contiguous()
    rad = emitter.radiance_all(scene, wavelengths)
    state = _lane_rng(lane, 0x6C078965, it, 0x400000, 0xB5297A4D, seed)
    u_sel, state = rng.next_float32(state)
    u_pos, state = rng.next_2d(state)
    u_dir, state = rng.next_2d(state)
    er = emitter.sample_emitter_ray(scene, wavelengths, u_sel, u_pos, u_dir, rad)
    d, flux, alive = er["d"], er["flux"], er["valid"]
    L = radius2.shape[0]
    phi = torch.zeros((4, L), device=dev)
    phi_g = torch.zeros((4, L), device=dev)
    count = torch.zeros(L, device=dev)
    glossy = sppm_mode and vp["mat"] is not None

    mint0 = m.RayEpsilon * (1.0 + vec.max_abs(er["o"]))
    hit = traverse.intersect(scene, er["o"], d, torch.where(alive, mint0, 0.0),
                             torch.where(alive, torch.inf, -1.0), coherent=False)
    si = inter.compute_interaction(scene, hit, er["o"], d, wavelengths)
    alive = alive & si["valid"]

    for depth in range(budget):
        with tracing.span(tracing.BOUNCE):
            # sppm splats only scattered photons (depth >= 1): the camera's NEE
            # carries direct light (sppm.cpp:245-248); the photonmapper, whose
            # camera pass has no NEE, splats every depth (photonmapper.cpp:133-138)
            if not (sppm_mode and depth == 0):
                dphi, dcount = density_estimate(vp, radius2, si["p"], vec.neg(d), si["sh"]["n"],
                                                flux, alive, sppm_mode, grid=grid)
                phi, count = phi + dphi, count + dcount
                if glossy:
                    gphi, gcount = _density_glossy(vp, radius2, si["p"], si["sh"], si["wi"],
                                                   flux, alive)
                    phi_g, count = phi_g + gphi, count + gcount
            if depth == budget - 1:
                break
            p = bsdf.material_params(scene, si["bsdf"], si["uv"], wavelengths)
            u1, state = rng.next_float32(state)
            u2, state = rng.next_2d(state)
            u_rr, state = rng.next_float32(state)
            bs = bsdf.sample_bsdf(p, si["wi"], u1, u2)
            alive = alive & bs["valid"] & (bs["pdf"] > 0.0)
            fnew = flux * bs["weight"]
            q = torch.clamp(fnew.amax(dim=0) / torch.clamp(flux.amax(dim=0), min=1e-20), max=0.95)
            alive = alive & (u_rr < q)
            flux = torch.where(alive[None, :], fnew / torch.clamp(q, min=1e-8)[None, :], flux)
            d = frame.to_world(si["sh"], bs["wo"])
            hit = traverse.intersect(scene, si["p"], d,
                                     torch.where(alive, inter.spawn_ray_mint(si["p"]), 0.0),
                                     torch.where(alive, torch.inf, -1.0), coherent=False)
            si = inter.compute_interaction(scene, hit, si["p"], d, wavelengths)
            alive = alive & si["valid"]

    return phi, phi_g, count


def ppm_iteration(scene, st, it, seed, budget, sppm_mode, grid=None):
    """One iteration (misaki_tpu/render/ppm.py:492-547): the iteration's
    wavelengths, the camera pass, the photon pass (its estimates over
    `grid`, default the scene's `scene_grid`), then the per-pixel update
    of st = {value, tau (3, L) XYZ, n, radius, alpha (L,), iters ()}: in
    sppm the radius and tau shrink with gamma = 2/3 (sppm.cpp:296-318), the
    photonmapper keeps its radius. Returns the new state."""
    if grid is None:
        grid = scene_grid(scene, initial_radius(scene))
    L = st["radius"].shape[0]
    dev = st["radius"].device
    u_wav, _ = rng.next_float32(rng.seed(
        (0xA511E9B3, torch.full((1,), it, dtype=torch.int64, device=dev)), (seed & _M32, 7)))
    wavelengths, wav_weight = spec.sample_wavelength(u_wav.expand(L))
    rad = emitter.radiance_all(scene, wavelengths)

    value, vp, primary_hit = _camera_pass(scene, it, seed, wavelengths, budget, sppm_mode, rad)
    radius2 = st["radius"] * st["radius"]
    phi, phi_g, mcount = _photon_pass(scene, it, seed, wavelengths, vp, radius2, budget,
                                      sppm_mode, grid)

    # the visible point's factors: rho / pi and the path throughput for the
    # diffuse pairs; glossy pairs carry their full BSDF
    phi_spec = vp["beta"] * (vp["rho"] * m.InvPi * phi + phi_g)
    value_xyz = torch.stack(spec.spectrum_to_xyz(value * wav_weight, wavelengths))
    phi_xyz = torch.stack(spec.spectrum_to_xyz(phi_spec * wav_weight, wavelengths))

    st = dict(st)
    if sppm_mode:
        gamma = 2.0 / 3.0
        has = mcount > 0.0
        n_new = st["n"] + gamma * mcount
        r_new = torch.where(
            has, st["radius"] * m.sqrt(n_new / torch.clamp(st["n"] + mcount, min=1e-8)),
            st["radius"])
        ratio = torch.where(has, (r_new * r_new) / torch.clamp(radius2, min=1e-20), 1.0)
        st.update(tau=(st["tau"] + phi_xyz) * ratio[None, :], n=torch.where(has, n_new, st["n"]),
                  radius=r_new)
    else:
        st["tau"] = st["tau"] + phi_xyz
    st.update(value=st["value"] + value_xyz, alpha=st["alpha"] + primary_hit.to(torch.float32),
              iters=st["iters"] + 1.0)
    return st


def ppm_fingerprint(scene, seed, budget):
    """Checkpoint compatibility of a photon-mapping render
    (misaki_tpu/render/ppm.py:550-558): iterations resume at a whole
    iteration, so the per-iteration configuration is what must match."""
    return (f"ppm|{scene.film_width}x{scene.film_height}|{scene.integrator}"
            f"|{scene.ppm_photons}|{scene.ppm_radius}|{scene.n_faces}"
            f"|{scene.n_emitters}|seed={seed}|budget={budget}")


def render_ppm(scene, seed=0, depth_cap=16, checkpoint_path=None, checkpoint_every=8,
               progress=None):
    """Render a `sppm` or `photonmapper` scene on the scene's device
    (misaki_tpu/render/ppm.py:561-635). Returns {"film": None, "rgb" (H, W,
    3), "alpha" (H, W)}: the per-pixel state bypasses the reconstruction
    filter, as the reference box-accumulates its pixels (sppm.cpp:320-341).

    checkpoint_path / checkpoint_every / progress work per iteration: the
    whole per-pixel state is saved every `checkpoint_every` iterations and a
    compatible snapshot resumed from (each iteration's streams derive from
    (it, seed), so the finished image is the uninterrupted one to the bit);
    progress(done_iterations, iterations) after each iteration."""
    with tracing.span(tracing.FRAME):
        W, H = scene.film_width, scene.film_height
        L = W * H
        dev = scene.device
        sppm_mode = scene.integrator == "sppm"
        budget = depth_budget(scene, depth_cap)
        iters = max(int(scene.ppm_iterations), 1)
        r0 = initial_radius(scene)
        # the density grid, made once a frame: no estimate waits on the host
        grid = scene_grid(scene, r0)

        with torch.inference_mode():
            st = {"value": torch.zeros((3, L), device=dev), "tau": torch.zeros((3, L), device=dev),
                  "n": torch.zeros(L, device=dev),
                  "radius": torch.full((L,), r0, dtype=torch.float32, device=dev),
                  "alpha": torch.zeros(L, device=dev), "iters": torch.zeros((), device=dev)}
            start = 0
            fingerprint = ppm_fingerprint(scene, seed, budget)
            if checkpoint_path is not None and os.path.exists(checkpoint_path):
                with np.load(checkpoint_path, allow_pickle=False) as data:
                    if str(data["fingerprint"]) == fingerprint:
                        st = {k: torch.from_numpy(data[k]).to(dev) for k in st}
                        start = int(data["next_it"])
                        get_logger().info("resuming %s from %s at iteration %d/%d",
                                          scene.integrator, checkpoint_path, start, iters)
                    else:
                        get_logger().warning(
                            "checkpoint %s does not match this render (have %r, want %r): starting "
                            "fresh", checkpoint_path, str(data["fingerprint"]), fingerprint)

            for it in range(start, iters):
                st = ppm_iteration(scene, st, it, int(seed), budget, sppm_mode, grid)
                if progress is not None:
                    progress(it + 1, iters)
                if (checkpoint_path is not None and checkpoint_every > 0
                        and (it + 1) % checkpoint_every == 0 and it + 1 < iters):
                    tmp = f"{checkpoint_path}.tmp.npz"
                    np.savez(tmp, fingerprint=np.array(fingerprint), next_it=np.int64(it + 1),
                             **{k: v.cpu().numpy() for k, v in st.items()})
                    os.replace(tmp, checkpoint_path)

            Np = float(iters) * float(photon_count(scene))
            r2 = st["radius"] * st["radius"]
            xyz = st["value"] / float(iters) + st["tau"] / (Np * m.Pi * r2)[None, :]
            rgb = spec.xyz_to_srgb_image(xyz.T.reshape(H, W, 3))
            alpha = (st["alpha"] / float(iters)).reshape(H, W)
            out = {"film": None, "rgb": torch.clamp(rgb, min=0.0), "alpha": alpha}
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # completed: the snapshot is stale
        return out
