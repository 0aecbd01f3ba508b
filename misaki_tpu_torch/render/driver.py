"""Render driver: wavefront orchestration + film assembly
(reference: SamplingIntegrator::render, integrator.cpp:31-126).

The full (pixels x spp) sample set is split into fixed-size lane chunks; each
chunk is rendered and splatted into the film, which stays on the device.
Determinism: lane index == pixel * spp + sample, and each lane's PCG32 stream
is seeded by (lane, seed), so the image does not depend on the chunk size.
"""

import torch

from misaki_tpu_torch.core import rng, spectrum as spec
from misaki_tpu_torch.render import camera as cam
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.render import integrator as integ

DEFAULT_CHUNK = 1 << 20
_M32 = 0xFFFFFFFF


def make_rng(lane, seed):
    """Per-lane PCG32 streams: initstate = lane, initseq mixes the seed so
    different seeds give uncorrelated sequences (misaki_tpu's make_rng)."""
    seed32 = int(seed) & _M32
    lane = lane.to(torch.int64) & _M32
    return rng.seed(
        ((seed32 * 0x9E3779B9) & _M32, lane),
        (lane ^ ((seed32 * 2654435761) & _M32), seed32 | 1),
    )


def primary_rays(scene, lane, seed):
    """Camera rays for global lane ids. Draw order matches the reference's
    render_sample (integrator.cpp:103-126): pixel jitter 2D, wavelength 1D,
    lens/aperture 2D (drawn but unused by the pinhole camera)."""
    pixel = lane // scene.spp
    px = (pixel % scene.film_width).to(torch.float32)
    py = (pixel // scene.film_width).to(torch.float32)

    state = make_rng(lane, seed)
    jitter, state = rng.next_2d(state)
    wav_u, state = rng.next_float32(state)
    _lens, state = rng.next_2d(state)

    pos = (px + jitter[0], py + jitter[1])
    # crop window: the camera spans the full sensor; film-local positions
    # are offset into it (film.cpp crop semantics)
    cam_pos = (pos[0] + scene.crop_x, pos[1] + scene.crop_y)
    ray = cam.sample_ray_differential(scene.camera, cam_pos, wav_u)
    return ray, pos, state


def _render_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap):
    """Render `chunk` lanes (spp-aligned) starting at `lane0` into the film."""
    if scene.integrator != "path":
        raise NotImplementedError(f"integrator '{scene.integrator}'")
    lane = lane0 + torch.arange(chunk, dtype=torch.int64, device=film_flat.device)
    in_range = lane < n_total
    ray, pos, state = primary_rays(scene, lane, seed)
    L_spec, state = integ.sample_path(scene, ray, state, depth_cap)
    L_spec = L_spec * ray["wav_weight"]
    xyz = spec.spectrum_to_xyz(L_spec, ray["wavelengths"])

    ones = torch.ones(chunk, device=film_flat.device)
    # XYZAW channels (integrator.cpp:119-123: alpha=1, filter weight=1)
    values = tuple(xyz) + (ones, ones)
    values = tuple(torch.where(in_range & torch.isfinite(c), c, 0.0) for c in values)
    return film_mod.splat_aligned(
        film_flat, lane0 // scene.spp, pos, values,
        scene.film_width, scene.film_height, scene.spp,
        scene.filter_type, scene.filter_stddev,
    )


def pick_chunk(chunk_size, spp, n_total):
    """Largest spp-multiple <= chunk_size (min spp) so chunks stay
    pixel-aligned for the splat."""
    chunk = max(spp, (chunk_size // spp) * spp)
    return min(chunk, -(-n_total // spp) * spp)


def render(scene, seed=0, chunk_size=DEFAULT_CHUNK,
           depth_cap=integ.DEFAULT_MAX_DEPTH_CAP):
    """Render the scene on the scene's device. Returns {"film" (H, W, 5),
    "rgb" (H, W, 3), "alpha" (H, W)} tensors on that device."""
    W, H, spp = scene.film_width, scene.film_height, scene.spp
    n_total = W * H * spp
    chunk = pick_chunk(chunk_size, spp, n_total)
    n_chunks = -(-n_total // chunk)
    with torch.inference_mode():
        film_flat = film_mod.new_film_flat(H, W, 5, scene.filter_type,
                                           scene.filter_stddev, device=scene.device)
        for c in range(n_chunks):
            _render_chunk(scene, film_flat, c * chunk, n_total, seed, chunk, depth_cap)
        film = film_mod.film_from_flat(film_flat, H, W, scene.filter_type,
                                       scene.filter_stddev)
        rgb, alpha = film_mod.develop(film)
    return {"film": film, "rgb": rgb, "alpha": alpha}
