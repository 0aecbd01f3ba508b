"""Render driver: wavefront orchestration + film assembly
(reference: SamplingIntegrator::render, integrator.cpp:31-126), with the
`path`, `direct`, `debug`, `aov` and `volpath` integrators, checkpoint/resume
and progress reports; `sppm` and `photonmapper` go to `render/ppm.py`.

The full (pixels x spp) sample set is split into fixed-size lane chunks; each
chunk is rendered and splatted into the film, which stays on the device.
Determinism: lane index == pixel * spp + sample, and each lane's PCG32 stream
is seeded by (lane, seed), so the image does not depend on the chunk size.
"""

import os

import numpy as np
import torch

from misaki_tpu_torch.core import rng, spectrum as spec
from misaki_tpu_torch.render import aov
from misaki_tpu_torch.render import camera as cam
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.render import integrator as integ
from misaki_tpu_torch.utils import tracing
from misaki_tpu_torch.utils.logging import get_logger

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
    """Render `chunk` lanes (spp-aligned) starting at `lane0` into the film:
    XYZ, or for `aov` its AOV columns and then XYZ (render/aov.py), then
    alpha and the filter weight."""
    with tracing.span(tracing.CHUNK):
        lane = lane0 + torch.arange(chunk, dtype=torch.int64, device=film_flat.device)
        in_range = lane < n_total
        ray, pos, state = primary_rays(scene, lane, seed)
        if scene.integrator == "aov":
            cols, _ = aov.chunk_columns(scene, ray, state, depth_cap)
        elif scene.integrator == "debug":
            rgb, _ = integ.sample_debug(scene, ray, state)
            cols = spec.srgb_to_xyz(rgb)
        else:
            L_spec, _ = integ.radiance(scene, ray, state, scene.integrator, depth_cap)
            cols = spec.spectrum_to_xyz(L_spec * ray["wav_weight"], ray["wavelengths"])

        ones = torch.ones(chunk, device=film_flat.device)
        # alpha=1, filter weight=1 (integrator.cpp:119-123)
        values = tuple(cols) + (ones, ones)
        values = tuple(torch.where(in_range & torch.isfinite(c), c, 0.0) for c in values)
        return film_mod.splat_aligned(
            film_flat, lane0 // scene.spp, pos, values,
            scene.film_width, scene.film_height, scene.spp,
            scene.filter_type, scene.filter_stddev,
        )


def render_lanes(scene, film_flat, lane0, lane1, seed, chunk, depth_cap):
    """Render the lanes [lane0, lane1) (spp-aligned) into the film in chunks
    of `chunk` lanes, the last one cut at lane1: `_render_chunk` masks only
    the lanes past the frame, so a chunk that ran on past lane1 would render
    lanes of the range after it."""
    n_total = scene.film_width * scene.film_height * scene.spp
    for c0 in range(lane0, lane1, chunk):
        _render_chunk(scene, film_flat, c0, n_total, seed, min(chunk, lane1 - c0), depth_cap)
    return film_flat


def pick_chunk(chunk_size, spp, n_total):
    """Largest spp-multiple <= chunk_size (min spp) so chunks stay
    pixel-aligned for the splat."""
    chunk = max(spp, (chunk_size // spp) * spp)
    return min(chunk, -(-n_total // spp) * spp)


def _scene_fingerprint(scene, seed, depth_cap, chunk):
    """Checkpoint compatibility: the static configuration (for `aov` its
    outputs and nested integrator, which fix the film's channels), the
    geometry's size, the seed and the resolved chunk. A chunk index means
    another lane range under another chunk size, so a snapshot taken under
    one would skip or add samples twice under another."""
    aovs = f"|aovs={','.join(scene.aovs)}>{scene.aov_nested}" if scene.integrator == "aov" else ""
    return (
        f"{scene.film_width}x{scene.film_height}x{scene.spp}"
        f"|{scene.integrator}{aovs}|{scene.max_depth}|{scene.n_faces}"
        f"|{scene.n_emitters}|seed={seed}|cap={depth_cap}|chunk={chunk}"
    )


def save_checkpoint(path, film_flat, next_chunk, fingerprint):
    """Atomic snapshot of the film (copied to the host) and the next chunk:
    written beside `path`, then renamed over it. The per-lane PCG32 streams
    need no state in the file: they derive from (lane, seed)."""
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, film_flat=film_flat.cpu().numpy(), next_chunk=np.int64(next_chunk),
             fingerprint=np.array(fingerprint))
    os.replace(tmp, path)


def load_checkpoint(path, fingerprint, device):
    """-> (film_flat on `device`, next_chunk), or None where there is no
    snapshot or it belongs to another render (logged)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as data:
        if str(data["fingerprint"]) != fingerprint:
            get_logger().warning(
                "checkpoint %s does not match this render (have %r, want %r): "
                "starting fresh", path, str(data["fingerprint"]), fingerprint)
            return None
        return torch.from_numpy(data["film_flat"]).to(device), int(data["next_chunk"])


def log_progress(done, total):
    """The default progress reporter: a log line about every tenth of the
    chunks."""
    if done % max(1, total // 10) == 0 or done == total:
        get_logger().info("render progress: %d/%d chunks (%.0f%%)", done, total,
                          100.0 * done / total)


def render(scene, seed=0, chunk_size=DEFAULT_CHUNK,
           depth_cap=integ.DEFAULT_MAX_DEPTH_CAP, checkpoint_path=None,
           checkpoint_every=8, progress=None):
    """Render the scene on the scene's device. Returns {"film" (H, W, 5),
    "rgb" (H, W, 3), "alpha" (H, W)} tensors on that device; the `aov`
    integrator returns {"film": None, "rgb", "alpha", "aovs": {name:
    (H, W, C)}} (render/aov.py). `sppm` and `photonmapper` go to
    `render_ppm` (render/ppm.py), which returns {"film": None, "rgb",
    "alpha"}, takes checkpoints and reports progress per iteration and has
    no use for `chunk_size` (its wavefront is one camera sample a pixel).

    checkpoint_path: where set, the film is saved every `checkpoint_every`
    chunks and a compatible snapshot is resumed from; the finished image is
    the uninterrupted one to the bit, since chunk order and the per-lane
    streams are fixed. The snapshot is deleted when the render completes.
    progress: callable(done_chunks, total_chunks) after each chunk; by
    default `log_progress` on a render of several chunks."""
    if scene.integrator in ("sppm", "photonmapper"):
        from misaki_tpu_torch.render.ppm import render_ppm

        return render_ppm(scene, seed=seed, depth_cap=depth_cap,
                          checkpoint_path=checkpoint_path,
                          checkpoint_every=checkpoint_every, progress=progress)
    with tracing.span(tracing.FRAME):
        W, H, spp = scene.film_width, scene.film_height, scene.spp
        n_total = W * H * spp
        chunk = pick_chunk(chunk_size, spp, n_total)
        n_chunks = -(-n_total // chunk)
        n_channels = aov.n_channels(scene) if scene.integrator == "aov" else 5
        fingerprint = _scene_fingerprint(scene, seed, depth_cap, chunk)
        start, film_flat = 0, None
        if checkpoint_path is not None:
            resumed = load_checkpoint(checkpoint_path, fingerprint, scene.device)
            if resumed is not None:
                film_flat, start = resumed
                get_logger().info("resuming from %s at chunk %d/%d", checkpoint_path, start,
                                  n_chunks)
        if progress is None and n_chunks > 1:
            progress = log_progress
        with torch.inference_mode():
            if film_flat is None:
                film_flat = film_mod.new_film_flat(H, W, n_channels, scene.filter_type,
                                                   scene.filter_stddev, device=scene.device)
            for c in range(start, n_chunks):
                _render_chunk(scene, film_flat, c * chunk, n_total, seed, chunk, depth_cap)
                if progress is not None:
                    progress(c + 1, n_chunks)
                if (checkpoint_path is not None and checkpoint_every > 0
                        and (c + 1) % checkpoint_every == 0 and c + 1 < n_chunks):
                    save_checkpoint(checkpoint_path, film_flat, c + 1, fingerprint)
            film = film_mod.film_from_flat(film_flat, H, W, scene.filter_type,
                                           scene.filter_stddev)
            if scene.integrator == "aov":
                out = {"film": None, **aov.develop(scene, film)}
            else:
                rgb, alpha = film_mod.develop(film)
                out = {"film": film, "rgb": rgb, "alpha": alpha}
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)  # completed: the snapshot is stale
        return out
