"""Render driver: wavefront orchestration + film assembly
(reference: SamplingIntegrator::render, integrator.cpp:31-126), with the
`path`, `direct`, `debug`, `aov` and `volpath` integrators, checkpoint/resume
and progress reports; `sppm` and `photonmapper` go to `render/ppm.py`.

The full (pixels x spp) sample set is split into fixed-size lane chunks; each
chunk is rendered and splatted into the film, which stays on the device.
Determinism: lane index == pixel * spp + sample, and each lane's PCG32 stream
is seeded by (lane, seed), so the image does not depend on the chunk size.

On a CUDA device, with no gradient to record, a full chunk of the path,
direct, volpath and debug integrators runs as a replay of the scene's chunk
captured as one CUDA graph (`_graph_chunk`): the same kernels in the same
order, launched at once instead of one by one from the host, so the film is
the eager one to the bit. Such a scene renders one frame at a time.
"""

import numpy as np
import torch

from misaki_tpu_torch.core import rng, spectrum as spec
from misaki_tpu_torch.render import aov
from misaki_tpu_torch.render import camera as cam
from misaki_tpu_torch.render import checkpoint
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.render import graphs
from misaki_tpu_torch.render import integrator as integ
from misaki_tpu_torch.utils import tracing
from misaki_tpu_torch.utils.logging import get_logger

DEFAULT_CHUNK = 1 << 20
_M32 = 0xFFFFFFFF


def seed_words(seed):
    """`make_rng`'s words of `seed`, each in [0, 2^32): its initstate's high
    word, the word its initseq's high word xors the lane with, and its
    initseq's low word."""
    seed32 = int(seed) & _M32
    return (seed32 * 0x9E3779B9) & _M32, (seed32 * 2654435761) & _M32, seed32 | 1


def make_rng(lane, seed):
    """Per-lane PCG32 streams: initstate = lane, initseq mixes the seed so
    different seeds give uncorrelated sequences (misaki_tpu's make_rng).
    seed: an int, or its `seed_words` as Python ints or as (1,) int64
    tensors (a captured chunk's inputs), which give the same bits."""
    state, mix, seq = seed if isinstance(seed, tuple) else seed_words(seed)
    return rng.seed_lanes(lane.to(torch.int64), state, mix, seq)


def primary_rays(scene, lane, seed):
    """Camera rays for global lane ids. Draw order matches the reference's
    render_sample (integrator.cpp:103-126): pixel jitter 2D, wavelength 1D,
    lens/aperture 2D (drawn but unused by the pinhole camera)."""
    pixel = lane // scene.spp
    px = (pixel % scene.film_width).to(torch.float32)
    py = (pixel // scene.film_width).to(torch.float32)

    state = make_rng(lane, seed)
    (jitter_x, jitter_y, wav_u, _lens_x, _lens_y), state = rng.next_floats(state, 5)

    pos = (px + jitter_x, py + jitter_y)
    # crop window: the camera spans the full sensor; film-local positions
    # are offset into it (film.cpp crop semantics)
    cam_pos = (pos[0] + scene.crop_x, pos[1] + scene.crop_y)
    ray = cam.sample_ray_differential(scene.camera, cam_pos, wav_u)
    return ray, pos, state


def _render_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap):
    """Render `chunk` lanes (spp-aligned) starting at `lane0` into the film:
    XYZ, or for `aov` its AOV columns and then XYZ (render/aov.py), then
    alpha and the filter weight. lane0 and seed: ints, or, in a captured
    chunk, a (1,) int64 tensor and the seed's `seed_words` as such tensors,
    where every lane lies in the frame."""
    tracing.add(tracing.PATH_CHUNKS, 1)
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


# the integrators of the 5-channel film (`aov`'s is wider; sppm and the
# photonmapper render no chunks)
FILM_INTEGRATORS = ("path", "direct", "volpath", "debug")
_GRAPH_ATTR = "_path_graph"   # a scene's captured chunk, in the scene's __dict__


def graph_eligible(device, integrator, lane0, n_total, chunk):
    """Whether the chunk of `chunk` lanes at `lane0` runs as a replay of the
    scene's captured chunk (`render/graphs.py`): on a CUDA device, with no
    gradient to record, under an integrator of the 5-channel film (`aov`'s
    film is wider), and with every lane in the frame (a tail chunk's splat
    masks its tail pixels, which waits on the device)."""
    return (torch.device(device).type == "cuda" and not torch.is_grad_enabled()
            and integrator in FILM_INTEGRATORS and lane0 + chunk <= n_total)


def _graph_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap):
    """`_render_chunk` as a replay of the scene's captured chunk: the film
    copied into the graph's own film, the chunk's input row (lane0, the
    seed's words and zeroed counter slots) copied from pinned memory, the
    replay, and the graph's film copied back, so `film_flat` holds the sum
    after every chunk and no result aliases the graph's film. Where the
    scene holds no graph under this chunk's key, the chunk runs eagerly,
    which builds the kernels and caches the tables, and is then captured."""
    key = (film_flat.device, tuple(film_flat.shape), chunk, depth_cap, scene.integrator,
           tuple(graphs.table_key(scene, [])))
    with torch.inference_mode():
        graph = graphs.cached(scene, _GRAPH_ATTR, key)
        if graph is None:
            _render_chunk(scene, film_flat, lane0, n_total, seed, chunk, depth_cap)
            film = torch.empty_like(film_flat)
            # the words: lane0, then the seed's three
            graphs.capture(
                scene, _GRAPH_ATTR, key, 4, film_flat.device,
                lambda w: _render_chunk(scene, film, w[0], n_total, w[1:], chunk, depth_cap),
                tracing.PATH_REPLAYS)
            return
        with tracing.span(tracing.CHUNK):
            row = (lane0, *seed_words(seed)) + (0,) * len(tracing.DEVICE_COUNTERS)
            graph.out.copy_(film_flat)
            graph.replay(torch.tensor(row, dtype=torch.int64).pin_memory())
            film_flat.copy_(graph.out)


def render_lanes(scene, film_flat, lane0, lane1, seed, chunk, depth_cap):
    """Render the lanes [lane0, lane1) (spp-aligned) into the film in chunks
    of `chunk` lanes, the last one cut at lane1: `_render_chunk` masks only
    the lanes past the frame, so a chunk that ran on past lane1 would render
    lanes of the range after it. A chunk of `chunk` lanes replays the
    scene's captured chunk where `graph_eligible`; a shorter one runs
    eagerly, so a scene keeps one graph."""
    n_total = scene.film_width * scene.film_height * scene.spp
    for c0 in range(lane0, lane1, chunk):
        n = min(chunk, lane1 - c0)
        if n == chunk and graph_eligible(film_flat.device, scene.integrator, c0, n_total, chunk):
            _graph_chunk(scene, film_flat, c0, n_total, seed, chunk, depth_cap)
        else:
            _render_chunk(scene, film_flat, c0, n_total, seed, n, depth_cap)
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
            resumed = checkpoint.load(checkpoint_path, fingerprint)
            if resumed is not None:
                # the per-lane PCG32 streams need no state in the file: they
                # derive from (lane, seed)
                film_flat = torch.from_numpy(resumed["film_flat"]).to(scene.device)
                start = int(resumed["next_chunk"])
                get_logger().info("resuming from %s at chunk %d/%d", checkpoint_path, start,
                                  n_chunks)
        if progress is None and n_chunks > 1:
            progress = log_progress
        with torch.inference_mode():
            if film_flat is None:
                film_flat = film_mod.new_film_flat(H, W, n_channels, scene.filter_type,
                                                   scene.filter_stddev, device=scene.device)
            for c in range(start, n_chunks):
                render_lanes(scene, film_flat, c * chunk, (c + 1) * chunk, seed, chunk,
                             depth_cap)
                if progress is not None:
                    progress(c + 1, n_chunks)
                if (checkpoint_path is not None and checkpoint_every > 0
                        and (c + 1) % checkpoint_every == 0 and c + 1 < n_chunks):
                    checkpoint.save(checkpoint_path, {"film_flat": film_flat.cpu().numpy(),
                                                      "next_chunk": np.int64(c + 1)}, fingerprint)
            film = film_mod.film_from_flat(film_flat, H, W, scene.filter_type,
                                           scene.filter_stddev)
            if scene.integrator == "aov":
                out = {"film": None, **aov.develop(scene, film)}
            else:
                rgb, alpha = film_mod.develop(film)
                out = {"film": film, "rgb": rgb, "alpha": alpha}
        if checkpoint_path is not None:
            checkpoint.discard(checkpoint_path)
        return out
