#!/usr/bin/env python3
"""The card's correctness check of the PyTorch/CUDA port (misaki_tpu_torch),
on one card: each hand-written kernel against its plain twin, each
integrator's frame against its launch counts, image checks and the same
render on the CPU, checkpoint/resume, gradients and sharding. Frames, steps
and processes are timed by the benchmark (`python3 benchmark/run.py
--workload <cell>`), not here; what this script times is each kernel on its
own, beside its twin and its bound.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. a CUDA device is present (name and power limit from nvidia-smi);
  2. the kernels build from csrc/cluster.cu, csrc/texel_fetch.cu,
     csrc/ppm_density.cu and csrc/pcg32.cu with nvcc (sm_90a), one nvcc per
     source, started together;
  3. each cluster kernel against its plain PyTorch twin on the card: the
     bunny stand-in (20,480 faces, 160 clusters) with 2^20 camera-like and
     2^20 random rays, the Cornell box with 2^20 camera rays, the bunny with
     every face duplicated into a second set of clusters (every hit an exact
     tie, which the copy's larger face id must win) and an accel with no
     faces; both device times and each cast's bound;
  4. one cbox frame at the benchmark spec (256x256, 64 spp, 4 bounces,
     2^20-lane chunks) through render() on cuda, the launch counters reset
     just before it and checked after (the PCG32 kernel's too: a chunk's
     seeding, its camera group and one group a bounce); image checks;
  5. a small cbox render on cuda against the same render on the CPU;
  6. the texel-fetch kernel against its plain twin at 2^20 lanes
     (misaki_tpu_torch.tools.profile_texel_fetch): random bilinear taps into
     the envlit scene's 2048x4096 envmap, camera-coherent taps into its
     1024^2 bitmap with the mip levels spread, the envmap's own NEE taps,
     and the split launches (every tap dead; every tap on texel 0; the
     random taps modulo a 4 MB table), each with its bound and sector
     bytes; beside it the library call F.embedding_bag on the same taps
     (timed and checked, never used by the port);
  7. one envlit frame (the bunny stand-in on a bitmap-textured floor under
     a 2048x4096 HDR sky, 256x256, 64 spp, 4 bounces) as in phase 4, with
     the launches of all three kernels checked; image checks; a small
     envlit render on cuda against the CPU;
  8. the closest-hit stage profile (misaki_tpu_torch.tools.profile_cluster_frame)
     on the bunny stand-in's camera rays and on random rays;
  9. the material gallery (misaki_tpu_torch/scenes/materials/: nine spheres,
     one per BSDF kind but null, the gold ball's GGX alpha from a 256^2
     bitmap, a constant environment and a point light) at the benchmark
     spec, one frame as in phase 4 with the launches of all three kernels
     checked; image checks (finite and non-negative, every ball's mean off
     the floor's, the glass balls not black); a small gallery render on
     cuda against the CPU;
 10. Figure 2 and Figure 3, the rough-conductor and rough-dielectric test
     balls (misaki_tpu_torch/scenes/testball/), at their declared 1280x720,
     128 spp (max_depth 5 and 7): one frame each as in phase 4; the same
     image checks; a small render of each on cuda against the CPU;
 11. the bunny intersection-rate workload (scenes/bunny_debug.xml: the
     `debug` integrator, 768x768, 1 spp, one chunk), one frame as in phase
     4 (launches 1 / 0 / 0 a chunk); image checks (the mean |n| over the
     bunny's pixels in (0, 1], the border black, the bunny's share of the
     pixels); a 96x96 render on cuda against the CPU;
 12. cbox under `direct` (scenes/cbox/direct.xml: 2 emitter and 2 BSDF
     samples, 256x256, 64 spp) as in phase 4 (launches 12 / 8 / 0); the
     cbox image checks; a 64x64, 8 spp render on cuda against the CPU;
 13. envlit under `aov` (envlit/aov.xml: depth, position, uv and both
     normals beside a nested path of max_depth 5) at 256x256, 64 spp, as in
     phase 4 (launches 24 / 16 / 52); checks on pixels well inside one
     class: depth > 0 on the floor and the bunny and 0 on the sky, uv in
     [0, 1] on the floor, shading normals of unit length (within 1e-4 on
     the flat floor, 2e-2 on the curved bunny, whose normals the filter
     averages over a pixel); a 64x64, 4 spp
     render on cuda against the CPU, every AOV and the RGB;
 14. checkpoint on the card: cbox at 128x128, 16 spp in 16 chunks of 2^14
     lanes, snapshots every 4 chunks, stopped by a progress callback that
     raises after chunk 9, then resumed: the film equal to the bit to an
     uninterrupted render's; the CLI on cuda writes envlit/aov.xml's EXR and
     one EXR per AOV, read back with tests/test_torch_driver.py's reader;
 15. gradients (misaki_tpu_torch.diff): (a) five Adam steps of train_step on
     cbox at the benchmark spec (depth cap 4, leaves materials, rad_coeff,
     rad_curve) toward a target rendered with the red wall's reflectance
     slot taken from the green wall's column: the loss falls, every
     gradient is finite, the red wall's slot has a gradient, the step-0
     directional FD agrees within 10%, each step's launches are one
     autograd pass's, the same step's gradients on CUDA and on the CPU at
     64x48 x 16 spp within 1e-4 relative L1;
     (b) one image_grads of the image mean over bitmaps and env_rgb on
     envlit at the same spec: backward fetch launches equal the forward
     fetches, directional FDs within 5%, the same gradient on CUDA and on
     the CPU at 48x36 x 8 spp (depth cap 2) within 1e-4 relative L1, and where that gap
     comes from (the plain twin's sums with the taps or the output
     gradients of one device and the rest of the other's); (c) the fetch's
     backward kernel against its index_add_ twin (allclose rtol 1e-5, atol
     1e-6 of the largest magnitude, in each of 10 calls: atomic order varies
     from run to run) on the taps of every backward launch of that gradient
     (2^22 lanes each) and at 2^20 lanes on phase 6's env_random,
     bitmap_camera_mips and env_nee taps, beside its scratch's zeroing and
     finalize alone and the library call index_add_;
 16. volpath and participating media: (a) the teapot stand-in
     (misaki_tpu_torch/scenes/teapot/: glass holding a homogeneous medium,
     a null sphere holding a scattering one) at its declared 1280x720, 128
     spp, depth cap 8, one frame as in phase 4 (closest hit 1 + 5 x 8 a
     chunk, no any hit, no fetch); image checks (finite, non-negative, each
     medium's pixels changed by the media, against a 160x90 render with the
     media's scale 0); a 64x36, 4 spp render (depth cap 2) on cuda against
     the CPU; (b) the grid-volume scene (scenes/volume/, its 64^3 grid
     written into build/scenes/volume/<hash>/ at first use) at 256x256, 64
     spp, depth cap 4 (launches 21 / 0 / 0 a chunk), image checks and a
     small CUDA-vs-CPU render; (c) one image_grads of the image mean over
     sigma_s_amp, sigma_a_amp and medium_scale on the teapot at 256x256 x
     64 spp and over volumes on the grid at 128x128 x 16 spp (2^18 lanes: a
     grid's 32-step marches keep their activations), each with its
     launches, a directional FD within 10% on the media's transmittance
     (where the estimator is smooth in the leaf; the image's FD is reported
     beside it), and the same gradients on CUDA and on the CPU at 48x27 x 8
     spp (depth cap 2) within 1e-4 relative L1;
 17. sppm and photonmapper (render/ppm.py): (a) cbox under sppm
     (scenes/cbox/sppm.xml) at 256x256, 262,144 photons a pass, 8
     iterations, depth budget 5, one frame through render() on cuda with
     its launches checked against ppm.launches_per_iteration (closest hit
     10, any hit 5, density 4 an iteration); image checks (finite, red
     left, green right, alpha, the mean within 20% of a 256x256 64 spp path
     frame's and the luminance of 4x4-pixel means correlated with it above
     0.9, as tests/test_ppm.py compares them); (b) the photonmapper
     (photonmapper.xml) the same way (10 / 0 / 5; 25% and 0.85); (c) envlit
     under sppm at 256x256, the same photons and iterations: envmap photon
     emission, bitmap visible points, the texel fetch's launches checked;
     (d) the gallery under sppm reduced to 128x128, 2^14 photons, 2
     iterations: glossy visible points (the plain pair path), point and
     constant-environment photons; (e) the density estimate's grid kernel
     against its twin on the first splatted depth of (a)'s and (b)'s frames
     (262,144 photons against 65,536 visible points, with the frame's grid)
     and on the adversarial mix of tools/profile_ppm_density.py: counts
     equal, phi allclose (rtol 1e-5, atol 1e-6 of the largest magnitude) in
     each of 10 calls and equal to the bit between calls; the kernel's and
     the twin's device times, the CUDA launches of one estimate, the pairs
     it tested and the bound (inputs read and outputs written once, against
     the passing pairs' operations); (f) a 64x48 cbox sppm render (8192
     photons, 2 iterations) on cuda against the CPU; (g) a cbox sppm render
     (128x128, 2^16 photons, 4 iterations) stopped after iteration 3 and
     resumed from the per-iteration snapshot: equal to the bit;
 18. sharding (parallel/sharding.py) on the one card: (a) world size 1 over
     NCCL, a render_sharded frame of cbox at the benchmark spec beside a
     render() frame of the same seed (the films equal to the bit), its
     launches as phase 4's; (b) train_step_sharded at world size 1 beside
     train_step on phase 15 (a)'s step (loss rtol 1e-6, gradients within
     1e-5 relative L1), its launches one pass's; (c) two processes that
     share the card over gloo: render_sharded on a (2,) mesh and
     render_sharded_2d on (1, 2) and (2, 1) against (a)'s film,
     train_step_sharded on (2,) against (b)'s gradients, every rank's
     results the same, then dryrun_multichip(2);
 19. the PCG32 kernel (csrc/pcg32.cu) against its plain twins in
     core/rng.py on the card, at 2^20 and 2^22 lanes: a seeding of
     driver.make_rng's streams and a group of 6 draws, limbs and floats equal
     to the bit; both device times and each entry point's bound (bytes: a
     seeding reads 8 B of lanes and writes 32 B of state a lane, a group of
     k draws reads 32 B and writes 16 + 4k B).
Frames pass `quiet`, a progress callback that reports nothing, so the
driver's progress log stays out of the output. Every kernel time is a
device time taken one way (`profile_cluster_frame.device_ms`: CUDA events
around launches enqueued while a device sleep holds the stream, so the
host's launch cost is not in it). Then one JSON line with the kernels'
numbers, and last the result line {"ok": true, "device": {...}}. Extra
detail goes to chiprun_out/.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
CBOX_XML = ROOT / "misaki_tpu_torch" / "scenes" / "cbox" / "scene.xml"
SCENES = ROOT / "misaki_tpu_torch" / "scenes"
SCENE_BUILD = ROOT / "build" / "scenes" / "envlit"
GALLERY_BUILD = ROOT / "build" / "scenes" / "materials"
TESTBALL_DIR = ROOT / "misaki_tpu_torch" / "scenes" / "testball"
TEAPOT_XML = SCENES / "teapot" / "scene.xml"
VOLUME_BUILD = ROOT / "build" / "scenes" / "volume"

# benchmark spec of the main path (bench.py:29-67)
BENCH_W, BENCH_H, BENCH_SPP, BENCH_DEPTH, BENCH_CHUNK = 256, 256, 64, 4, 1 << 20
N_RAYS = 1 << 20
# depth cap of the CPU halves of phases 15 and 16's CUDA-vs-CPU gradients and
# of the teapot's CUDA-vs-CPU render: the CPU casts scan every cluster on
# incoherent rays, and at depth 4 those halves took 141, 158 and 60 s of
# the script's time limit
CPU_CHECK_DEPTH = 2
# photons a pass and iterations of phase 17's frames (scenes/cbox/sppm.xml)
PPM_PHOTONS, PPM_ITERS = 262144, 8


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def phase(name, msg):
    print(f"[{name}] {msg} [t+{time.perf_counter() - T_START:.1f} s]", flush=True)


def camera_like_rays(n, center, extent, gen):
    """Rays from a point outside the box toward points inside it, in
    consecutive-lane order of a 2D raster (coherent tiles)."""
    import torch

    side = int(n ** 0.5)
    ij = torch.arange(n, device="cuda")
    u = (ij % side).float() / side - 0.5
    v = (ij // side).float() / side - 0.5
    eye = center + torch.tensor([0.0, 0.0, -3.0], device="cuda") * extent
    tgt = torch.stack([center[0] + u * 1.2 * extent, center[1] + v * 1.2 * extent,
                       center[2].expand(n)])
    d = tgt - eye[:, None]
    d = d / torch.linalg.norm(d, dim=0, keepdim=True)
    o = eye[:, None].expand(3, n)
    return o, d


def random_rays(n, lo, hi, gen):
    import torch

    o = lo[:, None] + (hi - lo)[:, None] * torch.rand((3, n), device="cuda", generator=gen)
    d = torch.randn((3, n), device="cuda", generator=gen)
    d = d / torch.linalg.norm(d, dim=0, keepdim=True)
    return o, d


def quiet(done, total):
    """A progress callback that reports nothing: keeps the driver's log
    lines out of the phases' output."""


def compare_kernels(acc, o, d, maxt_shadow, label, report, copy_from=None):
    """Closest-hit and any-hit kernels vs their plain twins on one ray set,
    with both times and each cast's bound. `copy_from`: the first face id of
    a copy of the faces before it; the copy must win >= 99.9% of the hits in
    kernel and twin (every hit is an exact tie, and the larger id wins)."""
    import torch

    from misaki_tpu_torch.accel import cluster as cl
    from misaki_tpu_torch.tools.profile_cluster_frame import any_bound, closest_bound, device_ms

    n = o.shape[1]
    mint = torch.full((n,), 1e-4, device="cuda")
    rays = cl.pack_rays(tuple(o), tuple(d), mint, torch.full((n,), float("inf"), device="cuda"))
    out_k, fd_k = cl.closest_hit(rays, acc)
    out_p, fd_p = cl.closest_hit_plain(rays, acc)
    torch.cuda.synchronize()
    prim_k, prim_p = out_k[3], out_p[3]
    same = prim_k == prim_p
    frac = same.float().mean().item()
    hit = same & (prim_p >= 0)
    t_err = (out_k[0] - out_p[0]).abs()[hit]
    t_rel = (t_err / out_p[0].abs()[hit].clamp(min=1e-30)).max().item() if hit.any() else 0.0
    t_abs = t_err.max().item() if hit.any() else 0.0
    fd_ok = bool(torch.equal(fd_k[:, same], fd_p[:, same]))
    hit_frac = (prim_p >= 0).float().mean().item()
    copy_won = None
    if copy_from is not None:
        copy_won = [((p[p >= 0] >= copy_from).float().mean().item()) for p in (prim_k, prim_p)]

    srays = cl.pack_rays(tuple(o), tuple(d), mint, maxt_shadow)
    occ_k = cl.any_hit(srays, acc)
    occ_p = cl.any_hit_plain(srays, acc)
    torch.cuda.synchronize()
    occ_frac = (occ_k == occ_p).float().mean().item()
    occ_rate = occ_p.mean().item()

    ms_c = device_ms(lambda: cl.closest_hit(rays, acc), 10)
    ms_cp = device_ms(lambda: cl.closest_hit_plain(rays, acc), 1)
    ms_a = device_ms(lambda: cl.any_hit(srays, acc), 10)
    ms_ap = device_ms(lambda: cl.any_hit_plain(srays, acc), 1)
    bc, bc_by = closest_bound(rays, acc, out_p)
    ba, ba_by = any_bound(srays, acc, occ_p)
    _, _, count = cl.cull_order(rays, acc.bounds, acc.n_clusters)
    full = (count < 0).float().mean().item()
    visits = count.abs().float().mean().item()
    phase("3", f"{label}: rays={n} clusters={acc.n_clusters} nodes={acc.nodes.shape[0]} "
               f"hit={hit_frac:.4f} (plain twin's tiles: full_scan={full:.4f} "
               f"mean_visit_list={visits:.2f}) | closest: prim_equal={frac:.6f} "
               f"t_max_rel={t_rel:.3e} fd_exact={fd_ok} kernel_ms={ms_c:.4f} "
               f"plain_ms={ms_cp:.4f} bound_ms={bc:.4f} ({bc_by})"
               + ("" if copy_won is None else
                  f" copy_won kernel={copy_won[0]:.6f} plain={copy_won[1]:.6f}")
               + f" | any-hit: occluded={occ_rate:.4f} equal={occ_frac:.6f} "
                 f"kernel_ms={ms_a:.4f} plain_ms={ms_ap:.4f} bound_ms={ba:.4f} ({ba_by})")
    ok = frac >= 0.999 and t_rel <= 1e-5 and fd_ok and occ_frac >= 0.9999
    if copy_won is not None:
        ok = ok and min(copy_won) >= 0.999
    report[label] = dict(prim_equal=frac, t_max_rel=t_rel, t_max_abs=t_abs, fd_exact=fd_ok,
                         occ_equal=occ_frac, closest_ms=ms_c, closest_plain_ms=ms_cp,
                         closest_bound_ms=bc, closest_bound_by=bc_by,
                         anyhit_ms=ms_a, anyhit_plain_ms=ms_ap, anyhit_bound_ms=ba,
                         anyhit_bound_by=ba_by, copy_won=copy_won,
                         anyhit_max_abs_err=(occ_k - occ_p).abs().max().item())
    if not ok:
        fail(f"phase 3 {label}: kernel disagrees with its plain twin")


def compare_fetch(envlit):
    """The texel-fetch kernel on the envlit scene's cells and split launches
    (misaki_tpu_torch.tools.profile_texel_fetch), held against the plain
    twin to the bit: both add the four products in tap order, each rounded
    (the kernel is built without fused multiply-add). Beside it the library
    call that computes the same sums, F.embedding_bag over the live taps,
    timed and checked to rtol 1e-5 (it may add in another order); the port
    never calls it. Returns {cell: numbers}."""
    from misaki_tpu_torch.tools import profile_texel_fetch as ptf

    res = ptf.profile(envlit, reps=30, out=OUT_DIR / "profile_texel_fetch.md")
    for name, c in res["cells"].items():
        phase("6", f"{name}: lanes={c['lanes']} texels={c['texels']} "
                   f"live_taps={c['live_taps']:.4f} distinct_live_texels="
                   f"{c['distinct_live_texels']} equal_to_twin={c['equal']} "
                   f"kernel_ms={c['ms']:.4f} bound_ms={c['bound_ms']:.4f} ({c['bound_by']}) "
                   f"sector_bytes={c['sector_bytes']} plain_ms={c['plain_ms']:.4f} "
                   f"embedding_bag_ms={c['embedding_bag_ms']:.4f} "
                   f"embedding_bag_rel_err={c['embedding_bag_rel_err']:.3e}")
        if c["embedding_bag_rel_err"] > 1e-5:
            fail(f"phase 6 {name}: embedding_bag does not compute the texel fetch's sums")
    phase("6", f"{len(res['cells'])} cells, all equal to the twin: {res['equal']}; table "
               f"{Path(res['table']).relative_to(ROOT)}")
    if not res["equal"]:
        fail("phase 6: a texel-fetch launch differs from its plain twin")
    return res["cells"]


def reset_counts():
    from misaki_tpu_torch.utils import tracing

    tracing.reset_launches()


def read_counts():
    from misaki_tpu_torch.utils import tracing

    return {k: tracing.launches[k] for k in ("closest", "anyhit", "fetch", "fetch_bwd",
                                             "density")}


def pcg32_per_chunk(scene, depth_cap):
    """The PCG32 launches of a chunk of `scene`: the seeding and the camera's
    group (driver.primary_rays), then one group a bounce under path, one an
    emitter and one a BSDF sample under direct, none under debug, the
    channel's and one a bounce under volpath; aov its nested integrator's."""
    from misaki_tpu_torch.render.integrator import n_bounce_iters, volpath_iters

    name = scene.aov_nested if scene.integrator == "aov" else scene.integrator
    per = {"path": lambda: n_bounce_iters(scene, depth_cap),
           "direct": lambda: (max(scene.direct_light_samples, 1)
                              + max(scene.direct_bsdf_samples, 1)),
           "volpath": lambda: 1 + volpath_iters(scene, depth_cap),
           "debug": lambda: 0}[name]()
    return 2 + per


def checked_frame(scene, label, want_per_chunk, depth_cap=BENCH_DEPTH):
    """One frame of `scene` through render() on cuda in the benchmark's
    chunks, with every launch count set to 0 just before it and read just
    after; fails unless the counts are chunks * `want_per_chunk` (the PCG32
    kernel's chunks * `pcg32_per_chunk`) and the fetch's backward and the
    density estimate never ran. Returns (the frame's output, its
    launches)."""
    import torch

    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.utils import tracing

    n_chunks = -(-scene.film_width * scene.film_height * scene.spp // BENCH_CHUNK)
    reset_counts()
    out = render(scene, seed=1, chunk_size=BENCH_CHUNK, depth_cap=depth_cap, progress=quiet)
    torch.cuda.synchronize()
    launches = {**read_counts(), "pcg32": tracing.launches["pcg32"]}
    # a frame under inference_mode never launches the fetch's backward
    want = {"fetch_bwd": 0, "density": 0, "pcg32": n_chunks * pcg32_per_chunk(scene, depth_cap),
            **{k: n_chunks * v for k, v in want_per_chunk.items()}}
    phase(label, f"{scene.film_width}x{scene.film_height} {scene.spp} spp, {scene.integrator}, "
                 f"depth cap {depth_cap}, {n_chunks} chunks of {BENCH_CHUNK}: launches "
                 f"{launches} expected {want}")
    if launches != want:
        fail(f"phase {label}: kernel launch counts {launches} != expected {want}")
    return out, launches


def cuda_vs_cpu(scene_cpu, label, depth_cap=BENCH_DEPTH, seed=7):
    """The same small render on cuda and on the CPU, compared on the RGB and
    on every AOV: the difference of the image means relative to the mean (a
    signed AOV's to its mean magnitude) < 0.5%, the mean absolute
    difference relative to the mean magnitude < 2%. Returns the largest of
    each over the images."""
    import numpy as np

    from misaki_tpu_torch.render.driver import render

    out_a = render(scene_cpu.to("cuda"), seed=seed, depth_cap=depth_cap)
    out_b = render(scene_cpu, seed=seed, depth_cap=depth_cap)
    res = {}
    for name in ["rgb", *out_b.get("aovs", {})]:
        a, b = ((o["rgb"] if name == "rgb" else o["aovs"][name]).cpu().numpy()
                for o in (out_a, out_b))
        scale = abs(b.mean()) if name == "rgb" else np.abs(b).mean()
        res[name] = {"mean_rel": float(abs(a.mean() - b.mean()) / max(scale, 1e-12)),
                     "l1_rel": float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))}
    samples = (f"{scene_cpu.ppm_photons} photons x {scene_cpu.ppm_iterations} iterations"
               if scene_cpu.integrator in ("sppm", "photonmapper") else f"{scene_cpu.spp} spp")
    for name, r in res.items():
        phase(label, f"{scene_cpu.film_width}x{scene_cpu.film_height} {samples} "
                     f"cuda vs cpu, {name}: mean rel diff {r['mean_rel']:.3e}, relative L1 "
                     f"{r['l1_rel']:.3e}")
    if not all(r["mean_rel"] < 5e-3 and r["l1_rel"] < 2e-2 for r in res.values()):
        fail(f"phase {label}: cuda render disagrees with the cpu render {res}")
    return (max(r["mean_rel"] for r in res.values()), max(r["l1_rel"] for r in res.values()))


def interior(mask, r=3):
    """Pixels whose (2r+1)^2 neighbourhood lies wholly in `mask` (H, W), a
    class read from each pixel's first sample: the reconstruction filter (a
    gaussian of radius 2 pixels) mixes no other class into them."""
    import torch.nn.functional as F

    return -F.max_pool2d(-mask.float()[None, None], 2 * r + 1, 1, r)[0, 0] > 0.5


def phase_debug():
    """Phase 11: the bunny intersection-rate workload. Returns its numbers."""
    import numpy as np

    from misaki_tpu_torch.scene.compiler import load_and_compile

    scene = load_and_compile(str(SCENES / "bunny_debug.xml"))
    out, launches = checked_frame(scene, "11", {"closest": 1, "anyhit": 0, "fetch": 0})
    rgb = out["rgb"].cpu().numpy()
    np.save(OUT_DIR / "bunny_debug_rgb.npy", rgb)
    hit = (rgb > 0).any(axis=-1)
    border = np.concatenate([rgb[:4].ravel(), rgb[-4:].ravel(), rgb[:, :4].ravel(),
                             rgb[:, -4:].ravel()])
    mean_n = float(rgb[hit].mean()) if hit.any() else 0.0
    checks = {"finite": bool(np.isfinite(rgb).all()), "mean_n_in_0_1": 0.0 < mean_n <= 1.0,
              "max_n_le_1": bool(rgb.max() <= 1.0 + 1e-5),
              "border_black": bool(np.abs(border).max() == 0.0),
              "bunny_share": bool(0.05 < hit.mean() < 0.95)}
    phase("11", f"bunny pixels {hit.mean():.4f}, mean |n| there {mean_n:.4f}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 11: image checks failed {checks}")
    small = load_and_compile(str(SCENES / "bunny_debug.xml"), width=96, height=96, device="cpu")
    return {"launches": launches, "cuda_vs_cpu": cuda_vs_cpu(small, "11")}


def phase_direct():
    """Phase 12: cbox under `direct`. Returns its numbers."""
    import numpy as np

    from misaki_tpu_torch.scene.compiler import load_and_compile

    xml = SCENES / "cbox" / "direct.xml"
    scene = load_and_compile(str(xml))
    n_lum, n_bsdf = scene.direct_light_samples, scene.direct_bsdf_samples
    out, launches = checked_frame(scene, "12", {"closest": 1 + n_bsdf, "anyhit": n_lum,
                                                "fetch": 0})
    rgb = out["rgb"].cpu().numpy()
    np.save(OUT_DIR / "cbox_direct_rgb.npy", rgb)
    third = scene.film_width // 3
    left, right = rgb[:, :third], rgb[:, -third:]
    checks = {"finite": bool(np.isfinite(rgb).all()),
              "red_left": bool(left[..., 0].mean() > left[..., 1].mean()),
              "green_right": bool(right[..., 1].mean() > right[..., 0].mean()),
              "lit": bool(rgb.mean() > 0.01)}
    phase("12", f"{n_lum} emitter and {n_bsdf} BSDF samples; image mean "
                f"{rgb.mean(axis=(0, 1)).tolist()}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 12: image checks failed {checks}")
    small = load_and_compile(str(xml), spp=8, width=64, height=64, device="cpu")
    return {"launches": launches, "cuda_vs_cpu": cuda_vs_cpu(small, "12")}


def phase_aov(envlit_xml):
    """Phase 13: envlit under `aov`. Returns its numbers."""
    import numpy as np
    import torch

    from misaki_tpu_torch.render.integrator import n_bounce_iters
    from misaki_tpu_torch.scene.compiler import load_and_compile

    xml = envlit_xml.with_name("aov.xml")
    scene = load_and_compile(str(xml))
    n_iters = n_bounce_iters(scene, BENCH_DEPTH)
    n_bitmaps = len(scene.bitmap_slots) * len(scene.bitmap_meta)
    # the AOV cast, then the nested path's casts and texel fetches (phase 7);
    # the AOV pass fetches no texel
    out, launches = checked_frame(
        scene, "13", {"closest": 2 + n_iters, "anyhit": n_iters,
                      "fetch": 1 + n_iters * (n_bitmaps + 2)})
    aovs = out["aovs"]
    np.save(OUT_DIR / "envlit_aov_rgb.npy", out["rgb"].cpu().numpy())
    for name, img in aovs.items():
        np.save(OUT_DIR / f"envlit_aov_{name}.npy", img.cpu().numpy())
    # pixel classes from each pixel's centre ray: the floor, the bunny, the sky
    si = centre_hits(scene)
    H, W = scene.film_height, scene.film_width
    mat = torch.where(si["valid"], si["bsdf"], -1).reshape(H, W)
    floor_id, bunny_id = (int(x) for x in scene.shape_bsdf.cpu())
    floor, bunny, sky = (interior(mat == k) for k in (floor_id, bunny_id, -1))
    depth, uv = aovs["depth"][..., 0], aovs["uv"]
    n_len = torch.linalg.norm(aovs["sh_normal"], dim=-1)
    hit = floor | bunny
    checks = {
        "classes_seen": bool(floor.sum() > 100 and bunny.sum() > 100 and sky.sum() > 100),
        "depth_floor": bool((depth[floor] > 0).all()),
        "depth_bunny": bool((depth[bunny] > 0).all()),
        "depth_sky_0": bool((depth[sky] == 0).all()),
        "uv_floor_in_0_1": bool(((uv[floor] >= 0) & (uv[floor] <= 1)).all()),
        # the filter averages a pixel's samples: unit length on the flat
        # floor, a little shorter where the bunny curves under the pixel
        "sh_normal_unit_floor": bool((n_len[floor] - 1).abs().max() < 1e-4),
        "sh_normal_unit_bunny": bool((n_len[bunny] - 1).abs().max() < 2e-2),
        "finite": bool(all(torch.isfinite(a).all() for a in aovs.values())
                       and torch.isfinite(out["rgb"]).all()),
    }
    phase("13", f"interior pixels floor {int(floor.sum())}, bunny {int(bunny.sum())}, sky "
                f"{int(sky.sum())}; depth on the floor {depth[floor].min().item():.4f}.."
                f"{depth[floor].max().item():.4f}, uv on the floor {uv[floor].min().item():.4f}.."
                f"{uv[floor].max().item():.4f}, |sh_normal| where hit "
                f"{n_len[hit].min().item():.6f}..{n_len[hit].max().item():.6f}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 13: AOV checks failed {checks}")
    small = load_and_compile(str(xml), spp=4, width=64, height=64, device="cpu")
    return {"launches": launches, "cuda_vs_cpu": cuda_vs_cpu(small, "13")}


def phase_checkpoint(envlit_xml):
    """Phase 14: a render stopped and resumed on the card equals the
    uninterrupted one to the bit; the CLI's EXR files read back."""
    import numpy as np
    import torch

    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile

    scene = load_and_compile(str(CBOX_XML), spp=16, width=128, height=128).replace(
        max_depth=BENCH_DEPTH + 1)
    chunk, ck = 1 << 14, OUT_DIR / "checkpoint.npz"
    ck.unlink(missing_ok=True)
    ref = render(scene, seed=5, chunk_size=chunk, depth_cap=BENCH_DEPTH)

    class Stop(RuntimeError):
        pass

    def stop_after_9(done, total):
        if done == 9:
            raise Stop()

    try:
        render(scene, seed=5, chunk_size=chunk, depth_cap=BENCH_DEPTH, checkpoint_path=str(ck),
               checkpoint_every=4, progress=stop_after_9)
        fail("phase 14: the progress callback did not stop the render")
    except Stop:
        pass
    snapshot_chunk = int(np.load(ck)["next_chunk"]) if ck.exists() else None
    seen = []
    out = render(scene, seed=5, chunk_size=chunk, depth_cap=BENCH_DEPTH, checkpoint_path=str(ck),
                 checkpoint_every=4, progress=lambda done, total: seen.append((done, total)))
    equal = bool(torch.equal(out["film"], ref["film"]))
    checks = {"snapshot_at_8": snapshot_chunk == 8, "resumed_9_to_16": [d for d, _ in seen]
              == list(range(9, 17)), "film_bit_equal": equal, "snapshot_cleared": not ck.exists()}
    phase("14", f"cbox 128x128 16 spp, {seen[-1][1] if seen else '?'} chunks of {chunk}: "
                f"stopped after chunk 9, snapshot at chunk {snapshot_chunk}, resumed through "
                f"chunk {seen[-1][0] if seen else '?'}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 14: checkpoint/resume checks failed {checks}")

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_driver import read_exr

    dest = OUT_DIR / "envlit_aov_cli.exr"
    res = subprocess.run([sys.executable, "-m", "misaki_tpu_torch.cli", str(envlit_xml.with_name(
        "aov.xml")), "-o", str(dest), "--spp", "4", "--width", "64", "--height", "48"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"phase 14: the CLI failed: {res.stderr[-2000:]}")
    files = {dest.name: read_exr(dest)}
    for name in ("depth", "position", "uv", "geo_normal", "sh_normal"):
        path = dest.with_name(f"{dest.stem}_{name}.exr")
        files[path.name] = read_exr(path)
    shapes = {k: (sorted(v), next(iter(v.values())).shape) for k, v in files.items()}
    ok = (sorted(files[dest.name]) == ["A", "B", "G", "R"]
          and all(shape == (48, 64) for _, shape in shapes.values())
          and all(np.isfinite(p).all() for v in files.values() for p in v.values()))
    phase("14", f"CLI on cuda wrote {len(files)} EXR files, read back: {shapes}")
    if not ok:
        fail("phase 14: the CLI's EXR files are not what was rendered")
    return {"snapshot_chunk": snapshot_chunk, "film_bit_equal": equal, "exr_files": shapes}


TRAIN_STEPS = 5
TRAIN_LR = 0.02          # Adam step of a material, in units of the sigmoid's argument
EMITTER_LR = 0.1         # an emitter leaf's step relative to a material's


def lever_lrs(leaves):
    """Per-coordinate Adam steps: TRAIN_LR in the sigmoid's argument divided
    by each coefficient's lever arm (c0 multiplies lambda^2 ~ 600^2, c1
    lambda ~ 600; tests/test_diff_and_sharding.py:52-67); a radiance curve
    moves by TRAIN_LR of its mean magnitude. The emitter leaves take
    EMITTER_LR of that: the light's brightness moves every pixel."""
    import torch

    from misaki_tpu_torch.scene.types import MC_OPACITY, MC_REFL, MC_SPEC_REFL, MC_SPEC_TRANS

    lrs = {}
    for k, v in leaves.items():
        lr = torch.full_like(v, TRAIN_LR, dtype=torch.float64)
        if k == "materials":
            for base in (MC_REFL, MC_SPEC_REFL, MC_SPEC_TRANS, MC_OPACITY):
                for off in (1, 4):
                    lr[base + off] /= 600.0 ** 2
                    lr[base + off + 1] /= 600.0
        elif k == "rad_coeff":
            lr *= EMITTER_LR
            lr[:, 0] /= 600.0 ** 2
            lr[:, 1] /= 600.0
        elif k == "rad_curve":
            lr *= EMITTER_LR * v.abs().mean(dim=1, keepdim=True).double()
        lrs[k] = lr
    return lrs


def rel_l1(got, want):
    """sum |got - want| / sum |want| of two tensors, on the CPU."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().sum() / want.abs().sum().clamp(min=1e-30))


def gradient_passes(scene, chunk_size):
    """The chunks image_grads renders for a gradient of `scene` in
    `chunk_size`-lane chunks: one pass where the frame fits one chunk,
    else the primal's chunks and then the re-render's. -> (every chunk,
    the re-render's chunks)."""
    from misaki_tpu_torch.render import driver

    n = scene.film_width * scene.film_height * scene.spp
    chunks = -(-n // driver.pick_chunk(chunk_size, scene.spp, n))
    if chunks == 1:
        return 1, 1
    return -(-n // driver.pick_chunk(driver.DEFAULT_CHUNK, scene.spp, n)) + chunks, chunks


def train_cbox(**kw):
    """Phase 15 (a)'s training case: cbox (load_and_compile's `kw`) at
    max_depth BENCH_DEPTH + 1 and its target, rendered with the red wall's
    reflectance slot taken from the green wall's column -> (scene, target
    rgb, the red wall's material column)."""
    from misaki_tpu_torch.diff import replace_leaves
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.scene.types import MC_REFL, SPEC_SLOT_COLS

    slot = slice(MC_REFL, MC_REFL + SPEC_SLOT_COLS)
    scene = load_and_compile(str(CBOX_XML), **kw).replace(max_depth=BENCH_DEPTH + 1)
    red, green = (int(scene.shape_bsdf[i]) for i in (5, 4))   # scene.xml's shape order
    mats = scene.materials.params.clone()
    mats[slot, red] = mats[slot, green]
    target = render(replace_leaves(scene, {"materials": mats}), seed=0,
                    depth_cap=BENCH_DEPTH, progress=quiet)["rgb"]
    return scene, target, red


def phase_train():
    """Phase 15 (a): five Adam steps of train_step on cbox at the benchmark
    spec from the original materials toward a target rendered with the red
    wall's reflectance slot taken from the green wall's column; the same
    step's gradients on the card and on the CPU at phase 5's reduced size.
    Returns its numbers."""
    import numpy as np
    import torch

    from misaki_tpu_torch.diff import get_leaves, replace_leaves
    from misaki_tpu_torch.diff.backprop import GRAD_CHUNK
    from misaki_tpu_torch.diff.train import DEFAULT_TRAIN_LEAVES, lever_direction, train_step
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.types import MC_REFL, SPEC_SLOT_COLS

    slot = slice(MC_REFL, MC_REFL + SPEC_SLOT_COLS)
    scene, target, red = train_cbox(spp=BENCH_SPP, width=BENCH_W, height=BENCH_H)

    def loss_of(values):
        out = render(replace_leaves(scene, values), seed=0, depth_cap=BENCH_DEPTH,
                     progress=quiet)
        return float(torch.mean((out["rgb"].double() - target.double()) ** 2))

    values = {k: v.clone() for k, v in get_leaves(scene, DEFAULT_TRAIN_LEAVES).items()}
    lrs = lever_lrs(values)
    m1 = {k: torch.zeros_like(v, dtype=torch.float64) for k, v in values.items()}
    m2 = {k: torch.zeros_like(v, dtype=torch.float64) for k, v in values.items()}
    eps = {}
    losses, launches, finite = [], [], True
    for step in range(1, TRAIN_STEPS + 1):
        reset_counts()
        loss, grads = train_step(replace_leaves(scene, values), target, seed=0,
                                 depth_cap=BENCH_DEPTH)
        torch.cuda.synchronize()
        launches.append(read_counts())
        losses.append(float(loss))
        finite &= all(bool(torch.isfinite(g).all()) for g in grads.values())
        if step == 1:
            g0 = {k: g.clone() for k, g in grads.items()}
        for k, g in grads.items():
            g = g.double()
            eps.setdefault(k, 1e-6 * max(g.abs().max().item(), 1e-30))
            m1[k].mul_(0.9).add_(0.1 * g)
            m2[k].mul_(0.999).add_(0.001 * g * g)
            upd = lrs[k] * (m1[k] / (1 - 0.9 ** step)) / (
                torch.sqrt(m2[k] / (1 - 0.999 ** step)) + eps[k])
            values[k] = (values[k].double() - upd).float()
        phase("15", f"cbox train step {step}: loss {float(loss):.6e}; launches {launches[-1]}")
    final = loss_of(values)
    g_mats = g0["materials"].cpu().numpy()
    red_grad = float(np.abs(g_mats[np.arange(slot.start, slot.stop), red]).max())
    # the directional FD of the step-0 gradient
    v0 = get_leaves(scene, ("materials",))["materials"]
    dc = lever_direction(g_mats)
    dct = torch.as_tensor(dc, device=v0.device)
    fd = (loss_of({"materials": v0 + dct}) - loss_of({"materials": v0 - dct})) / 2.0
    expected = float(np.sum(g_mats.astype(np.float64) * dc))
    # the same step's gradients on the CPU and on the card at phase 5's size:
    # the materials' one-hot matmul backward, the emitter leaves
    small, small_target, _ = train_cbox(spp=16, width=64, height=48, device="cpu")
    _, g_cpu = train_step(small, small_target, seed=7, depth_cap=BENCH_DEPTH)
    _, g_cuda = train_step(small.to("cuda"), small_target.cuda(), seed=7, depth_cap=BENCH_DEPTH)
    l1 = {k: rel_l1(g_cuda[k], g_cpu[k]) for k in DEFAULT_TRAIN_LEAVES}
    n_passes, _ = gradient_passes(scene, GRAD_CHUNK)
    want = {"closest": n_passes * (1 + BENCH_DEPTH), "anyhit": n_passes * BENCH_DEPTH,
            "fetch": 0, "fetch_bwd": 0, "density": 0}
    checks = {"loss_falls": final < losses[0], "grads_finite": finite,
              "red_wall_grad_nonzero": red_grad > 0.0,
              "fd_within_10pct": expected > 0 and abs(fd - expected)
              <= 0.1 * max(abs(fd), abs(expected)),
              "launches": all(n == want for n in launches),
              **{f"cuda_vs_cpu_{k}": v < 1e-4 for k, v in l1.items()}}
    phase("15", f"cbox 256x256 64 spp, depth cap {BENCH_DEPTH}, leaves {DEFAULT_TRAIN_LEAVES}: "
                f"loss {losses[0]:.6e} before step 1, {final:.6e} after step {TRAIN_STEPS}; "
                f"red wall's largest slot gradient {red_grad:.3e}; directional FD {fd:.6e} "
                f"against grad . dc {expected:.6e}; launches per step {launches[0]} "
                f"expected {want}; 64x48 16 spp CUDA vs CPU relative L1 {l1}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 15: cbox training checks failed {checks}")
    return {"losses": losses, "final_loss": final, "cuda_vs_cpu_l1": l1,
            "fd": fd, "grad_dot_dc": expected, "red_wall_grad": red_grad,
            "launches": {k: sum(n[k] for n in launches) for k in want},
            "frames": TRAIN_STEPS}


def captured_gradient(scene, names, loss_fn):
    """One image_grads at phase 7's reduced size (seed 7, depth cap
    CPU_CHECK_DEPTH) with the taps of every backward launch captured: ->
    (gradients, [(idx4, w4, grad_out, n)] on the CPU)."""
    import torch

    from misaki_tpu_torch.diff.backprop import image_grads
    from misaki_tpu_torch.tools import profile_texel_fetch as ptf

    with ptf.captured_backward() as taps:
        _, _, grads = image_grads(scene, names, loss_fn, seed=7, depth_cap=CPU_CHECK_DEPTH)
    return grads, [tuple(x.cpu() if torch.is_tensor(x) else x for x in t) for t in taps]


def gap_anatomy(taps_cpu, taps_cuda, sizes):
    """Where a CUDA and a CPU gradient part: from the taps (idx4, w4) and
    output gradients (grad_out) of every backward launch on each device, the
    plain twin sums each leaf's gradient on the CPU from the CUDA taps with
    the CPU grad_out ("taps") and from the CPU taps with the CUDA grad_out
    ("grad_out"). Returns {leaf: the relative L1 of each and of the CUDA
    sums against the CPU's, and the share of taps whose id differs}, or
    None where the launches' shapes differ between the devices."""
    from misaki_tpu_torch.render import texel_fetch as tf

    if [t[0].shape for t in taps_cpu] != [t[0].shape for t in taps_cuda]:
        return None
    res = {}
    for leaf, n in sizes.items():
        pairs = [(p, c) for p, c in zip(taps_cpu, taps_cuda) if p[3] == n]

        def total(pick):
            return sum(tf.fetch4_backward_plain(*pick(p, c), n) for p, c in pairs)

        cpu = total(lambda p, c: p[:3])
        res[leaf] = {
            "cuda": rel_l1(total(lambda p, c: c[:3]), cpu),
            "taps": rel_l1(total(lambda p, c: (c[0], c[1], p[2])), cpu),
            "grad_out": rel_l1(total(lambda p, c: (p[0], p[1], c[2])), cpu),
            "ids_differ": sum(int((p[0] != c[0]).sum()) for p, c in pairs)
            / max(sum(p[0].numel() for p, _ in pairs), 1)}
    return res


def phase_envlit_grad(envlit_xml, envlit):
    """Phase 15 (b)-(c): one image_grads over bitmaps and env_rgb on envlit
    at the benchmark spec (launches, directional FDs, CUDA against the CPU
    at phase 7's reduced size, with the anatomy of their gap); the backward
    kernel against its twin and index_add_ on the taps of the gradient's
    own launches and at 2^20 lanes on phase 6's cells. Returns its
    numbers."""
    import torch

    from misaki_tpu_torch.diff import get_leaves, replace_leaves
    from misaki_tpu_torch.diff.backprop import GRAD_CHUNK, image_grads
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.render.integrator import n_bounce_iters
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.tools import profile_texel_fetch as ptf

    names = ("bitmaps", "env_rgb")

    def mean_loss(rgb):
        return rgb.mean()

    reset_counts()
    loss, _, grads = image_grads(envlit, names, mean_loss, seed=0, depth_cap=BENCH_DEPTH)
    torch.cuda.synchronize()
    launches = read_counts()
    n_iters = n_bounce_iters(envlit, BENCH_DEPTH)
    per_chunk = 1 + n_iters * (len(envlit.bitmap_slots) * len(envlit.bitmap_meta) + 2)
    n_passes, n_chunks = gradient_passes(envlit, GRAD_CHUNK)
    want = {"closest": n_passes * (1 + n_iters), "anyhit": n_passes * n_iters,
            "fetch": n_passes * per_chunk, "fetch_bwd": n_chunks * per_chunk,
            "density": 0}

    def loss_at(values):
        out = render(replace_leaves(envlit, values), seed=0, depth_cap=BENCH_DEPTH,
                     progress=quiet)
        return float(out["rgb"].double().mean())

    # steps along sign(g), each a share of its texel's value: the spectral
    # lift clamps at 0 (render/textures.py, emitter/kernels.py), so a step
    # that took a dark texel below 0 would leave the linear range
    fds = {}
    for leaf, step in (("env_rgb", 0.05), ("bitmaps", 0.02)):
        v0 = get_leaves(envlit, (leaf,))[leaf]
        d = torch.sign(grads[leaf]) * step * v0.abs()
        fd = (loss_at({leaf: v0 + d}) - loss_at({leaf: v0 - d})) / 2.0
        expected = float((grads[leaf].double() * d.double()).sum())
        fds[leaf] = {"fd": fd, "grad_dot_d": expected,
                     "ok": expected > 0 and abs(fd - expected) <= 0.05 * abs(expected)}
    # the same gradient on the CPU and on the card at phase 7's reduced size
    small = load_and_compile(str(envlit_xml), spp=8, width=48, height=36, device="cpu")
    g_cpu, taps_cpu = captured_gradient(small, names, mean_loss)
    g_cuda, taps_cuda = captured_gradient(small.to("cuda"), names, mean_loss)
    l1 = {k: rel_l1(g_cuda[k], g_cpu[k]) for k in names}
    anatomy = gap_anatomy(taps_cpu, taps_cuda, {
        "bitmaps": small.bitmaps.shape[0],
        "env_rgb": small.emitters.env_rgb.reshape(-1, 3).shape[0]})
    checks = {"grads_finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
              "launches": launches == want,
              **{f"fd_{k}": v["ok"] for k, v in fds.items()},
              **{f"cuda_vs_cpu_{k}": v < 1e-4 for k, v in l1.items()}}
    phase("15", f"envlit 256x256 64 spp gradient of the image mean over {names}: "
                f"launches {launches} expected {want}; "
                f"directional FD {fds}; 48x36 8 spp CUDA vs CPU (depth cap {CPU_CHECK_DEPTH}) "
                f"relative L1 {l1}; the gap's anatomy "
                f"(relative L1 of the twin's sums from the CUDA taps or the CUDA grad_out, "
                f"the other half the CPU's) {anatomy}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 15: envlit gradient checks failed {checks}")

    # (c) the backward kernel against its twin and index_add_, on the taps of
    # the gradient's own launches and at 2^20 lanes on phase 6's cells
    main_taps = ptf.gradient_taps(envlit, names, depth_cap=BENCH_DEPTH)
    on_path = ptf.profile_gradient_taps(main_taps, reps=10)
    del main_taps
    # (allclose in each of ptf.CHECKS calls per set of taps: atomic order
    # varies from run to run; kernel_ms includes the scratch's zeroing and
    # the finalize, which writes the gradient, and finalize_ms is that part:
    # the call less its reduction kernel alone)
    for k, c in enumerate(on_path["launches"]):
        phase("15", f"backward launch {k} of the gradient: lanes={c['lanes']} "
                    f"texels={c['texels']} distinct_live_texels={c['distinct_live_texels']} "
                    f"allclose={c['allclose']} (x{c['checks']}) "
                    f"max_abs_err={c['max_abs_err']:.3e} (scale {c['scale']:.3e}, "
                    f"tolerance used {c['tolerance_used']:.3f}) "
                    f"kernel_ms={c['ms']:.4f} finalize_ms={c['finalize_ms']:.4f} "
                    f"bound_ms={c['bound_ms']:.4f} share={c['bound_ms'] / c['ms']:.3f} "
                    f"plain_ms={c['plain_ms']:.4f} index_add_ms={c['index_add_ms']:.4f}")
    phase("15", f"backward, the gradient's {len(on_path['launches'])} launches: kernel "
                f"{on_path['ms']:.4f} ms (finalize {on_path['finalize_ms']:.4f} ms), bound "
                f"{on_path['bound_ms']:.4f} ms ({on_path['bound_by']}), plain "
                f"{on_path['plain_ms']:.4f} ms, index_add_ {on_path['index_add_ms']:.4f} ms; "
                f"all allclose {on_path['allclose']}")
    bwd = ptf.profile_backward(envlit, reps=30)
    for name, c in bwd.items():
        phase("15", f"backward {name}: lanes={c['lanes']} texels={c['texels']} "
                    f"distinct_live_texels={c['distinct_live_texels']} allclose={c['allclose']} "
                    f"(x{c['checks']}) max_abs_err={c['max_abs_err']:.3e} (scale "
                    f"{c['scale']:.3e}, tolerance used {c['tolerance_used']:.3f}) "
                    f"kernel_ms={c['ms']:.4f} "
                    f"finalize_ms={c['finalize_ms']:.4f} bound_ms={c['bound_ms']:.4f} "
                    f"({c['bound_by']}) share={c['bound_ms'] / c['ms']:.3f} "
                    f"rmw_bound_ms={c['rmw_bound_ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                    f"index_add_ms={c['index_add_ms']:.4f} "
                    f"index_add_allclose={c['index_add_allclose']}")
    if not (on_path["allclose"] and all(c["allclose"] for c in bwd.values())):
        fail("phase 15: the texel-fetch backward kernel disagrees with its plain twin")
    return {"loss": float(loss), "launches": launches, "fd": fds,
            "cuda_vs_cpu_l1": l1, "gap_anatomy": anatomy, "backward_on_path": on_path,
            "backward_kernel": bwd, "frames": 1}


TEAPOT_DEPTH = 8        # tools/flagship_renders.py's depth cap of the teapot
VOL_GRAD_LANES = 1 << 18


def medium_masks(scene):
    """{medium id: (H, W) bool} of the pixels whose pixel-centre camera ray
    first meets that medium's boundary, eroded by the filter's reach
    (`interior`)."""
    import torch

    from misaki_tpu_torch.accel import traverse
    from misaki_tpu_torch.render import camera as cam
    from misaki_tpu_torch.render import interaction as inter

    W, H = scene.film_width, scene.film_height
    pix = torch.arange(W * H, device=scene.device)
    pos = ((pix % W).float() + 0.5, (pix // W).float() + 0.5)
    ray = cam.sample_ray_differential(scene.camera, pos, torch.full((W * H,), 0.5,
                                                                    device=scene.device))
    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    si = inter.compute_interaction(scene, hit, ray["o"], ray["d"], ray["wavelengths"])
    med = si["med_int"].reshape(H, W)
    return {m: interior(med == m).cpu().numpy() for m in range(scene.media.kind.shape[0])}


def transmittance_fd(scene, leaf, step_rel=0.01, n=1 << 16, seed=12):
    """The medium's transmittance through the port's own stages, where a
    frame's estimator is smooth in the leaf: the sum of
    `_attenuated_transmittance` over `n` shadow rays from inside each of the
    teapot's media to its far side (sigma leaves), or of
    `transmittance_ray` across the grid's unit cube (`volumes`). -> (its
    directional central difference along sign(g), g . step, g finite)."""
    import torch

    from misaki_tpu_torch.diff import get_leaves, replace_leaves
    from misaki_tpu_torch.render import integrator as integ
    from misaki_tpu_torch.render import medium as med

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    wav = 360.0 + 470.0 * rnd(4, n)
    if leaf == "volumes":
        m12 = scene.volume_meta[0][4]
        lift = m12[7]   # the unit cube's y offset in world (a translation)
        o = (torch.full((n,), -0.2, device=dev), 0.1 + 0.8 * rnd(n) - lift, 0.1 + 0.8 * rnd(n))
        d = (torch.ones(n, device=dev), torch.zeros(n, device=dev), torch.zeros(n, device=dev))
        ids = torch.zeros(n, dtype=torch.int32, device=dev)

        def f(sc):
            mp = med.fetch_medium(sc, ids, wav)
            return med.transmittance_ray(sc, mp, ids, o, d, torch.full((n,), 1.6,
                                                                        device=dev)).sum()
    else:
        centre = torch.tensor([[0.0, 1.0, 0.0], [1.9, 0.6, 0.6]], device=dev)
        which = (rnd(n) < 0.5).long()
        radius = torch.where(which == 1, 0.6, 1.0)[:, None]

        def on_sphere():
            a = torch.randn(n, 3, device=dev, generator=gen)
            return centre[which] + 0.8 * radius * a / a.norm(dim=1, keepdim=True)

        p, q = on_sphere(), on_sphere()
        dist = (q - p).norm(dim=1)
        dn = (q - p) / dist[:, None]
        ids = which.to(torch.int32)

        def f(sc):
            return integ._attenuated_transmittance(sc, tuple(p.T), tuple(dn.T), dist, ids,
                                                   wav).sum()

    v0 = get_leaves(scene, (leaf,))[leaf]
    x = v0.detach().clone().requires_grad_()
    f(replace_leaves(scene, {leaf: x})).backward()
    g = x.grad.double()
    step = torch.sign(g) * (step_rel if leaf == "volumes" else step_rel * v0.double().abs())
    with torch.no_grad():
        fd = (float(f(replace_leaves(scene, {leaf: (v0.double() + step).float()})))
              - float(f(replace_leaves(scene, {leaf: (v0.double() - step).float()})))) / 2.0
    return fd, float((g * step).sum()), bool(torch.isfinite(g).all())


def media_gradient(scene, names, label, chunk_size, fd_leaves):
    """One image_grads of the image mean over the media leaves `names` on
    cuda with the launches counted, the transmittance FD of each of
    `fd_leaves`, and the image-level FD of the first leaf beside it
    (reported only: a frame's estimator at a fixed seed is piecewise
    constant in sigma, and the pathwise gradient leaves the flips out).
    Returns its numbers and checks."""
    import torch

    from misaki_tpu_torch.diff import get_leaves, replace_leaves
    from misaki_tpu_torch.diff.backprop import image_grads
    from misaki_tpu_torch.render.driver import render

    reset_counts()
    _, _, grads = image_grads(scene, names, lambda r: r.mean(), seed=7, depth_cap=BENCH_DEPTH,
                              chunk_size=chunk_size)
    torch.cuda.synchronize()
    launches = read_counts()
    passes, chunks = gradient_passes(scene, chunk_size)
    per_pass = 1 + 5 * BENCH_DEPTH
    want = {"closest": passes * per_pass, "anyhit": 0, "fetch": 0, "fetch_bwd": 0, "density": 0}
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    fds = {k: transmittance_fd(scene, k) for k in fd_leaves}
    lead = names[0]
    g0 = grads[lead].double()
    v0 = get_leaves(scene, (lead,))[lead].double()
    dv = torch.sign(g0) * 0.01 * v0.abs().clamp(min=1e-3)

    def mean_at(v):
        out = render(replace_leaves(scene, {lead: v.float()}), seed=7, depth_cap=BENCH_DEPTH,
                     progress=quiet)
        return float(out["rgb"].double().mean())

    image_fd = (mean_at(v0 + dv) - mean_at(v0 - dv)) / 2.0
    image_gd = float((g0 * dv).sum())
    checks = {"grads_finite": finite, "launches": launches == want,
              **{f"fd_{k}": r[2] and r[1] > 0 and abs(r[0] - r[1]) <= 0.1 * abs(r[1])
                 for k, r in fds.items()}}
    one_pass = chunks == 1
    n_lanes = scene.film_width * scene.film_height * scene.spp
    phase("16", f"{label} {scene.film_width}x{scene.film_height} {scene.spp} spp gradient of the "
                f"image mean over {names}, depth cap {BENCH_DEPTH}: {passes} chunks rendered"
                + ("" if one_pass else f" (the frame's {n_lanes} lanes exceed one pass of "
                                       f"{chunk_size}: image_grads' chunked path)")
                + f"; launches {launches} expected {want}; |g| "
                + ", ".join(f"{k} {float(g.abs().sum()):.4e}" for k, g in grads.items())
                + "; transmittance FD against g . step: "
                + ", ".join(f"{k} {r[0]:.6e} / {r[1]:.6e}" for k, r in fds.items())
                + f"; image FD of {lead} {image_fd:.6e} against g . step {image_gd:.6e} "
                  f"(reported, not checked); checks {checks}")
    if not all(checks.values()):
        fail(f"phase 16: {label} gradient checks failed {checks}")
    return {"launches": launches, "transmittance_fd": fds, "image_fd": image_fd,
            "image_grad_dot_step": image_gd, "one_pass": one_pass, "frames": 1}


def phase_volpath():
    """Phase 16: volpath and participating media. (a) The teapot stand-in
    at its declared 1280x720 x 128 spp, depth cap 8; (b) the grid-volume
    scene at the benchmark spec; (c) media gradients. Returns the numbers
    for chip_smoke.json."""
    import numpy as np
    import torch

    from misaki_tpu_torch.diff import replace_leaves
    from misaki_tpu_torch.diff.backprop import GRAD_CHUNK, image_grads
    from misaki_tpu_torch.render import driver
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.scenes.volume import assets as volume_assets

    out = {}
    # ---- (a) the teapot stand-in at its declared spec
    tp = load_and_compile(str(TEAPOT_XML))
    phase("16", f"teapot {TEAPOT_XML.relative_to(ROOT)}: {tp.n_faces} faces, "
                f"{tp.cluster.n_clusters} clusters, BSDF kinds {tp.bsdf_kinds}, media "
                f"{tp.media.kind.shape[0]}, max_depth {tp.max_depth}")
    frame_out, launches = checked_frame(
        tp, "16", {"closest": 1 + 5 * TEAPOT_DEPTH, "anyhit": 0, "fetch": 0},
        depth_cap=TEAPOT_DEPTH)
    rgb = frame_out["rgb"].cpu().numpy()
    np.save(OUT_DIR / "teapot_volpath_rgb.npy", rgb)
    # the media's pixels against the same render with the media's scale 0
    small = load_and_compile(str(TEAPOT_XML), spp=16, width=160, height=90)
    clear = replace_leaves(small, {"medium_scale": small.media.scale * 0.0})
    a, b = (driver.render(s, seed=3, depth_cap=TEAPOT_DEPTH, progress=quiet)["rgb"].cpu().numpy()
            for s in (small, clear))
    masks = medium_masks(small)
    diff = {m: float(np.abs(a - b)[mk].mean() / max(np.abs(b)[mk].mean(), 1e-12))
            for m, mk in masks.items()}
    checks = {"finite": bool(np.isfinite(rgb).all()), "non_negative": bool(rgb.min() >= 0.0),
              "lit": bool(rgb.mean() > 0.05),
              **{f"medium_{m}_pixels": int(mk.sum()) > 20 for m, mk in masks.items()},
              **{f"medium_{m}_changes_its_pixels": d > 0.05 for m, d in diff.items()}}
    phase("16", f"teapot image mean {rgb.mean(axis=(0, 1)).tolist()}; 160x90 16 spp against "
                f"the media at scale 0, mean relative change over each medium's pixels "
                f"{diff} ({ {m: int(mk.sum()) for m, mk in masks.items()} } pixels); "
                f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 16: teapot image checks failed {checks}")
    small_cpu = load_and_compile(str(TEAPOT_XML), spp=4, width=64, height=36, device="cpu")
    out["teapot"] = {"launches": launches, "media_change": diff,
                     "cuda_vs_cpu": cuda_vs_cpu(small_cpu, "16", CPU_CHECK_DEPTH)}

    # ---- (b) the grid-volume scene at the benchmark spec
    vol_xml = volume_assets.prepared(VOLUME_BUILD)
    vol = load_and_compile(str(vol_xml))
    phase("16", f"volume {vol_xml.relative_to(ROOT)}: {vol.n_faces} faces, grid "
                f"{vol.volume_meta[0][1:4]}, {vol.volumes.shape[0]} density texels")
    frame_out, launches_v = checked_frame(
        vol, "16", {"closest": 1 + 5 * BENCH_DEPTH, "anyhit": 0, "fetch": 0})
    rgb_v = frame_out["rgb"].cpu().numpy()
    np.save(OUT_DIR / "volume_rgb.npy", rgb_v)
    checks = {"finite": bool(np.isfinite(rgb_v).all()), "non_negative": bool(rgb_v.min() >= 0),
              "lit": bool(rgb_v.mean() > 0.05)}
    phase("16", f"volume image mean {rgb_v.mean(axis=(0, 1)).tolist()}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 16: volume image checks failed {checks}")
    out["volume"] = {"launches": launches_v,
                     "cuda_vs_cpu": cuda_vs_cpu(load_and_compile(
                         str(vol_xml), spp=4, width=64, height=64, device="cpu"), "16")}

    # ---- (c) media gradients, then the same gradients on the CPU
    tg = load_and_compile(str(TEAPOT_XML), spp=BENCH_SPP, width=BENCH_W, height=BENCH_H)
    media_names = ("sigma_s_amp", "sigma_a_amp", "medium_scale")
    out["teapot_gradient"] = media_gradient(tg, media_names, "teapot", GRAD_CHUNK, media_names)
    side = int(np.sqrt(VOL_GRAD_LANES // 16))
    vg = load_and_compile(str(vol_xml), spp=16, width=side, height=side)
    out["volume_gradient"] = media_gradient(vg, ("volumes",), "volume", VOL_GRAD_LANES,
                                            ("volumes",))
    l1, anatomy = {}, {}
    for label, xml, names in (("teapot", TEAPOT_XML, media_names),
                              ("volume", vol_xml, ("volumes",))):
        sc = load_and_compile(str(xml), spp=8, width=48, height=27, device="cpu")
        (_, rgb_a, g_a), (_, rgb_b, g_b) = (
            image_grads(s, names, lambda r: r.mean(), seed=7, depth_cap=CPU_CHECK_DEPTH)
            for s in (sc, sc.to("cuda")))
        l1[label] = {k: rel_l1(g_b[k], g_a[k]) for k in names}
        # where a gap comes from: pixels that differ (a lane whose sampling
        # went elsewhere), and how much of the L1 its 10 largest entries hold
        rel = ((rgb_b.cpu() - rgb_a).abs() / rgb_a.abs().clamp(min=1e-3)).amax(dim=-1)
        diff = torch.cat([(g_b[k].cpu() - g_a[k]).abs().reshape(-1) for k in names])
        anatomy[label] = {"pixels_off_1e-4": int((rel > 1e-4).sum()),
                          "image_l1": rel_l1(rgb_b, rgb_a),
                          "top10_share": float(diff.topk(min(10, diff.numel())).values.sum()
                                               / diff.sum().clamp(min=1e-30))}
    checks = {f"{label}_{k}": v < 1e-4 for label, r in l1.items() for k, v in r.items()}
    phase("16", f"48x27 8 spp gradients (depth cap {CPU_CHECK_DEPTH}) CUDA vs CPU relative L1 "
                f"{l1}; anatomy {anatomy}; "
                f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 16: media gradients CUDA vs CPU {l1}")
    out["gradient_cuda_vs_cpu_l1"] = l1
    out["gradient_cuda_vs_cpu_anatomy"] = anatomy
    return out


def checked_ppm_frame(scene, label):
    """One frame of a photon-mapping `scene` through render() on cuda, with
    every launch count set to 0 just before it and read just after; fails
    unless they are iterations x the structure's
    `ppm.launches_per_iteration` (PCG32's included). Returns (its output,
    its launches)."""
    import torch

    from misaki_tpu_torch.render import ppm
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.utils import tracing

    reset_counts()
    out = render(scene, seed=1, depth_cap=BENCH_DEPTH, progress=quiet)
    torch.cuda.synchronize()
    launches = {**read_counts(), "pcg32": tracing.launches["pcg32"]}
    budget, iters = ppm.depth_budget(scene, BENCH_DEPTH), scene.ppm_iterations
    want = {"fetch_bwd": 0, **{k: iters * v for k, v in
                               ppm.launches_per_iteration(scene, budget).items()}}
    phase(label, f"{scene.film_width}x{scene.film_height}, {scene.integrator}, "
                 f"{ppm.photon_count(scene)} photons x {iters} iterations, depth budget "
                 f"{budget}: launches {launches} expected {want}")
    if launches != want:
        fail(f"phase {label}: kernel launch counts {launches} != expected {want}")
    # the CUDA kernels of those estimates, for the kernels line
    launches["density_cuda"] = tracing.launches["density_cuda"]
    return out, launches


def luminance(rgb):
    """CIE Y of linear sRGB (H, W, 3) numpy images."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def against_path(rgb, ref, block):
    """A photon-mapping image against a path-traced one of the same scene,
    as tests/test_ppm.py compares them, on the luminance Y: the relative
    difference of the means and the correlation of `block` x `block`-pixel
    means (each image's per-pixel noise, the path frame's fireflies and the
    photons' per-pixel NEE, would otherwise decide it). Y, not the RGB: an
    iteration draws one hero-wavelength set for every pixel
    (misaki_tpu/render/ppm.py:498-501), so 8 iterations integrate the
    colour-matching functions from 32 wavelengths and a frame's colour
    balance varies with the seed (envlit's sky is bluer than red in some
    seeds and not in others), while Y, whose matching function is the
    broadest, varies little."""
    import numpy as np

    H, W = rgb.shape[0] // block, rgb.shape[1] // block

    def lum(x):
        return luminance(x)[:H * block, :W * block].reshape(H, block, W, block).mean(
            axis=(1, 3)).ravel()

    y, y_ref = luminance(rgb), luminance(ref)
    return (float(abs(y.mean() - y_ref.mean()) / y_ref.mean()),
            float(np.corrcoef(lum(rgb), lum(ref))[0, 1]))


def density_check(args, grid, calls=10):
    """The density estimate's grid kernel against its twin on one photon
    depth's inputs over `grid` (tools/profile_ppm_density.py `check`: counts
    equal and phi allclose in each of `calls` calls, phi equal to the bit
    between calls); the kernel's and the twin's device times, the CUDA
    launches of one estimate, the pairs tested and the bound (`bounds`: the
    bytes the function needs read once and its outputs written once against
    the FP32 operations of the alive photons and the passing pairs)."""
    from misaki_tpu_torch.render import ppm
    from misaki_tpu_torch.tools import profile_ppm_density as pd
    from misaki_tpu_torch.tools.profile_cluster_frame import device_ms

    sppm_mode = args[-1]
    ph, vps = ppm.pack_inputs(*args[:-1])
    lib = ppm.build()
    want = ppm.density_plain(*args)
    res = pd.check(lambda: ppm.density_launch(lib, ph, vps, sppm_mode, grid), want, calls)
    stats = {}
    ppm.density_launch(lib, ph, vps, sppm_mode, grid, stats=stats, pair_tests=True)
    res.update(pd.bounds(args, want), grid=list(grid.dims), cuda_launches=stats["cuda_launches"],
               pair_tests=int(stats["pair_tests"].item()),
               ms=device_ms(lambda: ppm.density_launch(lib, ph, vps, sppm_mode, grid), 10),
               plain_ms=device_ms(lambda: ppm.density_plain(*args), 2))
    return res


def phase_ppm(envlit):
    """Phase 17: the sppm and photonmapper integrators (render/ppm.py) and
    the density kernel. Returns the numbers for chip_smoke.json."""
    import numpy as np
    import torch

    from misaki_tpu_torch.render import ppm
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.scenes.materials import assets as materials_assets
    from misaki_tpu_torch.tools import profile_ppm_density as pd

    res = {}
    ref = render(load_and_compile(str(CBOX_XML), spp=BENCH_SPP, width=BENCH_W, height=BENCH_H)
                 .replace(max_depth=BENCH_DEPTH + 1), seed=9, depth_cap=BENCH_DEPTH,
                 progress=quiet)["rgb"].cpu().numpy()
    # (a), (b): cbox under both integrators at the slice's size
    captured = {}
    for label, integrator, tol in (("17a", "sppm", (0.2, 0.9)),
                                   ("17b", "photonmapper", (0.25, 0.85))):
        xml = SCENES / "cbox" / f"{integrator}.xml"
        scene = load_and_compile(str(xml), width=BENCH_W, height=BENCH_H)
        out, launches = checked_ppm_frame(scene, label)
        rgb, alpha = out["rgb"].cpu().numpy(), out["alpha"].cpu().numpy()
        third = BENCH_W // 3
        rel, corr = against_path(rgb, ref, 4)
        checks = {"finite": bool(np.isfinite(rgb).all()),
                  "red_left": bool(rgb[:, :third, 0].mean() > rgb[:, :third, 1].mean()),
                  "green_right": bool(rgb[:, -third:, 1].mean() > rgb[:, -third:, 0].mean()),
                  "alpha": bool(0.5 < alpha.mean() <= 1.0),
                  "mean_vs_path": rel < tol[0], "luminance_corr_vs_path": corr > tol[1]}
        phase(label, f"{xml.relative_to(ROOT)}: image mean {rgb.mean(axis=(0, 1)).tolist()}, "
                     f"alpha {alpha.mean():.4f}; against a 256x256 64 spp path frame: mean "
                     f"{rel:.4f} apart, luminance correlation of 4x4-pixel means {corr:.4f}; "
                     f"checks {checks}")
        if not all(checks.values()):
            fail(f"phase {label}: image checks failed {checks}")
        np.save(OUT_DIR / f"cbox_{integrator}_rgb.npy", rgb)
        res[f"cbox_{integrator}"] = {"launches": launches, "mean_vs_path": rel,
                                     "corr_vs_path": corr}
        # the first splatted depth's inputs to the density estimate and the
        # frame's grid, for (e)
        captured[integrator] = pd.capture(integrator, width=BENCH_W, height=BENCH_H,
                                          depth_cap=BENCH_DEPTH)

    # (c) envlit under sppm: envmap photon emission, bitmap visible points
    env = envlit.replace(integrator="sppm", ppm_photons=PPM_PHOTONS, ppm_iterations=PPM_ITERS,
                         max_depth=BENCH_DEPTH + 1)
    out, launches = checked_ppm_frame(env, "17c")
    rgb = out["rgb"].cpu().numpy()
    top = rgb[: rgb.shape[0] // 8]
    env_ref = render(envlit.replace(spp=16, max_depth=BENCH_DEPTH + 1), seed=9,
                     depth_cap=BENCH_DEPTH, progress=quiet)["rgb"].cpu().numpy()
    rel, corr = against_path(rgb, env_ref, 8)
    top_rel = float(abs(luminance(top).mean() / luminance(env_ref[: rgb.shape[0] // 8]).mean()
                        - 1.0))
    checks = {"finite": bool(np.isfinite(rgb).all()), "sky_luminance_vs_path": top_rel < 0.1,
              "mean_vs_path": rel < 0.2, "luminance_corr_vs_path": corr > 0.9}
    phase("17c", f"envlit image mean {rgb.mean(axis=(0, 1)).tolist()}, top rows "
                 f"{top.mean(axis=(0, 1)).tolist()} (luminance {top_rel:.4f} from the path "
                 f"frame's); against a 256x256 16 "
                 f"spp path frame: mean {rel:.4f} apart, luminance correlation of 8x8-pixel "
                 f"means {corr:.4f}; "
                 f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 17c: image checks failed {checks}")
    np.save(OUT_DIR / "envlit_sppm_rgb.npy", rgb)
    res["envlit_sppm"] = {"launches": launches, "mean_vs_path": rel, "corr_vs_path": corr}

    # (d) the gallery under sppm, reduced: glossy visible points (the
    # plain pair path), point-light and constant-environment photons
    gallery = load_and_compile(str(materials_assets.prepared(GALLERY_BUILD)), width=128,
                               height=128).replace(integrator="sppm", ppm_photons=1 << 14,
                                                   ppm_iterations=2)
    glossy_vps = []
    glossy = ppm._density_glossy

    def count_glossy(vp, *args):
        glossy_vps.append(int((vp["valid"] & vp["glossy"]).sum()))
        return glossy(vp, *args)

    ppm._density_glossy = count_glossy
    try:
        out, launches = checked_ppm_frame(gallery, "17d")
    finally:
        ppm._density_glossy = glossy
    rgb = out["rgb"].cpu().numpy()
    checks = {"finite": bool(np.isfinite(rgb).all()), "non_negative": bool(rgb.min() >= 0.0),
              "lit": bool(rgb.mean() > 0.05), "glossy_visible_points": max(glossy_vps) > 0}
    phase("17d", f"gallery 128x128, {gallery.ppm_photons} photons x {gallery.ppm_iterations} "
                 f"iterations: glossy visible points per photon depth {glossy_vps}, emitter "
                 f"kinds {gallery.emitter_kinds}; image mean {rgb.mean(axis=(0, 1)).tolist()}; "
                 f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 17d: image checks failed {checks}")
    res["gallery_sppm"] = {"launches": launches, "glossy_vps": glossy_vps}

    # (e) the density estimate's grid kernel against its twin on (a)'s and
    # (b)'s first splatted depth and on the adversarial mix
    cells = {f"cbox_{i}": captured[i] for i in ("sppm", "photonmapper")}
    cells["adversarial"] = (pd.to_args(*pd.mixed(), True, "cuda"), pd.adversarial_grid())
    res["density_kernel"] = {}
    for name, (args, grid) in cells.items():
        dens = density_check(args, grid)
        phase("17e", f"density estimate on {name}: {dens['photons']} photons x "
                     f"{dens['visible_points']} visible points ({dens['live_visible_points']} "
                     f"live, {dens['contributing_photons']} photons that may contribute, "
                     f"{dens['pairs_passed']} pairs passed), grid {dens['grid']}: counts equal "
                     f"{dens['counts_equal']}, phi allclose in every one of {dens['calls']} calls "
                     f"{dens['allclose_every_call']} and equal to the bit between calls "
                     f"{dens['bit_equal_between_calls']} (max abs err {dens['max_abs_err']:.3e}, "
                     f"{dens['tolerance_used']:.3f} of the tolerance used); "
                     f"{dens['cuda_launches']} CUDA launches an estimate, {dens['pair_tests']} "
                     f"pairs tested; kernel_ms={dens['ms']:.4f} plain_ms="
                     f"{dens['plain_ms']:.4f} bound_ms={dens['bound_ms']:.6f} ({dens['bound_by']}, "
                     f"{dens['bytes']} bytes needed, {dens['alive_photons']} photons alive; "
                     f"{dens['bound_ms'] / dens['ms']:.4f} of it)")
        if not dens["ok"]:
            fail(f"phase 17e: the density estimate disagrees with its plain twin on {name}")
        res["density_kernel"][name] = dens

    # (f) CUDA against the CPU on a small cbox sppm render
    small = load_and_compile(str(SCENES / "cbox" / "sppm.xml"), width=64, height=48,
                             device="cpu").replace(ppm_photons=8192, ppm_iterations=2)
    res["cuda_vs_cpu"] = cuda_vs_cpu(small, "17f")

    # (g) checkpoint and resume per iteration on the card
    scene = load_and_compile(str(SCENES / "cbox" / "sppm.xml"), width=128, height=128).replace(
        ppm_photons=1 << 16, ppm_iterations=4)
    ck = OUT_DIR / "ppm_checkpoint.npz"
    ck.unlink(missing_ok=True)
    ref_out = render(scene, seed=5, depth_cap=BENCH_DEPTH, progress=quiet)

    class Stop(RuntimeError):
        pass

    def stop_after_3(done, total):
        if done == 3:
            raise Stop()

    try:
        render(scene, seed=5, depth_cap=BENCH_DEPTH, checkpoint_path=str(ck), checkpoint_every=1,
               progress=stop_after_3)
        fail("phase 17g: the progress callback did not stop the render")
    except Stop:
        pass
    snapshot_it = int(np.load(ck)["next_it"]) if ck.exists() else None
    seen = []
    out = render(scene, seed=5, depth_cap=BENCH_DEPTH, checkpoint_path=str(ck),
                 checkpoint_every=1, progress=lambda done, total: seen.append(done))
    checks = {"snapshot_at_2": snapshot_it == 2, "resumed_3_to_4": seen == [3, 4],
              "rgb_bit_equal": bool(torch.equal(out["rgb"], ref_out["rgb"])),
              "alpha_bit_equal": bool(torch.equal(out["alpha"], ref_out["alpha"])),
              "snapshot_cleared": not ck.exists()}
    phase("17g", f"cbox sppm 128x128, 65536 photons x 4 iterations: stopped after iteration 3, "
                 f"snapshot at iteration {snapshot_it}, resumed {seen}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 17g: checkpoint/resume checks failed {checks}")
    res["checkpoint"] = checks
    return res


def phase_pcg32(k=6):
    """Phase 19: the PCG32 kernel's seeding (driver.make_rng's streams, the
    seed's words as (1,) device tensors, lanes across 2^31) and a group of
    k draws against the plain twins on the card at 2^20 and 2^22 lanes:
    limbs and floats equal to the bit; each side's device time, and each
    entry point's bound: its bytes at 3.35 TB/s (a draw's integer
    operations are far below the card's rate). Returns its numbers."""
    import torch

    from misaki_tpu_torch.core import rng
    from misaki_tpu_torch.render import driver
    from misaki_tpu_torch.tools.profile_cluster_frame import bound_ms, device_ms

    res, equal = {}, True
    words = tuple(torch.tensor([w], dtype=torch.int64, device="cuda")
                  for w in driver.seed_words(2654435761))
    for log2 in (20, 22):
        L = 1 << log2
        lane = torch.arange(L, dtype=torch.int64, device="cuda") + (2 ** 31 - L // 2)

        def seed_kernel():
            return rng.seed_lanes(lane, *words)

        def seed_plain():
            return rng.seed_lanes_plain(lane, *words)

        st, st_p = seed_kernel(), seed_plain()
        got, got_st = rng.next_floats(st, k)
        want, want_st = rng.next_floats_plain(st_p, k)
        torch.cuda.synchronize()
        same = (all(torch.equal(st[n], st_p[n].expand_as(st[n])) for n in rng.LIMBS)
                and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, want))
                and all(torch.equal(got_st[n], want_st[n].expand_as(got_st[n]))
                        for n in rng.LIMBS))
        equal = equal and same
        r = {"lanes": L, "k": k, "equal": same,
             "seed_ms": device_ms(seed_kernel, 20), "seed_plain_ms": device_ms(seed_plain, 3),
             "seed_bound_ms": bound_ms(L * (8 + 32), 0)[0],
             "draws_ms": device_ms(lambda: rng.next_floats(st, k), 20),
             "draws_plain_ms": device_ms(lambda: rng.next_floats_plain(st_p, k), 3),
             "draws_bound_ms": bound_ms(L * (32 + 16 + 4 * k), 0)[0]}
        res[str(log2)] = r
        phase("19", f"2^{log2} lanes: equal to the twins {same}; seeding kernel_ms="
                    f"{r['seed_ms']:.4f} plain_ms={r['seed_plain_ms']:.4f} bound_ms="
                    f"{r['seed_bound_ms']:.4f} (bytes); {k} draws kernel_ms={r['draws_ms']:.4f} "
                    f"plain_ms={r['draws_plain_ms']:.4f} bound_ms={r['draws_bound_ms']:.4f} "
                    f"(bytes)")
    if not equal:
        fail("phase 19: the PCG32 kernel differs from its plain twins")
    return {"equal": equal, **res}


def phase_sharding(smi_line):
    """Phase 18: parallel/sharding.py on the one card. (a) world size 1 over
    NCCL on cuda:0: a render_sharded frame of cbox at the benchmark spec
    beside a render() frame of the same seed (the same chunks, so the films
    equal to the bit; else the largest difference, failing above rtol
    1e-6), the sharded frame's launches as phase 4's; (b)
    train_step_sharded at world size 1 beside train_step on phase 15 (a)'s
    step: the loss to rtol 1e-6, every leaf's gradient within 1e-5 relative
    L1, the launches of one pass; (c) two processes that share the card
    over gloo with CUDA tensors: render_sharded on a (2,) mesh and
    render_sharded_2d on (1, 2) and (2, 1) against (a)'s film (rtol 1e-5,
    atol 1e-6 of its largest value), train_step_sharded on (2,) against
    (b)'s gradients (1e-4 relative L1), in one autograd chunk a rank and in
    2^20-lane chunks (image_grads' primal, the film's sum, the chunked
    re-render), every rank's results the same, then dryrun_multichip(2).
    Returns its numbers."""
    import tempfile

    import torch
    import torch.distributed as dist

    from misaki_tpu_torch import graft_entry
    from misaki_tpu_torch.diff.train import DEFAULT_TRAIN_LEAVES, train_step
    from misaki_tpu_torch.parallel import sharding as sh
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.render.integrator import n_bounce_iters

    scene, target, _ = train_cbox(spp=BENCH_SPP, width=BENCH_W, height=BENCH_H)
    kw = dict(seed=1, depth_cap=BENCH_DEPTH)
    n_iters = n_bounce_iters(scene, BENCH_DEPTH)
    n_chunks = -(-BENCH_W * BENCH_H * BENCH_SPP // BENCH_CHUNK)
    none = {"fetch": 0, "fetch_bwd": 0, "density": 0}
    want = {"closest": n_chunks * (1 + n_iters), "anyhit": n_chunks * n_iters, **none}
    want_step = {"closest": 1 + n_iters, "anyhit": n_iters, **none}   # one autograd pass

    with tempfile.TemporaryDirectory() as tmp:
        dev = sh.init_distributed(f"file://{tmp}/store", 1, 0, "nccl", device="cuda")
        try:
            mesh = sh.make_mesh(1, dev)
            # (a)
            reset_counts()
            film = sh.render_sharded(mesh, scene, chunk_size=BENCH_CHUNK, **kw)
            torch.cuda.synchronize()
            launches = read_counts()
            ref = render(scene, chunk_size=BENCH_CHUNK, progress=quiet, **kw)["film"]
            equal = bool(torch.equal(film, ref))
            film_diff = float((film - ref).abs().max())
            checks = {"film_equal_or_rtol_1e-6": equal or bool(
                          torch.allclose(film, ref, rtol=1e-6, atol=0.0)),
                      "launches": launches == want}
            phase("18a", f"world size 1 over nccl on {dev}: cbox {BENCH_W}x{BENCH_H} "
                         f"{BENCH_SPP} spp, depth cap {BENCH_DEPTH}, {n_chunks} chunks of "
                         f"{BENCH_CHUNK}: render_sharded against render(), films equal to the "
                         f"bit {equal} (largest difference {film_diff:.3e}); launches "
                         f"{launches} expected {want}; checks {checks}")
            if not all(checks.values()):
                fail(f"phase 18a: checks failed {checks}")

            # (b)
            reset_counts()
            l_sh, g_sh = sh.train_step_sharded(mesh, scene, target, seed=0,
                                               depth_cap=BENCH_DEPTH)
            torch.cuda.synchronize()
            train_launches = read_counts()
            l_1, g_1 = train_step(scene, target, seed=0, depth_cap=BENCH_DEPTH)
        finally:
            dist.destroy_process_group()
    loss_rel = abs(float(l_sh) - float(l_1)) / abs(float(l_1))
    l1 = {k: rel_l1(g_sh[k], g_1[k]) for k in DEFAULT_TRAIN_LEAVES}
    checks = {"loss_rtol_1e-6": loss_rel <= 1e-6, "launches": train_launches == want_step,
              **{f"grad_{k}": v <= 1e-5 for k, v in l1.items()}}
    phase("18b", f"world size 1: train_step_sharded against train_step: loss "
                 f"{float(l_sh):.6e} against {float(l_1):.6e} (relative {loss_rel:.3e}); "
                 f"relative L1 {l1}; launches {train_launches} expected {want_step}; "
                 f"checks {checks}")
    if not all(checks.values()):
        fail(f"phase 18b: checks failed {checks}")

    # (c) two processes on the one card
    torch.cuda.empty_cache()
    cpu_scene = scene.to("cpu")
    render_kw = dict(chunk_size=BENCH_CHUNK, **kw)
    train_kw = dict(target_rgb=target.cpu().numpy(), depth_cap=BENCH_DEPTH)
    meshes = [(2,), (1, 2), (2, 1)]
    tasks = ([("render", cpu_scene, m, render_kw) for m in meshes]
             + [("train", cpu_scene, (2,), dict(seed=0, **train_kw)),
                ("train", cpu_scene, (2,), dict(seed=0, chunk_size=BENCH_CHUNK, **train_kw))])
    ranks = sh.run_ranks(2, sh.sharded_job, tasks, backend="gloo", device="cuda")
    ref = film.cpu()
    atol = 1e-6 * float(ref.abs().max())
    checks, film_err = {}, {}
    for i, m in enumerate(meshes):
        got = ranks[0][i]
        film_err[str(m)] = float((got - ref).abs().max())
        checks[f"film_{m}"] = bool(torch.allclose(got, ref, rtol=1e-5, atol=atol))
        checks[f"ranks_equal_{m}"] = all(r[i].equal(got) for r in ranks)
    steps_c = {}
    for i, name in ((3, "one_chunk"), (4, "chunked")):
        loss_i, g_i = ranks[0][i]
        l1_i = {k: rel_l1(g_i[k], g_1[k]) for k in DEFAULT_TRAIN_LEAVES}
        steps_c[name] = {"loss": float(loss_i), "rel_l1": l1_i}
        checks[f"ranks_equal_train_{name}"] = all(
            r[i][0].equal(loss_i) and all(r[i][1][k].equal(g_i[k]) for k in g_i)
            for r in ranks)
        checks.update({f"grad_{k}_{name}": v <= 1e-4 for k, v in l1_i.items()})
    phase("18c", f"2 processes share one card over gloo ({smi_line}): largest difference from "
                 f"(a)'s film {film_err} (atol {atol:.3e}); train_step_sharded, each rank's "
                 f"block in one chunk and in chunks of {BENCH_CHUNK} lanes: {steps_c} (loss, "
                 f"relative L1 against (b)'s train_step); checks {checks}")
    if not all(checks.values()):
        fail(f"phase 18c: checks failed {checks}")
    graft_entry.dryrun_multichip(2, device="cuda")
    phase("18c", "dryrun_multichip(2) on the card over gloo: ok")
    return {"world1": {"film_equal": equal, "film_max_diff": film_diff, "launches": launches,
                       "loss_rel": loss_rel, "grad_rel_l1": l1,
                       "train_launches": train_launches},
            "two_processes_one_card": {"film_max_diff": film_err, "steps": steps_c},
            "device": smi_line}


def centre_hits(scene):
    """The first hit of each pixel's centre ray (its first sample's camera
    ray), as compute_interaction gives it, and the rays."""
    import torch

    from misaki_tpu_torch.accel import traverse
    from misaki_tpu_torch.render import driver, interaction

    lane = torch.arange(scene.film_width * scene.film_height, dtype=torch.int64,
                        device="cuda") * scene.spp
    ray, _, _ = driver.primary_rays(scene, lane, 0)
    hit = traverse.intersect(scene, ray["o"], ray["d"], ray["mint"], ray["maxt"])
    return interaction.compute_interaction(scene, hit, ray["o"], ray["d"], ray["wavelengths"])


def ball_checks(scene, rgb, balls, floor, label):
    """Image checks of a frame of spheres on a floor: finite and
    non-negative everywhere; over the pixels whose centre ray first hits a
    ball's material, the mean luminance differs from the floor's by more
    than 2% of it; and a glass ball (rough or smooth dielectric) is not
    black, its mean above a tenth of the floor's. `balls`: one tuple of
    shape indices per ball (a test ball is two coincident meshes); `floor`:
    a shape index. Returns {name: bool}."""
    import numpy as np
    import torch

    from misaki_tpu_torch.scene.types import BSDF_DIELECTRIC, BSDF_ROUGH_DIELECTRIC, MC_KIND

    si = centre_hits(scene)
    mat = torch.where(si["valid"], si["bsdf"], -1).cpu().numpy().reshape(rgb.shape[:2])
    rows = scene.shape_bsdf.cpu().numpy()
    kinds = scene.materials.params[MC_KIND].cpu().numpy()
    lum = 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
    floor_px = mat == rows[floor]
    floor_mean = float(lum[floor_px].mean()) if floor_px.any() else 0.0
    checks = {"finite": bool(np.isfinite(rgb).all()), "non_negative": bool(rgb.min() >= 0.0),
              "floor_seen": bool(floor_px.sum() >= 50)}
    means = {}
    for shapes in balls:
        px = np.isin(mat, rows[list(shapes)])
        m = float(lum[px].mean()) if px.sum() >= 20 else float("nan")
        kind = int(kinds[rows[shapes[0]]])
        name = f"shape{'+'.join(map(str, shapes))}_kind{kind}"
        means[name] = m
        checks[f"{name}_off_floor"] = bool(abs(m - floor_mean) > 0.02 * floor_mean)
        if kind in (BSDF_DIELECTRIC, BSDF_ROUGH_DIELECTRIC):
            checks[f"{name}_glass_lit"] = bool(m > 0.1 * floor_mean)
    phase(label, f"image mean {rgb.mean(axis=(0, 1)).tolist()}; floor luminance "
                 f"{floor_mean:.4f}; ball luminance {means}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase {label}: image checks failed {checks}")
    return checks


def floor_checker_correlation(scene, rgb):
    """Correlation, over the pixels whose centre ray first hits a bitmap
    material, between the image's luminance and the light/dark tile of the
    checker texture the ray lands on (the texture's 8x8 tiles, through the
    slot's uv transform)."""
    import torch

    from misaki_tpu_torch.render import textures as ptex
    from misaki_tpu_torch.scene.types import MC_REFL, SPEC_SLOT_COLS
    from misaki_tpu_torch.scenes.envlit import assets

    si = centre_hits(scene)
    cols = scene.materials.params[:, si["bsdf"].to(torch.int64)]
    slot = cols[MC_REFL: MC_REFL + SPEC_SLOT_COLS]
    on_floor = si["valid"] & (torch.abs(slot[0] - ptex.SLOT_BITMAP) < 0.25)
    u, v = ptex._slot_uv(slot, si["uv"])
    tiles = assets.CHECKER_TILES
    iu = torch.floor((u - torch.floor(u)) * tiles)
    iv = torch.floor((v - torch.floor(v)) * tiles)
    light = (torch.remainder(iu + iv, 2.0) == 0.0).float()
    lum = torch.as_tensor(0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
                          + 0.072169 * rgb[..., 2], device="cuda").reshape(-1)
    x, y = light[on_floor], lum[on_floor]
    x, y = x - x.mean(), y - y.mean()
    corr = (x * y).sum() / torch.sqrt((x * x).sum() * (y * y).sum()).clamp(min=1e-30)
    return corr.item(), on_floor.float().mean().item()


def main():
    import torch

    # ---- phase 1: the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi: not available"
    # the CPU halves of the CUDA-vs-CPU checks: one intra-op thread per CPU
    # this process may run on
    cpus = len(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(cpus)
    phase("1", f"device {device_name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
               f"cuda {torch.version.cuda}; CPUs {os.cpu_count()}, {cpus} usable, torch threads "
               f"{threads} -> {torch.get_num_threads()}")
    print(smi_line, flush=True)
    OUT_DIR.mkdir(exist_ok=True)

    import numpy as np

    from misaki_tpu_torch.accel import cluster as cl
    from misaki_tpu_torch.core import rng
    from misaki_tpu_torch.render import driver, ppm
    from misaki_tpu_torch.render import texel_fetch as tf
    from misaki_tpu_torch.render.integrator import n_bounce_iters
    from misaki_tpu_torch.scene import procedural
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.scenes.envlit import assets
    from misaki_tpu_torch.scenes.materials import assets as materials_assets
    from misaki_tpu_torch.tools import profile_cluster_frame
    from misaki_tpu_torch.tools.tie_case import merge_clusters
    from misaki_tpu_torch.utils import cuda_build

    # ---- phase 2: build, one nvcc per source, all started together
    srcs = [cl.SRC, tf.SRC, ppm.SRC, rng.SRC]
    libs = cuda_build.compile_sources(srcs)
    cl.build()
    tf.build()
    ppm.build()
    rng.build()
    phase("2", f"built {', '.join(p.name for p in libs)} from "
               f"{', '.join(str(src.relative_to(ROOT)) for src in srcs)}")

    # ---- phase 3: cluster kernels vs plain twins
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    bunny = procedural.bunny_standin()
    pos = bunny["positions"].astype(np.float64)
    tab = np.zeros((36, len(pos)), np.float32)
    tab[0] = np.arange(len(pos))
    tab[1:] = np.random.default_rng(0).normal(size=(35, len(pos)))
    acc_host = cl.build_clusters(pos[:, 0].astype(np.float32),
                                 (pos[:, 1] - pos[:, 0]).astype(np.float32),
                                 (pos[:, 2] - pos[:, 0]).astype(np.float32), face_tab=tab)
    acc = acc_host.to("cuda")
    phase("3", f"bunny accel: {len(pos)} faces, {acc.n_clusters} clusters, "
               f"{acc.nodes.shape[0]} BVH2 nodes")
    lo = torch.tensor(pos.reshape(-1, 3).min(0), device="cuda", dtype=torch.float32)
    hi = torch.tensor(pos.reshape(-1, 3).max(0), device="cuda", dtype=torch.float32)
    center, extent = 0.5 * (lo + hi), (hi - lo).max()
    cam_o, cam_d = camera_like_rays(N_RAYS, center, extent, gen)
    cam_maxt = torch.full((N_RAYS,), 3.0 * float(extent), device="cuda")
    compare_kernels(acc, cam_o, cam_d, cam_maxt, "bunny_camera", report)
    o, d = random_rays(N_RAYS, lo - 0.2 * extent, hi + 0.2 * extent, gen)
    compare_kernels(acc, o, d, extent * torch.rand(N_RAYS, device="cuda", generator=gen),
                    "bunny_random", report)
    # every face twice, in two sets of clusters: each hit an exact tie
    compare_kernels(merge_clusters(acc_host, acc_host).to("cuda"), cam_o, cam_d, cam_maxt,
                    "bunny_duplicated_ties", report, copy_from=len(pos))
    compare_kernels(profile_cluster_frame.empty_tree(36), cam_o, cam_d, cam_maxt,
                    "empty_accel", report)

    cbox = load_and_compile(str(CBOX_XML), spp=BENCH_SPP, width=BENCH_W,
                            height=BENCH_H).replace(max_depth=BENCH_DEPTH + 1)
    # the third of the frame's four 2^20-lane chunks (rows 128-191)
    lane = torch.arange(N_RAYS, dtype=torch.int64, device="cuda") + 2 * BENCH_CHUNK
    ray, _, _ = driver.primary_rays(cbox, lane, 0)
    compare_kernels(cbox.cluster, torch.stack(ray["o"]), torch.stack(ray["d"]),
                    0.5 * ray["maxt"].clamp(max=2000.0), "cbox_camera", report)

    # ---- phase 4: the cbox main path at the benchmark spec
    n_iters = n_bounce_iters(cbox, BENCH_DEPTH)
    out, launches_cbox = checked_frame(
        cbox, "4", {"closest": 1 + n_iters, "anyhit": n_iters, "fetch": 0})
    rgb = out["rgb"].cpu().numpy()
    alpha = out["alpha"].cpu().numpy()
    third = BENCH_W // 3
    left, right = rgb[:, :third], rgb[:, -third:]
    checks = {
        "finite": bool(np.isfinite(rgb).all()),
        "red_left": bool(left[..., 0].mean() > left[..., 1].mean()),
        "green_right": bool(right[..., 1].mean() > right[..., 0].mean()),
        "alpha_1": bool(np.abs(alpha - 1.0).max() < 1e-3),
        "lit": bool(rgb.mean() > 0.01),
    }
    phase("4", f"image mean {rgb.mean(axis=(0, 1)).tolist()} checks {checks}")
    if not all(checks.values()):
        fail(f"phase 4: image checks failed {checks}")
    np.save(OUT_DIR / "cbox_bench_rgb.npy", rgb)

    # ---- phase 5: cuda vs cpu on a small cbox
    cuda_vs_cpu(load_and_compile(str(CBOX_XML), spp=16, width=64, height=48, device="cpu"), "5")

    # ---- phase 6: the texel-fetch kernel vs its plain twin at 2^20 lanes
    envlit_xml = assets.prepared(SCENE_BUILD)
    envlit = load_and_compile(str(envlit_xml))
    phase("6", f"envlit scene {envlit_xml.relative_to(ROOT)}: {envlit.n_faces} faces, "
               f"{envlit.cluster.n_clusters} clusters, env {tuple(envlit.emitters.env_rgb.shape)}, "
               f"sampling {tuple(envlit.emitters.env_pmf.shape)}, bitmap texels "
               f"{envlit.bitmaps.shape[0]}")
    # random envmap taps, a raster over every mip level of the floor's
    # bitmap, the envmap's NEE taps, and the split launches
    fetch_report = compare_fetch(envlit)

    # ---- phase 7: the envlit main path at full size
    n_iters = n_bounce_iters(envlit, BENCH_DEPTH)
    n_bitmaps = len(envlit.bitmap_slots) * len(envlit.bitmap_meta)
    # texel fetches per chunk: the primary escape, then per bounce each
    # bitmap slot, the envmap's NEE sample and the bounce ray's escape
    out, launches_env = checked_frame(
        envlit, "7", {"closest": 1 + n_iters, "anyhit": n_iters,
                      "fetch": 1 + n_iters * (n_bitmaps + 2)})
    rgb = out["rgb"].cpu().numpy()
    H = rgb.shape[0]
    top = rgb[: H // 8]
    corr, floor_share = floor_checker_correlation(envlit, rgb)
    checks = {
        "finite": bool(np.isfinite(rgb).all()),
        "sky_blue_top": bool(top[..., 2].mean() > top[..., 0].mean()),
        "floor_textured": bool(corr > 0.5 and floor_share > 0.2),
        "lit": bool(rgb.mean() > 0.05),
    }
    phase("7", f"image mean {rgb.mean(axis=(0, 1)).tolist()}, top rows "
               f"{top.mean(axis=(0, 1)).tolist()}, floor pixels {floor_share:.4f}, "
               f"luminance-checker correlation {corr:.4f}; checks {checks}")
    if not all(checks.values()):
        fail(f"phase 7: image checks failed {checks}")
    np.save(OUT_DIR / "envlit_bench_rgb.npy", rgb)
    small = load_and_compile(str(envlit_xml), spp=8, width=48, height=36, device="cpu")
    env_mean_rel, env_l1_rel = cuda_vs_cpu(small, "7")

    # ---- phase 8: the closest-hit stage profile (kernel #4's counterpart)
    prof = profile_cluster_frame.profile(reps=20, out=OUT_DIR / "profile_bunny.md")
    ms = prof["ms"]
    want_launches = 4 * 21   # camera, empty-tree, end-to-end and random stages, 1 + 20 each
    phase("8", f"bunny {prof['rays']} camera and random rays: traversal {prof['traversal']}; "
               f"kernel vs plain: prim_equal={prof['prim_equal']:.6f} "
               f"t_max_abs={prof['t_max_abs']:.3e}, empty tree "
               f"prim_equal={prof['prim_equal_empty']:.6f}, random rays "
               f"prim_equal={prof['prim_equal_random']:.6f}; ms "
               + ", ".join(f"{k} {t:.4f}" for k, t in ms.items())
               + f"; plain {prof['plain_ms']:.4f}; bound {prof['bound_ms']}; launches "
                 f"{prof['launches']} expected {want_launches}; table "
                 f"{Path(prof['table']).relative_to(ROOT)}")
    if not (prof["prim_equal"] >= 0.999 and prof["t_max_abs"] <= 1e-4
            and prof["prim_equal_empty"] == 1.0 and prof["prim_equal_random"] >= 0.999):
        fail("phase 8: the profiled launches disagree with the plain twin")
    if prof["launches"] != want_launches:
        fail(f"phase 8: {prof['launches']} closest-hit launches, expected {want_launches}")

    # ---- phase 9: the material gallery at the benchmark spec
    gallery_xml = materials_assets.prepared(GALLERY_BUILD)
    gallery = load_and_compile(str(gallery_xml))
    phase("9", f"gallery {gallery_xml.relative_to(ROOT)}: {gallery.n_faces} faces, "
               f"{gallery.cluster.n_clusters} clusters, BSDF kinds {gallery.bsdf_kinds}, "
               f"bitmap slots {gallery.bitmap_slots}, emitter kinds {gallery.emitter_kinds}, "
               f"max_depth {gallery.max_depth}")
    n_iters = n_bounce_iters(gallery, BENCH_DEPTH)
    # texel fetches per chunk: each bounce's material_params evaluates every
    # slot that holds a bitmap (the gold ball's alpha_u and alpha_v), one
    # fetch per bitmap of the scene; the environment is `constant`, so no
    # envmap fetch (escape or NEE) runs
    n_bitmaps = len(gallery.bitmap_slots) * len(gallery.bitmap_meta)
    out, launches_gal = checked_frame(
        gallery, "9", {"closest": 1 + n_iters, "anyhit": n_iters, "fetch": n_iters * n_bitmaps})
    rgb = out["rgb"].cpu().numpy()
    np.save(OUT_DIR / "gallery_bench_rgb.npy", rgb)
    ball_checks(gallery, rgb, [(i,) for i in range(9)], 9, "9")
    small = load_and_compile(str(gallery_xml), spp=2, width=32, height=24, device="cpu")
    gal_cuda_vs_cpu = cuda_vs_cpu(small, "9")

    # ---- phase 10: Figure 2 and Figure 3 at their declared spec
    balls = {}
    for fig, xml_name in (("figure2", "roughconductor"), ("figure3", "roughdielectric")):
        xml = TESTBALL_DIR / f"{xml_name}.xml"
        tb = load_and_compile(str(xml))
        n_iters = n_bounce_iters(tb, BENCH_DEPTH)
        phase("10", f"{fig} {xml.relative_to(ROOT)}: {tb.n_faces} faces, "
                    f"{tb.cluster.n_clusters} clusters, BSDF kinds {tb.bsdf_kinds}, max_depth "
                    f"{tb.max_depth}")
        out, launches_tb = checked_frame(
            tb, "10", {"closest": 1 + n_iters, "anyhit": n_iters, "fetch": 0})
        rgb = out["rgb"].cpu().numpy()
        np.save(OUT_DIR / f"{fig}_{xml_name}_rgb.npy", rgb)
        # shapes: Mesh000 the stand, Mesh001 and Mesh003 the ball, Mesh002
        # the core, then the floor
        ball_checks(tb, rgb, [(1, 3)], 4, "10")
        small = load_and_compile(str(xml), spp=2, width=32, height=18, device="cpu")
        balls[fig] = {"scene": xml_name, "launches": launches_tb,
                      "cuda_vs_cpu": cuda_vs_cpu(small, "10")}

    # ---- phases 11-14: the debug, direct and aov paths, checkpoint and CLI
    new_paths = {"bunny_debug": phase_debug(), "cbox_direct": phase_direct(),
                 "envlit_aov": phase_aov(envlit_xml)}
    checkpoint = phase_checkpoint(envlit_xml)

    # ---- phase 15: gradients — cbox training, the envlit texture and envmap
    # gradient, the backward kernel
    train = phase_train()
    grad = phase_envlit_grad(envlit_xml, envlit)

    # ---- phase 16: volpath — the teapot stand-in, the grid volume, media gradients
    volpath = phase_volpath()

    # ---- phase 17: sppm and photonmapper, the density kernel
    photon = phase_ppm(envlit)

    # ---- phase 18: sharding on torch.distributed (one card)
    sharding = phase_sharding(smi_line)

    # ---- phase 19: the PCG32 kernel vs its plain twins at 2^20 and 2^22 lanes
    pcg32 = phase_pcg32()

    main_case = report["cbox_camera"]
    fa, fb, fn = (fetch_report[c] for c in ("env_random", "bitmap_camera_mips", "env_nee"))
    # {run: (launch counts, frames or steps)}: one frame of each, five steps
    main_runs = {"cbox": (launches_cbox, 1), "envlit": (launches_env, 1),
                 "gallery": (launches_gal, 1),
                 **{fig: (b["launches"], 1) for fig, b in balls.items()},
                 **{path: (r["launches"], 1) for path, r in new_paths.items()},
                 "cbox_train_step": (train["launches"], train["frames"]),
                 "envlit_gradient": (grad["launches"], grad["frames"]),
                 **{run: (volpath[run]["launches"], 1) for run in
                    ("teapot", "volume", "teapot_gradient", "volume_gradient")},
                 **{run: (photon[run]["launches"], 1)
                    for run in ("cbox_sppm", "cbox_photonmapper", "envlit_sppm",
                                "gallery_sppm")},
                 "cbox_sharded": (sharding["world1"]["launches"], 1),
                 "cbox_train_step_sharded": (sharding["world1"]["train_launches"], 1)}

    def launches(key):
        return sum(counts.get(key, 0) for counts, _ in main_runs.values())

    def per_frame(key):
        return {run: counts.get(key, 0) / frames for run, (counts, frames) in main_runs.items()}

    def counted_per_frame(key):
        """per_frame of the runs whose launch checks count `key`."""
        return {run: counts[key] / frames for run, (counts, frames) in main_runs.items()
                if key in counts}

    bwd, bp = grad["backward_kernel"], grad["backward_on_path"]
    dens_all = photon["density_kernel"]
    dens = dens_all["cbox_sppm"]
    n_bp = len(bp["launches"])

    kernels = {"kernels": [
        {"name": "cluster_closest_hit", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/cluster.cu",
         "replaces": "misaki_tpu/accel/cluster.py:367",
         "launches": launches("closest"),
         "launches_per_frame": per_frame("closest"),
         "max_abs_err": main_case["t_max_abs"],
         "ms": main_case["closest_ms"], "plain_ms": main_case["closest_plain_ms"],
         "bound_ms": main_case["closest_bound_ms"], "bound_by": main_case["closest_bound_by"],
         "library_ms": None},
        {"name": "cluster_any_hit", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/cluster.cu",
         "replaces": "misaki_tpu/accel/cluster.py:467",
         "launches": launches("anyhit"),
         "launches_per_frame": per_frame("anyhit"),
         "max_abs_err": main_case["anyhit_max_abs_err"],
         "ms": main_case["anyhit_ms"], "plain_ms": main_case["anyhit_plain_ms"],
         "bound_ms": main_case["anyhit_bound_ms"], "bound_by": main_case["anyhit_bound_by"],
         "library_ms": None},
        {"name": "texel_fetch", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/texel_fetch.cu",
         "replaces": "misaki_tpu/render/paged_fetch.py:55",
         "launches": launches("fetch"),
         "launches_per_frame": per_frame("fetch"),
         "max_abs_err": max(c["max_abs_err"] for c in fetch_report.values()),
         "ms": fa["ms"], "plain_ms": fa["plain_ms"],
         "bound_ms": fa["bound_ms"], "bound_by": fa["bound_by"],
         "library_ms": fa["embedding_bag_ms"], "sector_bytes": fa["sector_bytes"],
         "bitmap_ms": fb["ms"], "bitmap_plain_ms": fb["plain_ms"],
         "bitmap_bound_ms": fb["bound_ms"], "bitmap_library_ms": fb["embedding_bag_ms"],
         "bitmap_sector_bytes": fb["sector_bytes"],
         "nee_ms": fn["ms"], "nee_plain_ms": fn["plain_ms"], "nee_bound_ms": fn["bound_ms"],
         "nee_library_ms": fn["embedding_bag_ms"], "nee_sector_bytes": fn["sector_bytes"]},
        {"name": "cluster_closest_hit_stage_profile", "route": "cuda",
         "source": "misaki_tpu_torch/tools/profile_cluster_frame.py",
         "replaces": "tools/profile_cluster_frame.py:124",
         # a tool, never on a frame's path: kernel #1's launches per frame are
         # cluster_closest_hit's
         "launches": prof["launches"], "launches_per_frame": None,
         "max_abs_err": prof["t_max_abs"],
         "ms": ms["closest-hit kernel, camera rays"], "plain_ms": prof["plain_ms"],
         "bound_ms": prof["bound_ms"]["camera"], "bound_by": prof["bound_by"]["camera"],
         "library_ms": None,
         "empty_tree_ms": ms["closest-hit kernel, empty tree"],
         "random_rays_ms": ms["closest-hit kernel, random rays"]},
        {"name": "texel_fetch_backward", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/texel_fetch.cu",
         "replaces": "misaki_tpu/render/paged_fetch.py:55",
         "backward_of": "texel_fetch (the JAX package has no backward kernel: it "
                        "differentiates the one-hot fetch, misaki_tpu/core/table.py:26-58)",
         "launches": launches("fetch_bwd"),
         "launches_per_frame": per_frame("fetch_bwd"),
         # per launch, the mean over the envlit gradient's own launches (2^22
         # lanes each); the sums over them and phase 6's 2^20-lane cells beside
         "max_abs_err": max([bp["max_abs_err"]] + [c["max_abs_err"] for c in bwd.values()]),
         "ms": bp["ms"] / n_bp, "plain_ms": bp["plain_ms"] / n_bp,
         "bound_ms": bp["bound_ms"] / n_bp, "bound_by": bp["bound_by"],
         "library_ms": bp["index_add_ms"] / n_bp, "gradient_launches": n_bp,
         "gradient_ms": bp["ms"], "gradient_finalize_ms": bp["finalize_ms"],
         "gradient_bound_ms": bp["bound_ms"], "gradient_library_ms": bp["index_add_ms"],
         "checks_per_launch": bp["launches"][0]["checks"],
         **{f"{cell}_{k}": bwd[cell][k] for cell in bwd
            for k in ("ms", "finalize_ms", "plain_ms", "bound_ms", "index_add_ms")}},
        {"name": "density_kernel", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/ppm_density.cu",
         "replaces": "misaki_tpu/render/ppm.py:282",
         "replaces_note": "no Pallas kernel: _density_blocks is an XLA matmul per 2048-photon "
                          "block",
         "design": "redesigned: photons binned by a stable radix sort into a grid, each "
                   "visible point tests the cells its radius reaches",
         # launches: estimates (tracing.launches["density"]); cuda_launches:
         # the CUDA kernels those estimates enqueued ("density_cuda")
         "launches": launches("density"),
         "launches_per_frame": per_frame("density"),
         "cuda_launches": launches("density_cuda"),
         "cuda_launches_per_frame": per_frame("density_cuda"),
         "cuda_launches_per_estimate": dens["cuda_launches"],
         "max_abs_err": max(d["max_abs_err"] for d in dens_all.values()), "ms": dens["ms"],
         "plain_ms": dens["plain_ms"], "bound_ms": dens["bound_ms"],
         "bound_by": dens["bound_by"], "library_ms": None,
         "dense_form_bound_ms": dens["dense_bound_ms"],
         "pair_tests": dens["pair_tests"], "pairs_passed": dens["pairs_passed"],
         "tolerance_used": max(d["tolerance_used"] for d in dens_all.values()),
         **{f"{cell}_{k}": dens_all[cell][k] for cell in dens_all if cell != "cbox_sppm"
            for k in ("ms", "plain_ms", "bound_ms", "dense_bound_ms", "pair_tests")}},
        {"name": "pcg32", "route": "cuda", "source": "misaki_tpu_torch/csrc/pcg32.cu",
         "replaces": None,
         "replaces_note": "no Pallas kernel: misaki_tpu/core/rng.py's PCG32 is plain jnp",
         # launches: the seedings and groups of draws of the frames whose
         # launch checks count them (phases 4, 7, 9-13, 16, 17); ms etc.: a
         # group of 6 draws at 2^20 lanes, its seeding beside it
         "launches": launches("pcg32"),
         "launches_per_frame": counted_per_frame("pcg32"),
         "max_abs_err": 0.0 if pcg32["equal"] else None,
         "ms": pcg32["20"]["draws_ms"], "plain_ms": pcg32["20"]["draws_plain_ms"],
         "bound_ms": pcg32["20"]["draws_bound_ms"], "bound_by": "bytes", "library_ms": None,
         **{f"{key}_{log2}": pcg32[log2][key] for log2 in ("20", "22")
            for key in ("seed_ms", "seed_plain_ms", "seed_bound_ms", "draws_ms",
                        "draws_plain_ms", "draws_bound_ms")}},
    ]}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": device_name, "nvidia_smi": smi_line, "cluster_kernels": report,
         "texel_fetch": fetch_report, "stage_profile": prof,
         "cbox": {"launches": launches_cbox},
         "envlit": {"launches": launches_env, "checker_corr": corr,
                    "cuda_vs_cpu": [env_mean_rel, env_l1_rel]},
         "gallery": {"launches": launches_gal, "cuda_vs_cpu": gal_cuda_vs_cpu},
         "testballs": balls, **new_paths,
         "checkpoint": checkpoint, "cbox_train": train, "envlit_gradient": grad,
         "volpath": volpath, "photon_mapping": photon, "sharding": sharding,
         "pcg32": pcg32},
        indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
