#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (misaki_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. a CUDA device is present (name and power limit from nvidia-smi);
  2. the kernels build from csrc/cluster.cu and csrc/texel_fetch.cu with
     nvcc (sm_90a), one nvcc per source, started together;
  3. each cluster kernel against its plain PyTorch twin on the card: the
     bunny stand-in (20,480 faces, 160 clusters; its accel's host build
     timed) with 2^20 camera-like and 2^20 random rays, the Cornell box with
     2^20 camera rays, the bunny with every face duplicated into a second
     set of clusters (every hit an exact tie, which the copy's larger face
     id must win) and an accel with no faces; both times and each cast's
     bound;
  4. the cbox main path at the benchmark spec (256x256, 64 spp, 4 bounces,
     2^20-lane chunks) through render() on cuda — a warm-up frame, then 3
     timed frames with the launch counters reset just before them and
     checked after; seconds per frame and rays/s;
  5. a small cbox render on cuda against the same render on the CPU;
  6. the texel-fetch kernel against its plain twin at 2^20 lanes
     (misaki_tpu_torch.tools.profile_texel_fetch): random bilinear taps into
     the envlit scene's 2048x4096 envmap, camera-coherent taps into its
     1024^2 bitmap with the mip levels spread, the envmap's own NEE taps,
     and the split launches (every tap dead; every tap on texel 0; the
     random taps modulo a 4 MB table), each with its bound and sector
     bytes; beside it the library call F.embedding_bag on the same taps
     (timed and checked, never used by the port);
  7. the envlit main path (the bunny stand-in on a bitmap-textured floor
     under a 2048x4096 HDR sky, 256x256, 64 spp, 4 bounces) through render()
     on cuda, as in phase 4, with the launches of all three kernels checked
     and the texel fetch's device time per launch in the frame; image
     checks; a small envlit render on cuda against the CPU;
  8. the closest-hit stage profile (misaki_tpu_torch.tools.profile_cluster_frame)
     on the bunny stand-in's camera rays and on random rays;
  9. the material gallery (misaki_tpu_torch/scenes/materials/: nine spheres,
     one per BSDF kind but null, the gold ball's GGX alpha from a 256^2
     bitmap, a constant environment and a point light) at the benchmark
     spec through render() on cuda, as in phase 4, with the launches of all
     three kernels checked; device busy share and top kernels from one
     profiled frame; image checks (finite and non-negative, every ball's
     mean off the floor's, the glass balls not black); a small gallery
     render on cuda against the CPU;
 10. Figure 2 and Figure 3, the rough-conductor and rough-dielectric test
     balls (misaki_tpu_torch/scenes/testball/), at their declared 1280x720,
     128 spp (max_depth 5 and 7): a small warm-up render, then one timed
     frame each with the cluster launches checked; the same image checks;
     device busy share and top kernels from a profiled 16 spp frame at
     1280x720; a small render of each on cuda against the CPU.
Every kernel time is a device time taken one way
(`profile_cluster_frame.device_ms`: CUDA events around launches enqueued
while a device sleep holds the stream, so the host's launch cost is not in
it). Then one JSON line with the kernels' numbers, and last the result line
{"ok": true, "device": {...}}. Extra detail goes to chiprun_out/.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
CBOX_XML = ROOT / "misaki_tpu_torch" / "scenes" / "cbox" / "scene.xml"
SCENE_BUILD = ROOT / "build" / "scenes" / "envlit"
GALLERY_BUILD = ROOT / "build" / "scenes" / "materials"
TESTBALL_DIR = ROOT / "misaki_tpu_torch" / "scenes" / "testball"

# benchmark spec of the main path (bench.py:29-67)
BENCH_W, BENCH_H, BENCH_SPP, BENCH_DEPTH, BENCH_CHUNK = 256, 256, 64, 4, 1 << 20
N_RAYS = 1 << 20
N_FRAMES = 3


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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
    from misaki_tpu_torch.accel import cluster as cl
    from misaki_tpu_torch.render import texel_fetch as tf

    cl.closest_launches = 0
    cl.anyhit_launches = 0
    tf.fetch_launches = 0


def read_counts():
    from misaki_tpu_torch.accel import cluster as cl
    from misaki_tpu_torch.render import texel_fetch as tf

    return {"closest": cl.closest_launches, "anyhit": cl.anyhit_launches,
            "fetch": tf.fetch_launches}


def timed_frames(scene, label, want_per_chunk, n_frames=N_FRAMES, warmup=None):
    """A warm-up frame (of `warmup`, else of `scene`), then `n_frames` timed
    frames of `scene` on cuda with every launch count set to 0 just before
    them and read just after; fails unless the counts are n_frames * chunks
    * `want_per_chunk`. Rays per frame count `bench.py:65-68`'s way: W * H *
    spp * (1 + 2 * bounce iterations). Returns (last frame's output, seconds
    per frame, rays/s, launches)."""
    import torch

    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.render.integrator import n_bounce_iters

    n_samples = scene.film_width * scene.film_height * scene.spp
    n_chunks = -(-n_samples // BENCH_CHUNK)
    n_iters = n_bounce_iters(scene, BENCH_DEPTH)
    render(scene if warmup is None else warmup, seed=0, chunk_size=BENCH_CHUNK,
           depth_cap=BENCH_DEPTH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i in range(n_frames):
        out = render(scene, seed=i + 1, chunk_size=BENCH_CHUNK, depth_cap=BENCH_DEPTH)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_frames
    launches = read_counts()
    want = {k: n_frames * n_chunks * v for k, v in want_per_chunk.items()}
    rays_per_s = n_samples * (1 + 2 * n_iters) / dt
    phase(label, f"{scene.film_width}x{scene.film_height} {scene.spp} spp, {n_iters} bounce "
                 f"iterations: {dt:.4f} s/frame, {rays_per_s:.6e} rays/s ({n_frames} frames, "
                 f"{n_chunks} chunks of {BENCH_CHUNK}); launches {launches} expected {want}")
    if launches != want:
        fail(f"phase {label}: kernel launch counts {launches} != expected {want}")
    return out, dt, rays_per_s, launches


def cuda_vs_cpu(scene_cpu, label):
    """The same small render on cuda and on the CPU: relative difference of
    the image means < 0.5%, relative L1 < 2% (the splat adds in atomic order
    on the card)."""
    import numpy as np

    from misaki_tpu_torch.render.driver import render

    a = render(scene_cpu.to("cuda"), seed=7, depth_cap=4)["rgb"].cpu().numpy()
    b = render(scene_cpu, seed=7, depth_cap=4)["rgb"].numpy()
    mean_rel = float(abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12))
    l1_rel = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))
    phase(label, f"{scene_cpu.film_width}x{scene_cpu.film_height} {scene_cpu.spp} spp cuda vs "
                 f"cpu: mean rel diff {mean_rel:.3e}, relative L1 {l1_rel:.3e}")
    if not (mean_rel < 5e-3 and l1_rel < 2e-2):
        fail(f"phase {label}: cuda render disagrees with the cpu render")
    return mean_rel, l1_rel


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
    phase("1", f"device {device_name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
               f"cuda {torch.version.cuda}")
    print(smi_line, flush=True)
    OUT_DIR.mkdir(exist_ok=True)

    import numpy as np

    from misaki_tpu_torch.accel import cluster as cl
    from misaki_tpu_torch.render import driver
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
    t0 = time.perf_counter()
    libs = cuda_build.compile_sources([cl.SRC, tf.SRC])
    cl.build()
    tf.build()
    phase("2", f"built {', '.join(p.name for p in libs)} from "
               f"{cl.SRC.relative_to(ROOT)}, {tf.SRC.relative_to(ROOT)} in "
               f"{time.perf_counter() - t0:.2f} s")

    # ---- phase 3: cluster kernels vs plain twins
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    bunny = procedural.bunny_standin()
    pos = bunny["positions"].astype(np.float64)
    tab = np.zeros((36, len(pos)), np.float32)
    tab[0] = np.arange(len(pos))
    tab[1:] = np.random.default_rng(0).normal(size=(35, len(pos)))
    t0 = time.perf_counter()
    acc_host = cl.build_clusters(pos[:, 0].astype(np.float32),
                                 (pos[:, 1] - pos[:, 0]).astype(np.float32),
                                 (pos[:, 2] - pos[:, 0]).astype(np.float32), face_tab=tab)
    build_s = time.perf_counter() - t0
    acc = acc_host.to("cuda")
    phase("3", f"bunny accel host build {build_s:.4f} s: {len(pos)} faces, {acc.n_clusters} "
               f"clusters, {acc.nodes.shape[0]} BVH2 nodes")
    report["bunny_build_s"] = build_s
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
    out, dt, rays_per_s, launches_cbox = timed_frames(
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

    # device-time breakdown of one frame (torch.profiler; CUDA events above)
    profile_cbox = try_profile(cbox, dt, "4", "profile.txt")

    # ---- phase 5: cuda vs cpu on a small cbox
    cuda_vs_cpu(load_and_compile(str(CBOX_XML), spp=16, width=64, height=48, device="cpu"), "5")

    # ---- phase 6: the texel-fetch kernel vs its plain twin at 2^20 lanes
    t0 = time.perf_counter()
    envlit_xml = assets.prepared(SCENE_BUILD)
    envlit = load_and_compile(str(envlit_xml))
    phase("6", f"envlit scene {envlit_xml.relative_to(ROOT)}: {envlit.n_faces} faces, "
               f"{envlit.cluster.n_clusters} clusters, env {tuple(envlit.emitters.env_rgb.shape)}, "
               f"sampling {tuple(envlit.emitters.env_pmf.shape)}, bitmap texels "
               f"{envlit.bitmaps.shape[0]}; assets and compile {time.perf_counter() - t0:.2f} s")
    # random envmap taps, a raster over every mip level of the floor's
    # bitmap, the envmap's NEE taps, and the split launches
    fetch_report = compare_fetch(envlit)

    # ---- phase 7: the envlit main path at full size
    n_iters = n_bounce_iters(envlit, BENCH_DEPTH)
    n_bitmaps = len(envlit.bitmap_slots) * len(envlit.bitmap_meta)
    # texel fetches per chunk: the primary escape, then per bounce each
    # bitmap slot, the envmap's NEE sample and the bounce ray's escape
    out, dt_env, rays_env, launches_env = timed_frames(
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
    profile_env = try_profile(envlit, dt_env, "7", "profile_envlit.txt")
    small = load_and_compile(str(envlit_xml), spp=16, width=64, height=48, device="cpu")
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
    t0 = time.perf_counter()
    gallery_xml = materials_assets.prepared(GALLERY_BUILD)
    gallery = load_and_compile(str(gallery_xml))
    phase("9", f"gallery {gallery_xml.relative_to(ROOT)}: {gallery.n_faces} faces, "
               f"{gallery.cluster.n_clusters} clusters, BSDF kinds {gallery.bsdf_kinds}, "
               f"bitmap slots {gallery.bitmap_slots}, emitter kinds {gallery.emitter_kinds}, "
               f"max_depth {gallery.max_depth}; assets and compile "
               f"{time.perf_counter() - t0:.2f} s")
    n_iters = n_bounce_iters(gallery, BENCH_DEPTH)
    # texel fetches per chunk: each bounce's material_params evaluates every
    # slot that holds a bitmap (the gold ball's alpha_u and alpha_v), one
    # fetch per bitmap of the scene; the environment is `constant`, so no
    # envmap fetch (escape or NEE) runs
    n_bitmaps = len(gallery.bitmap_slots) * len(gallery.bitmap_meta)
    out, dt_gal, rays_gal, launches_gal = timed_frames(
        gallery, "9", {"closest": 1 + n_iters, "anyhit": n_iters, "fetch": n_iters * n_bitmaps})
    rgb = out["rgb"].cpu().numpy()
    np.save(OUT_DIR / "gallery_bench_rgb.npy", rgb)
    ball_checks(gallery, rgb, [(i,) for i in range(9)], 9, "9")
    profile_gal = try_profile(gallery, dt_gal, "9", "profile_gallery.txt")
    small = load_and_compile(str(gallery_xml), spp=2, width=32, height=24, device="cpu")
    gal_cuda_vs_cpu = cuda_vs_cpu(small, "9")

    # ---- phase 10: Figure 2 and Figure 3 at their declared spec
    balls = {}
    for fig, xml_name in (("figure2", "roughconductor"), ("figure3", "roughdielectric")):
        xml = TESTBALL_DIR / f"{xml_name}.xml"
        t0 = time.perf_counter()
        tb = load_and_compile(str(xml))
        n_iters = n_bounce_iters(tb, BENCH_DEPTH)
        phase("10", f"{fig} {xml.relative_to(ROOT)}: {tb.n_faces} faces, "
                    f"{tb.cluster.n_clusters} clusters, BSDF kinds {tb.bsdf_kinds}, max_depth "
                    f"{tb.max_depth}; compile {time.perf_counter() - t0:.2f} s")
        warm = load_and_compile(str(xml), spp=4, width=128, height=72)
        out, dt_tb, rays_tb, launches_tb = timed_frames(
            tb, "10", {"closest": 1 + n_iters, "anyhit": n_iters, "fetch": 0},
            n_frames=1, warmup=warm)
        rgb = out["rgb"].cpu().numpy()
        np.save(OUT_DIR / f"{fig}_{xml_name}_rgb.npy", rgb)
        # shapes: Mesh000 the stand, Mesh001 and Mesh003 the ball, Mesh002
        # the core, then the floor
        ball_checks(tb, rgb, [(1, 3)], 4, "10")
        # device busy share from a 16 spp frame at the declared resolution
        # (15 of the frame's 113 chunks: profiling all 113 chunks' ~1M
        # launches costs minutes), against the same frame unprofiled
        part = tb.replace(spp=16)
        t0 = time.perf_counter()
        driver.render(part, seed=12, chunk_size=BENCH_CHUNK, depth_cap=BENCH_DEPTH)
        torch.cuda.synchronize()
        part_s = time.perf_counter() - t0
        prof_tb = try_profile(part, part_s, "10", f"profile_{fig}.txt")
        small = load_and_compile(str(xml), spp=2, width=32, height=18, device="cpu")
        balls[fig] = {"scene": xml_name, "frame_s": dt_tb, "rays_per_s": rays_tb,
                      "launches": launches_tb, "spp16_frame_s": part_s, "spp16_profile": prof_tb,
                      "cuda_vs_cpu": cuda_vs_cpu(small, "10")}

    main_case = report["cbox_camera"]
    fa, fb, fn = (fetch_report[c] for c in ("env_random", "bitmap_camera_mips", "env_nee"))
    main_runs = {"cbox": (launches_cbox, N_FRAMES), "envlit": (launches_env, N_FRAMES),
                 "gallery": (launches_gal, N_FRAMES),
                 **{fig: (b["launches"], 1) for fig, b in balls.items()}}

    def launches(key):
        return sum(counts[key] for counts, _ in main_runs.values())

    def per_frame(key):
        return {run: counts[key] / frames for run, (counts, frames) in main_runs.items()}

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
    ]}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": device_name, "nvidia_smi": smi_line, "cluster_kernels": report,
         "texel_fetch": fetch_report, "stage_profile": prof,
         "cbox": {"frame_s": dt, "rays_per_s": rays_per_s, "launches": launches_cbox,
                  "profile": profile_cbox},
         "envlit": {"frame_s": dt_env, "rays_per_s": rays_env, "launches": launches_env,
                    "profile": profile_env, "checker_corr": corr,
                    "cuda_vs_cpu": [env_mean_rel, env_l1_rel]},
         "gallery": {"frame_s": dt_gal, "rays_per_s": rays_gal, "launches": launches_gal,
                     "profile": profile_gal, "cuda_vs_cpu": gal_cuda_vs_cpu},
         "testballs": balls}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def try_profile(scene, frame_s, label, table_name):
    """One frame under torch.profiler: device time by kernel, the number of
    kernel launches, and the device's busy share of an unprofiled frame
    (`frame_s`). The table goes to chiprun_out/`table_name`. Returns the
    numbers, or None when the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from misaki_tpu_torch.render.driver import render

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, seed=11, chunk_size=BENCH_CHUNK, depth_cap=BENCH_DEPTH)
        torch.cuda.synchronize()
    events = prof.key_averages()
    (OUT_DIR / table_name).write_text(events.table(sort_by="self_device_time_total",
                                                   row_limit=60))

    def self_time(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(self_time(e) for e in kernels) / 1e6
    if busy == 0:
        phase(label, "profile: no device time recorded (not measured)")
        return None
    launches = sum(e.count for e in kernels)

    def named(part):
        """Device seconds and launches of the kernels whose name holds `part`."""
        sel = [e for e in kernels if part in e.key]
        return sum(self_time(e) for e in sel) / 1e6, sum(e.count for e in sel)

    (closest_t, n_closest), (any_t, n_any) = named("closest_hit"), named("any_hit")
    cluster_t = closest_t + any_t
    fetch_t, n_fetch = named("fetch4")
    kernels.sort(key=lambda e: -self_time(e))
    top = "; ".join(f"{e.key[:60]} {self_time(e) / 1e3:.3f} ms x{e.count}" for e in kernels[:6])
    cast_ms = {"closest": 1e3 * closest_t / max(n_closest, 1), "anyhit": 1e3 * any_t / max(n_any, 1)}
    fetch_ms = 1e3 * fetch_t / max(n_fetch, 1)
    phase(label, f"profile of one frame: {launches} kernel launches, device busy {busy:.4f} s "
                 f"= {busy / frame_s:.3f} of the unprofiled {frame_s:.4f} s frame; cluster "
                 f"kernels {cluster_t:.4f} s = {cluster_t / busy:.3f} of device time (closest "
                 f"hit {closest_t:.4f} s over {n_closest} launches, {cast_ms['closest']:.4f} ms "
                 f"each; any hit {any_t:.4f} s over {n_any}, {cast_ms['anyhit']:.4f} ms each), "
                 f"texel fetch {fetch_t:.4f} s = {fetch_t / busy:.3f} over {n_fetch} launches, "
                 f"{fetch_ms:.4f} ms each; top: {top}")
    return {"launches": launches, "busy_s": busy, "busy_share": busy / frame_s,
            "cluster_s": cluster_t, "cluster_share": cluster_t / busy, "fetch_s": fetch_t,
            "fetch_launches": n_fetch, "fetch_ms_per_launch": fetch_ms, "cast_ms": cast_ms}


if __name__ == "__main__":
    main()
