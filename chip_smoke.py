#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (misaki_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. a CUDA device is present (name and power limit from nvidia-smi);
  2. the cluster kernels build from csrc/cluster.cu with nvcc (sm_90a);
  3. each kernel against its plain PyTorch twin on the card: the bunny
     stand-in (20,480 faces, 160 clusters) with 2^20 camera-like and 2^20
     random rays, and the Cornell box with 2^20 camera rays; both times;
  4. the main path: the in-repo Cornell box at the benchmark spec (256x256,
     64 spp, 4 bounces, 2^20-lane chunks) through render() on cuda — a
     warm-up frame, then 3 timed frames with the launch counters reset just
     before them and checked after; seconds per frame and rays/s;
  5. a small cbox render on cuda against the same render on the CPU.
Then one JSON line with the kernels' numbers, and last the result line
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

# benchmark spec of the main path (bench.py:29-67)
BENCH_W, BENCH_H, BENCH_SPP, BENCH_DEPTH, BENCH_CHUNK = 256, 256, 64, 4, 1 << 20
N_RAYS = 1 << 20


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def compare_kernels(acc, o, d, maxt_shadow, label, report):
    """Closest-hit and any-hit kernels vs their plain twins on one ray set."""
    import torch

    from misaki_tpu_torch.accel import cluster as cl

    n = o.shape[1]
    mint = torch.full((n,), 1e-4, device="cuda")
    rays = cl.pack_rays(tuple(o), tuple(d), mint, torch.full((n,), float("inf"), device="cuda"))
    order, keys, count = cl.cull_order(rays, acc.bounds, acc.n_clusters)
    out_k, fd_k = cl.closest_hit(rays, acc.tri, acc.tab, order, keys, count)
    out_p, fd_p = cl.closest_hit_plain(rays, acc.tri, acc.tab, order, keys, count)
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

    srays = cl.pack_rays(tuple(o), tuple(d), mint, maxt_shadow)
    sorder, skeys, scount = cl.cull_order(srays, acc.bounds, acc.n_clusters)
    occ_k = cl.any_hit(srays, acc.tri, sorder, skeys, scount)
    occ_p = cl.any_hit_plain(srays, acc.tri, sorder, skeys, scount)
    torch.cuda.synchronize()
    occ_frac = (occ_k == occ_p).float().mean().item()
    occ_rate = occ_p.mean().item()

    ms_c = cuda_time_ms(lambda: cl.closest_hit(rays, acc.tri, acc.tab, order, keys, count), 10)
    ms_cp = cuda_time_ms(lambda: cl.closest_hit_plain(rays, acc.tri, acc.tab, order, keys, count), 1)
    ms_a = cuda_time_ms(lambda: cl.any_hit(srays, acc.tri, sorder, skeys, scount), 10)
    ms_ap = cuda_time_ms(lambda: cl.any_hit_plain(srays, acc.tri, sorder, skeys, scount), 1)
    full = (count < 0).float().mean().item()
    visits = count.abs().float().mean().item()
    phase("3", f"{label}: rays={n} clusters={acc.n_clusters} hit={hit_frac:.4f} "
               f"full_scan_tiles={full:.4f} mean_visit_list={visits:.2f} | closest: "
               f"prim_equal={frac:.6f} t_max_rel={t_rel:.3e} fd_exact={fd_ok} "
               f"kernel_ms={ms_c:.4f} plain_ms={ms_cp:.4f} | any-hit: occluded={occ_rate:.4f} "
               f"equal={occ_frac:.6f} kernel_ms={ms_a:.4f} plain_ms={ms_ap:.4f}")
    ok = frac >= 0.999 and t_rel <= 1e-5 and fd_ok and occ_frac >= 0.9999
    report[label] = dict(prim_equal=frac, t_max_rel=t_rel, t_max_abs=t_abs, fd_exact=fd_ok,
                         occ_equal=occ_frac, closest_ms=ms_c, closest_plain_ms=ms_cp,
                         anyhit_ms=ms_a, anyhit_plain_ms=ms_ap,
                         anyhit_max_abs_err=(occ_k - occ_p).abs().max().item())
    if not ok:
        fail(f"phase 3 {label}: kernel disagrees with its plain twin")


def main():
    import torch

    # ---- phase 1: the card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi: not available"
    phase("1", f"device {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
               f"cuda {torch.version.cuda}")
    print(smi_line, flush=True)
    OUT_DIR.mkdir(exist_ok=True)

    import numpy as np

    from misaki_tpu_torch.accel import cluster as cl
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.render.integrator import n_bounce_iters
    from misaki_tpu_torch.scene import procedural
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.render import driver

    # ---- phase 2: build
    t0 = time.perf_counter()
    cl.build()
    phase("2", f"built {cl.library_path().name} from {cl._SRC.relative_to(ROOT)} "
               f"in {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: kernels vs plain twins
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    bunny = procedural.bunny_standin()
    pos = bunny["positions"].astype(np.float64)
    tab = np.zeros((36, len(pos)), np.float32)
    tab[0] = np.arange(len(pos))
    tab[1:] = np.random.default_rng(0).normal(size=(35, len(pos)))
    acc = cl.build_clusters(pos[:, 0].astype(np.float32), (pos[:, 1] - pos[:, 0]).astype(np.float32),
                            (pos[:, 2] - pos[:, 0]).astype(np.float32), face_tab=tab).to("cuda")
    lo = torch.tensor(pos.reshape(-1, 3).min(0), device="cuda", dtype=torch.float32)
    hi = torch.tensor(pos.reshape(-1, 3).max(0), device="cuda", dtype=torch.float32)
    center, extent = 0.5 * (lo + hi), (hi - lo).max()
    o, d = camera_like_rays(N_RAYS, center, extent, gen)
    compare_kernels(acc, o, d, torch.full((N_RAYS,), 3.0 * float(extent), device="cuda"),
                    "bunny_camera", report)
    o, d = random_rays(N_RAYS, lo - 0.2 * extent, hi + 0.2 * extent, gen)
    compare_kernels(acc, o, d, extent * torch.rand(N_RAYS, device="cuda", generator=gen),
                    "bunny_random", report)

    cbox = load_and_compile(str(CBOX_XML), spp=BENCH_SPP, width=BENCH_W,
                            height=BENCH_H).replace(max_depth=BENCH_DEPTH + 1).to("cuda")
    # the third of the frame's four 2^20-lane chunks (rows 128-191)
    lane = torch.arange(N_RAYS, dtype=torch.int64, device="cuda") + 2 * BENCH_CHUNK
    ray, _, _ = driver.primary_rays(cbox, lane, 0)
    compare_kernels(cbox.cluster, torch.stack(ray["o"]), torch.stack(ray["d"]),
                    0.5 * ray["maxt"].clamp(max=2000.0), "cbox_camera", report)

    # ---- phase 4: the main path at the benchmark spec
    n_samples = BENCH_W * BENCH_H * BENCH_SPP
    n_iters = n_bounce_iters(cbox, BENCH_DEPTH)
    n_chunks = -(-n_samples // BENCH_CHUNK)
    render(cbox, seed=0, chunk_size=BENCH_CHUNK, depth_cap=BENCH_DEPTH)  # warm-up
    torch.cuda.synchronize()
    n_frames = 3
    cl.closest_launches = 0
    cl.anyhit_launches = 0
    t0 = time.perf_counter()
    for i in range(n_frames):
        out = render(cbox, seed=i + 1, chunk_size=BENCH_CHUNK, depth_cap=BENCH_DEPTH)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_frames
    launches = {"closest": cl.closest_launches, "anyhit": cl.anyhit_launches}
    want = {"closest": n_frames * n_chunks * (1 + n_iters),
            "anyhit": n_frames * n_chunks * n_iters}
    rays_per_s = n_samples * (1 + 2 * BENCH_DEPTH) / dt
    phase("4", f"cbox {BENCH_W}x{BENCH_H} {BENCH_SPP} spp depth {BENCH_DEPTH}: "
               f"{dt:.4f} s/frame, {rays_per_s:.6e} rays/s ({n_frames} frames, "
               f"{n_chunks} chunks of {BENCH_CHUNK}); launches {launches} expected {want}")
    if launches != want:
        fail(f"phase 4: kernel launch counts {launches} != expected {want}")
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
    try_profile(cbox, render, dt)

    # ---- phase 5: cuda vs cpu on a small cbox
    small = load_and_compile(str(CBOX_XML), spp=16, width=64, height=48)
    a = render(small.to("cuda"), seed=7, depth_cap=4)["rgb"].cpu().numpy()
    b = render(small, seed=7, depth_cap=4)["rgb"].numpy()
    mean_rel = abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    l1_rel = np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12)
    phase("5", f"cbox 64x48 16 spp cuda vs cpu: mean rel diff {mean_rel:.3e}, "
               f"relative L1 {l1_rel:.3e}")
    if not (mean_rel < 5e-3 and l1_rel < 2e-2):
        fail("phase 5: cuda render disagrees with the cpu render")

    main_case = report["cbox_camera"]
    kernels = {"kernels": [
        {"name": "cluster_closest_hit", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/cluster.cu",
         "replaces": "misaki_tpu/accel/cluster.py:367",
         "launches": launches["closest"], "max_abs_err": main_case["t_max_abs"],
         "ms": main_case["closest_ms"], "plain_ms": main_case["closest_plain_ms"]},
        {"name": "cluster_any_hit", "route": "cuda",
         "source": "misaki_tpu_torch/csrc/cluster.cu",
         "replaces": "misaki_tpu/accel/cluster.py:467",
         "launches": launches["anyhit"], "max_abs_err": main_case["anyhit_max_abs_err"],
         "ms": main_case["anyhit_ms"], "plain_ms": main_case["anyhit_plain_ms"]},
    ]}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi_line, "kernels": report,
         "frame_s": dt, "rays_per_s": rays_per_s}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def try_profile(scene, render, frame_s):
    """One frame under torch.profiler: device time by kernel, the number of
    kernel launches, and the device's busy share of an unprofiled frame
    (`frame_s`). The table goes to chiprun_out/profile.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, seed=11, chunk_size=BENCH_CHUNK, depth_cap=BENCH_DEPTH)
        torch.cuda.synchronize()
    events = prof.key_averages()
    (OUT_DIR / "profile.txt").write_text(events.table(sort_by="self_device_time_total",
                                                      row_limit=60))

    def self_time(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    kernels = [e for e in events if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy = sum(self_time(e) for e in kernels) / 1e6
    if busy == 0:
        phase("4", "profile: no device time recorded (not measured)")
        return
    launches = sum(e.count for e in kernels)
    cluster_t = sum(self_time(e) for e in kernels
                    if "closest_hit" in e.key or "any_hit" in e.key) / 1e6
    kernels.sort(key=lambda e: -self_time(e))
    top = "; ".join(f"{e.key[:60]} {self_time(e) / 1e3:.3f} ms x{e.count}" for e in kernels[:6])
    phase("4", f"profile of one frame: {launches} kernel launches, device busy {busy:.4f} s "
               f"= {busy / frame_s:.3f} of the unprofiled {frame_s:.4f} s frame; cluster kernels "
               f"{cluster_t:.4f} s = {cluster_t / busy:.3f} of device time; top: {top}")


if __name__ == "__main__":
    main()
