"""Stage split of one closest-hit cast over the cluster accel, on the card.

    python -m misaki_tpu_torch.tools.profile_cluster_frame [scene.xml] [--reps N] [--out FILE]

On the camera rays of one frame of the scene (default: the bunny stand-in,
`misaki_tpu_torch/scenes/bunny.xml`, 256x256 at 16 spp = 2^20 rays) it times
with CUDA events, each as the mean of `--reps` calls after one warm-up call:

  * `primary_rays` (camera rays and their PCG32 draws);
  * `pack_rays` and `cull_order` (the visit schedule, plain torch);
  * the closest-hit kernel alone with the real schedule (`kernel_only`);
  * the same launch with an empty schedule (count = 0 for every tile): the
    tile's launch and write-back cost without a single cluster visit, so
    the difference to the row above is the per-visit work;
  * `intersect_clusters` end to end.

Before timing, both kernel launches are held against the plain twin
(`closest_hit_plain`) on the same inputs. The table, with the schedule's
visit statistics and the card's name and power limit, goes to `--out`
(default `chiprun_out/profile_bunny.md`).
"""

import argparse
import subprocess
from pathlib import Path

import torch

from misaki_tpu_torch.accel import cluster as cl

ROOT = Path(__file__).resolve().parents[2]
BUNNY_XML = ROOT / "misaki_tpu_torch" / "scenes" / "bunny.xml"
DEFAULT_OUT = ROOT / "chiprun_out" / "profile_bunny.md"


def cuda_time_ms(fn, reps):
    """Mean device time of fn() over `reps` calls after one warm-up call,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_only(acc, rays, order, keys, count):
    """One launch of the closest-hit kernel on a ready schedule."""
    return cl.closest_hit(rays, acc.tri, acc.tab, order, keys, count)


def compare_with_plain(acc, rays, order, keys, count):
    """The kernel against its plain twin on the same inputs: the share of
    rays with the same face id, and the largest |t| difference over the rays
    both hit with the same face. Returns (prim_equal, t_max_abs)."""
    out_k, _ = kernel_only(acc, rays, order, keys, count)
    out_p, _ = cl.closest_hit_plain(rays, acc.tri, acc.tab, order, keys, count)
    same = out_k[3] == out_p[3]
    hit = same & (out_p[3] >= 0)
    t_abs = (out_k[0] - out_p[0]).abs()[hit].max().item() if hit.any() else 0.0
    return same.float().mean().item(), t_abs


def schedule_stats(count, n_clusters):
    """Visit-list statistics of a schedule (tiles, full scans, visits)."""
    c = count.to(torch.int64)
    visits = torch.where(c < 0, n_clusters, c).float()
    return {
        "tiles": int(c.numel()),
        "full_scan": int((c < 0).sum().item()),
        "visits_mean": visits.mean().item(),
        "visits_p50": visits.quantile(0.5).item(),
        "visits_p90": visits.quantile(0.9).item(),
        "visits_max": int(visits.max().item()),
    }


def smi_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def profile(scene_xml=BUNNY_XML, reps=20, out=DEFAULT_OUT):
    """Profile the closest-hit cast of the scene's camera rays on cuda.
    Returns a dict: the stage times in ms, the plain twin's time and the
    kernel-vs-twin check of both schedules, the schedule statistics, the
    closest-hit launches of the timed stages, and the table's path."""
    from misaki_tpu_torch.render import driver
    from misaki_tpu_torch.scene.compiler import load_and_compile

    if not torch.cuda.is_available():
        raise RuntimeError("the stage profile needs a CUDA device")
    scene = load_and_compile(str(scene_xml)).to("cuda")
    acc = scene.cluster
    L = scene.film_width * scene.film_height * scene.spp
    lane = torch.arange(L, dtype=torch.int64, device="cuda")
    ray, _, _ = driver.primary_rays(scene, lane, 0)
    o, d, mint, maxt = ray["o"], ray["d"], ray["mint"], ray["maxt"]
    rays = cl.pack_rays(o, d, mint, maxt)
    order, keys, count = cl.cull_order(rays, acc.bounds, acc.n_clusters)
    count0 = torch.zeros_like(count)

    prim_equal, t_abs = compare_with_plain(acc, rays, order, keys, count)
    prim_equal0, t_abs0 = compare_with_plain(acc, rays, order, keys, count0)
    plain_ms = cuda_time_ms(
        lambda: cl.closest_hit_plain(rays, acc.tri, acc.tab, order, keys, count), 1)

    before = cl.closest_launches
    stages = [
        ("primary_rays", lambda: driver.primary_rays(scene, lane, 0)),
        ("pack_rays", lambda: cl.pack_rays(o, d, mint, maxt)),
        ("cull_order", lambda: cl.cull_order(rays, acc.bounds, acc.n_clusters)),
        ("closest-hit kernel, real schedule", lambda: kernel_only(acc, rays, order, keys, count)),
        ("closest-hit kernel, empty schedule",
         lambda: kernel_only(acc, rays, order, keys, count0)),
        ("intersect_clusters (end to end)",
         lambda: cl.intersect_clusters(acc, o, d, mint, maxt)),
    ]
    rows = [(name, cuda_time_ms(fn, reps)) for name, fn in stages]
    launches = cl.closest_launches - before
    torch.cuda.synchronize()

    stats = schedule_stats(count, acc.n_clusters)
    ms = dict(rows)
    kernel_ms = ms["closest-hit kernel, real schedule"]
    empty_ms = ms["closest-hit kernel, empty schedule"]
    card = smi_line()
    lines = [
        "# Closest-hit stage profile",
        "",
        f"Scene `{Path(scene_xml).name}`: {scene.n_faces} faces, {acc.n_clusters} clusters, "
        f"{L} camera rays ({scene.film_width}x{scene.film_height} at {scene.spp} spp), "
        f"R_TILE={cl.R_TILE}, CLUSTER_FACES={cl.CLUSTER_FACES}, MAX_VISITS={cl.MAX_VISITS}.",
        f"Card: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}.",
        "",
        f"Schedule: {stats['tiles']} tiles, {stats['full_scan']} full scans, visits mean "
        f"{stats['visits_mean']:.2f}, p50 {stats['visits_p50']:.0f}, p90 "
        f"{stats['visits_p90']:.0f}, max {stats['visits_max']}.",
        f"Kernel vs plain twin: real schedule face ids equal {prim_equal:.6f}, max |dt| "
        f"{t_abs:.3e}; empty schedule {prim_equal0:.6f}, {t_abs0:.3e}. Plain twin "
        f"{plain_ms:.3f} ms.",
        "",
        f"CUDA events, mean of {reps} calls after one warm-up:",
        "",
        "| stage | ms/call |",
        "|---|---|",
    ] + [f"| {name} | {t:.4f} |" for name, t in rows] + [
        "",
        f"Per-visit work (real - empty schedule): {kernel_ms - empty_ms:.4f} ms; "
        f"launch and write-back of {stats['tiles']} tiles: {empty_ms:.4f} ms.",
    ]
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    return {"ms": ms, "plain_ms": plain_ms, "prim_equal": prim_equal, "t_max_abs": t_abs,
            "prim_equal_empty": prim_equal0, "t_max_abs_empty": t_abs0, "schedule": stats,
            "launches": launches, "rays": L, "table": str(out)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", nargs="?", default=str(BUNNY_XML))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()
    res = profile(args.scene, args.reps, args.out)
    print(Path(res["table"]).read_text(), end="")


if __name__ == "__main__":
    main()
