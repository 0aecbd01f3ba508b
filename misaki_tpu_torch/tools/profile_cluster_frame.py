"""Stage split of one closest-hit cast over the BVH2, on the card.

    python -m misaki_tpu_torch.tools.profile_cluster_frame [scene.xml] [--reps N] [--out FILE]

On the camera rays of one frame of the scene (default: the bunny stand-in,
`misaki_tpu_torch/scenes/bunny.xml`, 256x256 at 16 spp = 2^20 rays), and on
as many random rays through the scene's box (incoherent: random origins
around the mesh, random directions), it times on the device (`device_ms`:
CUDA events, the launches enqueued behind a held stream), each as the mean
of `--reps` calls after one warm-up call:

  * `primary_rays` (camera rays and their PCG32 draws) and `pack_rays`;
  * the closest-hit kernel alone on the camera rays (`kernel_only`);
  * the same launch over an empty tree (a root with two empty children):
    launch, ray read and write-back with no node visit beyond the root, so
    the difference to the row above is the traversal;
  * `intersect_clusters` end to end on the camera rays;
  * the closest-hit kernel alone on the random rays.

Before timing, the launches are held against the plain twin
(`closest_hit_plain`) on the same inputs (the random rays on their first
2^16). Each ray's nodes visited and faces tested come from the kernel's
counts output (mean, p90, max), beside the clusters per tile that the plain
twin's tile schedule would visit. The table, with the bound of each cast and
the card's name and power limit, goes to `--out` (default
`chiprun_out/profile_bunny.md`).
"""

import argparse
import functools
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from misaki_tpu_torch.accel import cluster as cl

ROOT = Path(__file__).resolve().parents[2]
BUNNY_XML = ROOT / "misaki_tpu_torch" / "scenes" / "bunny.xml"
DEFAULT_OUT = ROOT / "chiprun_out" / "profile_bunny.md"

# An H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and FP32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MT_OPS = 45          # FP32 operations of one Moller-Trumbore test
RANDOM_CHECK = 1 << 16


@functools.cache
def _ms_per_sleep_cycle():
    """The device's ms per cycle of `torch.cuda._sleep`, measured once."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 10 ** 7


def device_ms(fn, reps):
    """Mean device time of fn() over `reps` calls after one warm-up call, by
    CUDA events around calls that the host enqueues while a device sleep
    holds the stream, so the device runs them back to back and the host's
    launch cost is not in the time (a wrapper's 30-60 us exceeds a short
    kernel's run)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # the hold covers three times the warm-up's host time per call; a call
    # that waits on the device (a plain twin's .item()) drains the queue
    # however long the hold, so the hold stops at a second
    hold_ms = min(3.0 * reps * host_ms + 2.0, 1e3)
    torch.cuda._sleep(int(hold_ms / _ms_per_sleep_cycle()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: the larger of bytes over HBM rate
    and FP32 operations over the FP32 peak. Returns (ms, "bytes" or
    "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bytes(acc):
    return acc.nodes.numel() * 4 + acc.leaf_tri.numel() * 4


def closest_bound(rays, acc, out):
    """Bound of one closest-hit cast: each ray read once (32 B), its hit
    (16 B) and face row (4T B) written once, the tree and faces read once,
    and the face rows of the distinct winners; one Moller-Trumbore test per
    hit ray."""
    Lp = rays.shape[1]
    T = acc.tab.shape[1]
    hit = out[3] >= 0
    winners = int(torch.unique(out[3][hit]).numel())
    n_bytes = Lp * (32 + 16 + 4 * T) + table_bytes(acc) + winners * 4 * T
    return bound_ms(n_bytes, int(hit.sum().item()) * MT_OPS)


def any_bound(rays, acc, occ):
    """Bound of one any-hit cast: rays read (32 B) and the flag written
    (4 B) once, the tree and faces read once; one test per occluded ray."""
    Lp = rays.shape[1]
    return bound_ms(Lp * 36 + table_bytes(acc), int((occ > 0).sum().item()) * MT_OPS)


def kernel_only(acc, rays, counts=None):
    """One launch of the closest-hit kernel on packed rays."""
    return cl.closest_hit(rays, acc, counts)


def compare_with_plain(acc, rays):
    """The kernel against its plain twin on the same inputs: the share of
    rays with the same face id, and the largest |t| difference over the rays
    both hit with the same face. Returns (prim_equal, t_max_abs)."""
    out_k, _ = kernel_only(acc, rays)
    out_p, _ = cl.closest_hit_plain(rays, acc)
    same = out_k[3] == out_p[3]
    hit = same & (out_p[3] >= 0)
    t_abs = (out_k[0] - out_p[0]).abs()[hit].max().item() if hit.any() else 0.0
    return same.float().mean().item(), t_abs


def schedule_stats(count, n_clusters):
    """Visit-list statistics of the plain twin's tile schedule (tiles, full
    scans, clusters visited per tile): what the tile walk would cost."""
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


def traversal_stats(acc, rays):
    """Per-ray nodes visited and faces tested, from the kernel's counts
    output (padded lanes excluded)."""
    counts = torch.zeros((2, rays.shape[1]), dtype=torch.int32, device=rays.device)
    kernel_only(acc, rays, counts)
    live = rays[7] >= 0
    stats = {}
    for name, row in (("nodes", counts[0]), ("faces", counts[1])):
        x = row[live].float()
        stats[name] = {"mean": x.mean().item(), "p90": x.quantile(0.9).item(),
                       "max": int(x.max().item())}
    return stats


def random_rays(acc, n, seed):
    """Random origins in the mesh's box grown by a fifth of its extent on
    every side, random unit directions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = acc.bounds[0:3, :acc.n_clusters].amin(dim=1)
    hi = acc.bounds[3:6, :acc.n_clusters].amax(dim=1)
    ext = (hi - lo).max()
    o = (lo - 0.2 * ext)[:, None] + (hi - lo + 0.4 * ext)[:, None] * torch.rand(
        (3, n), device="cuda", generator=g)
    d = torch.randn((3, n), device="cuda", generator=g)
    return o, d / torch.linalg.norm(d, dim=0, keepdim=True)


def empty_tree(T):
    """An accel with no faces and face rows of T columns, on the card."""
    z = np.zeros((0, 3), np.float32)
    return cl.build_clusters(z, z, z, face_tab=np.zeros((T, 0), np.float32)).to("cuda")


def smi_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def _fmt(s):
    return ", ".join(f"{k} mean {v['mean']:.2f} p90 {v['p90']:.0f} max {v['max']}"
                     for k, v in s.items())


def profile(scene_xml=BUNNY_XML, reps=20, out=DEFAULT_OUT):
    """Profile the closest-hit casts of the scene's camera rays and of random
    rays on cuda. Returns a dict: the stage times in ms, the plain twin's
    time and the kernel-vs-twin checks, the traversal statistics, the bounds,
    the closest-hit launches of the timed stages, and the table's path."""
    from misaki_tpu_torch.render import driver
    from misaki_tpu_torch.scene.compiler import load_and_compile

    if not torch.cuda.is_available():
        raise RuntimeError("the stage profile needs a CUDA device")
    scene = load_and_compile(str(scene_xml), device="cuda")
    acc = scene.cluster
    empty = empty_tree(acc.tab.shape[1])
    L = scene.film_width * scene.film_height * scene.spp
    lane = torch.arange(L, dtype=torch.int64, device="cuda")
    ray, _, _ = driver.primary_rays(scene, lane, 0)
    o, d, mint, maxt = ray["o"], ray["d"], ray["mint"], ray["maxt"]
    rays = cl.pack_rays(o, d, mint, maxt)
    ro, rd = random_rays(acc, L, 1)
    rrays = cl.pack_rays(tuple(ro), tuple(rd), torch.full((L,), 1e-4, device="cuda"),
                         torch.full((L,), float("inf"), device="cuda"))

    prim_equal, t_abs = compare_with_plain(acc, rays)
    prim_equal0, t_abs0 = compare_with_plain(empty, rays)
    prim_equal_r, t_abs_r = compare_with_plain(acc, rrays[:, :RANDOM_CHECK].contiguous())
    plain_ms = device_ms(lambda: cl.closest_hit_plain(rays, acc), 1)
    stats = {"camera": traversal_stats(acc, rays), "random": traversal_stats(acc, rrays),
             "empty": traversal_stats(empty, rays)}
    schedule = {k: schedule_stats(cl.cull_order(r, acc.bounds, acc.n_clusters)[2],
                                  acc.n_clusters) for k, r in (("camera", rays), ("random", rrays))}
    bounds = {"camera": closest_bound(rays, acc, kernel_only(acc, rays)[0]),
              "random": closest_bound(rrays, acc, kernel_only(acc, rrays)[0])}

    before = cl.closest_launches
    stages = [
        ("primary_rays", lambda: driver.primary_rays(scene, lane, 0)),
        ("pack_rays", lambda: cl.pack_rays(o, d, mint, maxt)),
        ("closest-hit kernel, camera rays", lambda: kernel_only(acc, rays)),
        ("closest-hit kernel, empty tree", lambda: kernel_only(empty, rays)),
        ("intersect_clusters (end to end)",
         lambda: cl.intersect_clusters(acc, o, d, mint, maxt)),
        ("closest-hit kernel, random rays", lambda: kernel_only(acc, rrays)),
    ]
    rows = [(name, device_ms(fn, reps)) for name, fn in stages]
    launches = cl.closest_launches - before
    torch.cuda.synchronize()

    ms = dict(rows)
    kernel_ms = ms["closest-hit kernel, camera rays"]
    empty_ms = ms["closest-hit kernel, empty tree"]
    card = smi_line()
    lines = [
        "# Closest-hit stage profile",
        "",
        f"Scene `{Path(scene_xml).name}`: {scene.n_faces} faces, {acc.n_clusters} clusters, "
        f"{acc.nodes.shape[0]} BVH2 nodes, leaves of <= {cl.LEAF_FACES} faces; {L} camera rays "
        f"({scene.film_width}x{scene.film_height} at {scene.spp} spp) and {L} random rays.",
        f"Card: {torch.cuda.get_device_name(0)} ({card}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}.",
        "",
        f"Traversal per ray: camera {_fmt(stats['camera'])}; random {_fmt(stats['random'])}; "
        f"empty tree {_fmt(stats['empty'])}.",
        "Plain twin's tile schedule (clusters per 256-ray tile): " + "; ".join(
            f"{k} {v['tiles']} tiles, {v['full_scan']} full scans, visits mean "
            f"{v['visits_mean']:.2f}, p90 {v['visits_p90']:.0f}"
            for k, v in schedule.items()) + ".",
        f"Kernel vs plain twin: camera rays face ids equal {prim_equal:.6f}, max |dt| "
        f"{t_abs:.3e}; empty tree {prim_equal0:.6f}, {t_abs0:.3e}; random rays (first "
        f"{RANDOM_CHECK}) {prim_equal_r:.6f}, {t_abs_r:.3e}. Plain twin on the camera rays "
        f"{plain_ms:.3f} ms.",
        f"Bound (bytes over 3.35 TB/s, or FP32 operations over 67 TFLOP/s): camera rays "
        f"{bounds['camera'][0]:.4f} ms ({bounds['camera'][1]}), random rays "
        f"{bounds['random'][0]:.4f} ms ({bounds['random'][1]}).",
        "",
        f"Device time (CUDA events, launches enqueued behind a held stream), mean of "
        f"{reps} calls after one warm-up:",
        "",
        "| stage | ms/call |",
        "|---|---|",
    ] + [f"| {name} | {t:.4f} |" for name, t in rows] + [
        "",
        f"Traversal (camera rays - empty tree): {kernel_ms - empty_ms:.4f} ms; launch, ray "
        f"read and write-back: {empty_ms:.4f} ms.",
    ]
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    return {"ms": ms, "plain_ms": plain_ms, "prim_equal": prim_equal, "t_max_abs": t_abs,
            "prim_equal_empty": prim_equal0, "t_max_abs_empty": t_abs0,
            "prim_equal_random": prim_equal_r, "t_max_abs_random": t_abs_r,
            "traversal": stats, "schedule": schedule,
            "bound_ms": {k: v[0] for k, v in bounds.items()},
            "bound_by": {k: v[1] for k, v in bounds.items()},
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
