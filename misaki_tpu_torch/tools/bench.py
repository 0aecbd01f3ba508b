"""Benchmark of the port: rays/s of the Cornell-box path trace at the spec of
the JAX package's bench.py (256x256, 64 spp, 4 bounce iterations, 2^20-lane
chunks), on the card.

    python -m misaki_tpu_torch.tools.bench [--device cuda] [--no-extra]

Prints the headline first, alone, as one JSON line {"metric":
"cbox_4bounce_rays_per_s", "value", "unit", "frame_s", "device"}, so that a
later failure cannot lose it; then one JSON line {"extra": {...},
"cuda_cpu_parity": {...}, "device"} with

  * bunny_debug_rays_per_s: scenes/bunny_debug.xml (768x768, 1 spp, the
    debug integrator: one camera ray per sample), 15 frames;
  * figure2_roughconductor_rays_per_s: scenes/testball/roughconductor.xml
    at 320x180, 16 spp, 4 bounce iterations, 3 frames;
  * cuda_cpu_parity: a 64x48, 16 spp cbox render on the card and on the CPU
    (relative difference of the image means < 0.5%, relative L1 < 2%).

The extras' depth caps are pinned at 4, as bench.py pins them, and do not
follow `--depth`: a cap that followed the headline's would change what an
extra measures whenever `--depth` moves, on any scene whose XML leaves
max_depth unbounded.

Rays are counted as bench.py counts them: per sample 1 camera ray plus a
closest-hit and a shadow ray per bounce iteration, whether or not the lane
is still active. Each rate is timed over frames of varied seeds after a
warm-up frame, the host clock ended by torch.cuda.synchronize(). `device` is
the line `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
prints.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SCENES = Path(__file__).resolve().parents[1] / "scenes"


def device_line(device):
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def rays_per_sample(scene, depth_cap):
    """Rays cast per sample: debug the camera ray; direct the camera ray, a
    shadow ray per emitter sample and a ray per BSDF sample; path the camera
    ray and two per bounce iteration; aov its own camera ray and those of
    the nested integrator."""
    from misaki_tpu_torch.render.integrator import n_bounce_iters

    if scene.integrator == "debug":
        return 1
    if scene.integrator == "direct":
        return 1 + max(scene.direct_light_samples, 1) + max(scene.direct_bsdf_samples, 1)
    if scene.integrator == "aov":
        return 1 + rays_per_sample(scene.replace(integrator=scene.aov_nested), depth_cap)
    return 1 + 2 * n_bounce_iters(scene, depth_cap)


# (metric, XML under scenes/, frames, depth cap, compile overrides)
EXTRAS = (
    ("bunny_debug_rays_per_s", "bunny_debug.xml", 15, 4, {}),
    ("figure2_roughconductor_rays_per_s", "testball/roughconductor.xml", 3, 4,
     dict(spp=16, width=320, height=180)),
)


def quiet(done, total):
    """A progress callback that reports nothing: keeps the driver's log
    lines out of timed frames."""


def time_frames(scene, reps, chunk, depth_cap):
    """(seconds per frame, rays/s) over `reps` frames after a warm-up."""
    import torch

    from misaki_tpu_torch.render.driver import render

    def sync():
        if scene.device.type == "cuda":
            torch.cuda.synchronize()

    render(scene, seed=0, chunk_size=chunk, depth_cap=depth_cap, progress=quiet)
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        render(scene, seed=i + 1, chunk_size=chunk, depth_cap=depth_cap, progress=quiet)
    sync()
    dt = (time.perf_counter() - t0) / reps
    n_samples = scene.film_width * scene.film_height * scene.spp
    return dt, n_samples * rays_per_sample(scene, depth_cap) / dt


def cuda_cpu_parity(scene_cpu, seed=7, depth_cap=4):
    """The same small render on the card and on the CPU, compared on the RGB
    and on every AOV: {name: {"mean_rel", "l1_rel"}, "ok"}. mean_rel is the
    difference of the image means relative to the mean (a signed AOV's to
    its mean magnitude), l1_rel the mean absolute difference relative to the
    mean magnitude; ok when every image has mean_rel < 0.5% and l1_rel < 2%."""
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
    ok = all(r["mean_rel"] < 5e-3 and r["l1_rel"] < 2e-2 for r in res.values())
    return {**res, "ok": ok}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--depth", type=int, default=4, help="bounce iterations")
    p.add_argument("--chunk-log2", type=int, default=20)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    p.add_argument("--no-extra", action="store_true", help="the headline only")
    args = p.parse_args(argv)

    import torch

    from misaki_tpu_torch.scene.compiler import load_and_compile

    device = torch.device(args.device)
    chunk = 1 << args.chunk_log2
    cbox_xml = SCENES / "cbox" / "scene.xml"
    # the XML declares max_depth -1: capped so that n_bounce_iters == depth;
    # on cuda without a card this raises
    scene = load_and_compile(str(cbox_xml), spp=args.spp, width=args.width, height=args.height,
                             device=device).replace(max_depth=args.depth + 1)
    dev_line = device_line(device)
    dt, rate = time_frames(scene, args.reps, chunk, args.depth)
    print(json.dumps({"metric": "cbox_4bounce_rays_per_s", "value": rate, "unit": "rays/s",
                      "frame_s": dt, "device": dev_line}), flush=True)
    if args.no_extra:
        return 0

    extra = {}
    for name, xml, reps, depth, kw in EXTRAS:
        sc = load_and_compile(str(SCENES / xml), device=device, **kw)
        extra[name] = time_frames(sc, reps, chunk, depth)[1]
    parity = (cuda_cpu_parity(load_and_compile(str(cbox_xml), spp=16, width=64, height=48,
                                               device="cpu"))
              if device.type == "cuda" else "skipped")
    print(json.dumps({"extra": extra, "cuda_cpu_parity": parity, "device": dev_line}),
          flush=True)
    return 0 if parity == "skipped" or parity["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
