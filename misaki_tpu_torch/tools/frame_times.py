"""Seconds per frame of the port's benchmark scenes on the card, one JSON
line per scene, for comparing two versions of the package on one card:

    python misaki_tpu_torch/tools/frame_times.py [--root DIR] [--tag NAME]

`--root` names the checkout whose `misaki_tpu_torch` is timed (default: the
one holding this file), so that this script times an older checkout's
package too: run it for each version in turn, older, newer, newer, older.
The scenes, at chip_smoke.py's spec (depth cap 4, 2^20-lane chunks):

  * cbox: scenes/cbox/scene.xml at 256x256 x 64 spp (the headline of
    tools/bench.py), 5 frames;
  * gallery: the material gallery (scenes/materials, its images written at
    full size under <root>/build/scenes/materials/) at 256x256 x 64 spp,
    3 frames;
  * figure2 / figure3: scenes/testball/roughconductor.xml and
    roughdielectric.xml at their declared 1280x720 x 128 spp, 2 frames each
    after a 128x72 x 4 spp warm-up.

Each is timed over frames of varied seeds after a warm-up frame, the host
clock ended by torch.cuda.synchronize(). Each line has the scene, the
seconds of each frame and their mean, `tag` and the card's name and power
limit as nvidia-smi prints them.

`--sampler` first times, in this one process, the rough dielectric sampler
of `bsdf/kernels.py` (`_sample_roughdielectric`, its formulas taken in
float64) against the same formulas in float32 (`_sample_roughdielectric_f`)
at 2^20 lanes (`sampler_cost`): a frame's difference between the two is
its calls (chunks times bounce iterations) times the per-call difference.
"""

import argparse
import json
import sys
import time
from pathlib import Path

DEPTH_CAP, CHUNK = 4, 1 << 20


def sampler_cost(reps=50, seed=0):
    """{"float32": ..., "float64": ...}: per call at CHUNK lanes, the device
    ms (`device_ms`, the launches back to back) and the host ms (the wall
    clock over `reps` calls, ended by a synchronize) of the rough dielectric
    sampler's formulas in float32 and taken in float64, on random GGX
    materials and directions."""
    import torch

    from misaki_tpu_torch.bsdf import kernels as bk
    from misaki_tpu_torch.tools.profile_cluster_frame import device_ms

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, device="cuda", generator=g)

    L = CHUNK
    wi = torch.nn.functional.normalize(r(3, L, lo=-1.0), dim=0)
    p = {"alpha_u": r(L, lo=0.05, hi=0.6), "alpha_v": r(L, lo=0.05, hi=0.6),
         "eta": r(L, lo=1.2, hi=1.8), "spec_refl": r(4, L), "spec_trans": r(4, L),
         "distr": torch.zeros(L, dtype=torch.int32, device="cuda")}
    args = (p, tuple(wi), r(L), (r(L), r(L)))
    res = {}
    for name, fn in (("float32", bk._sample_roughdielectric_f),
                     ("float64", bk._sample_roughdielectric)):
        dev_ms = device_ms(lambda: fn(*args), reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
        res[name] = {"device_ms": dev_ms, "host_ms": 1e3 * (time.perf_counter() - t0) / reps}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    p.add_argument("--tag", default="")
    p.add_argument("--sampler", action="store_true",
                   help="also time the rough dielectric sampler in float32 and float64")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.scenes.materials import assets as materials_assets
    from misaki_tpu_torch.tools.bench import device_line, quiet

    scenes = root / "misaki_tpu_torch" / "scenes"
    gallery = materials_assets.prepared(root / "build" / "scenes" / "materials")
    # (name, XML, frames, compile overrides, warm-up overrides or None)
    cases = (
        ("cbox", scenes / "cbox" / "scene.xml", 5,
         dict(spp=64, width=256, height=256), None),
        ("gallery", gallery, 3, dict(spp=64, width=256, height=256), None),
        ("figure2", scenes / "testball" / "roughconductor.xml", 2, {},
         dict(spp=4, width=128, height=72)),
        ("figure3", scenes / "testball" / "roughdielectric.xml", 2, {},
         dict(spp=4, width=128, height=72)),
    )
    dev = device_line(torch.device("cuda"))
    if args.sampler:
        print(json.dumps({"sampler": sampler_cost(), "lanes": CHUNK, "tag": args.tag,
                          "device": dev}), flush=True)
    for name, xml, frames, kw, warm_kw in cases:
        scene = load_and_compile(str(xml), **kw)
        if name == "cbox":
            # the XML declares max_depth -1; capped as tools/bench.py caps it
            scene = scene.replace(max_depth=DEPTH_CAP + 1)
        warm = scene if warm_kw is None else load_and_compile(str(xml), **warm_kw)
        render(warm, seed=0, chunk_size=CHUNK, depth_cap=DEPTH_CAP, progress=quiet)
        torch.cuda.synchronize()
        each = []
        for i in range(frames):
            t0 = time.perf_counter()
            render(scene, seed=i + 1, chunk_size=CHUNK, depth_cap=DEPTH_CAP, progress=quiet)
            torch.cuda.synchronize()
            each.append(time.perf_counter() - t0)
        print(json.dumps({"scene": name, "tag": args.tag, "frame_s": each,
                          "mean_s": sum(each) / len(each), "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
