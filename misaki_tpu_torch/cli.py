"""Command-line renderer (the reference's misaki-cli, src/apps/main.cpp):

    python -m misaki_tpu_torch.cli scene.xml -o out.exr --spp 64 --device cuda

Loads a Mitsuba-style scene, renders it on the chosen device and writes an
EXR or a PNG, by the output's extension (default: the scene's name, .exr for
an hdrfilm and .png for an rgbfilm). The `aov` integrator also writes one
`<stem>_<name>.exr` per variable. `--device cuda` (the default) needs a GPU
and fails without one; `--device cpu` renders on the CPU.
"""

import argparse
import sys
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description="misaki_tpu_torch renderer")
    p.add_argument("scene", help="Mitsuba-style scene XML")
    p.add_argument("-o", "--output", default=None, help="output image path (.exr or .png)")
    p.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--depth", type=int, default=16, help="bounce cap for max_depth=-1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chunk-log2", type=int, default=20, help="log2 of the lane chunk size")
    p.add_argument("-D", "--define", action="append", default=[], metavar="KEY=VAL",
                   help="scene $parameter substitution")
    p.add_argument("-I", "--include-dir", action="append", default=[], metavar="DIR",
                   help="extra file-resolver search path (meshes, textures, includes)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="film snapshot, written during the render and resumed from "
                        "when present; the finished image is the same to the bit")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="N",
                   help="snapshot every N lane chunks (default 8)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from misaki_tpu_torch.render import film as film_mod
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile
    from misaki_tpu_torch.utils.fresolver import get_file_resolver
    from misaki_tpu_torch.utils.logging import Timer, get_logger

    log = get_logger()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2
    params = dict(kv.split("=", 1) for kv in args.define)
    for d in args.include_dir:
        get_file_resolver().append(d)

    t = Timer()
    scene = load_and_compile(args.scene, params, spp=args.spp, width=args.width,
                             height=args.height, device=device)
    log.info("Compiled scene: %d faces, %d shapes, %d emitters (%s integrator) in %s",
             scene.n_faces, scene.n_shapes, scene.n_emitters, scene.integrator, t)

    t.reset()
    log.info("Starting render job (%dx%d, %d samples) on %s", scene.film_width,
             scene.film_height, scene.spp, device)
    out = render(scene, seed=args.seed, chunk_size=1 << args.chunk_log2, depth_cap=args.depth,
                 checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every)
    rgb, alpha = out["rgb"].cpu(), out["alpha"].cpu()
    log.info("Rendering finished. (took %s)", t)

    dest = args.output
    if dest is None:
        dest = str(Path(args.scene).with_suffix(
            ".exr" if scene.film_format == "hdrfilm" else ".png"))
    log.info("Developing %s ..", dest)
    if dest.lower().endswith(".png"):
        film_mod.write_png(dest, rgb)
    else:
        film_mod.write_exr(dest, rgb, alpha)
    # the aov integrator: one EXR per variable next to the main image (the
    # reference packs them as extra film channels, aov.cpp:61-85)
    for name, img in out.get("aovs", {}).items():
        img = img.cpu().numpy()
        aov_dest = f"{Path(dest).with_suffix('')}_{name}.exr"
        log.info("Writing AOV %s -> %s", name, aov_dest)
        if img.shape[-1] == 2:   # uv, padded to three channels
            img = np.concatenate([img, np.zeros_like(img[..., :1])], -1)
        film_mod.write_exr(aov_dest, img[..., 0] if img.shape[-1] == 1 else img)
    return 0


if __name__ == "__main__":
    sys.exit(main())
