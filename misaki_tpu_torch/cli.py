"""Command-line renderer:

    python -m misaki_tpu_torch.cli scene.xml -o out.png --spp 64 --device cuda

Loads a Mitsuba-style scene, renders it on the chosen device and writes a
PNG. `--device cuda` needs a GPU and fails without one.
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="misaki_tpu_torch renderer")
    p.add_argument("scene", help="Mitsuba-style scene XML")
    p.add_argument("-o", "--output", required=True, help="output PNG path")
    p.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--depth", type=int, default=16, help="bounce cap for max_depth=-1")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    if not args.output.lower().endswith(".png"):
        p.error("only PNG output is supported")

    import torch

    from misaki_tpu_torch.render import film as film_mod
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    scene = load_and_compile(args.scene, spp=args.spp, width=args.width,
                             height=args.height).to(device)
    print(f"compiled {scene.n_faces} faces, {scene.n_emitters} emitters "
          f"in {time.perf_counter() - t0:.2f} s", file=sys.stderr)

    t0 = time.perf_counter()
    out = render(scene, depth_cap=args.depth)
    rgb = out["rgb"].cpu()
    print(f"rendered {scene.film_width}x{scene.film_height} at {scene.spp} spp on "
          f"{device} in {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    film_mod.write_png(args.output, rgb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
