"""Sharded frames of the Cornell box over 1, 2 and 4 processes (the
counterpart of the JAX package's tools/bench_scaling.py): seconds per frame
of `parallel/sharding.py` `render_sharded`, rays/s, the frame time over the
one-process frame's, and the seconds until the processes' group was up.

    python -m misaki_tpu_torch.tools.bench_scaling [--device cuda] [--markdown]

Processes that share one card (joined over gloo: where there are fewer
cards than processes) measure the cost of the program's structure (the
lane split, the film's all-reduce, the processes themselves), not scaling:
the card does the same work whichever process sends it. Only with a card a
process (nccl) is the curve one of scaling. Prints one JSON line a process
count, or with --markdown a table, to stdout; writes no file.
"""

import argparse
import json
from pathlib import Path

CBOX_XML = Path(__file__).resolve().parents[1] / "scenes" / "cbox" / "scene.xml"
# the bench spec (256x256 x 64 spp, depth cap 4), the process counts, and
# the timed frames a count (after a warm-up frame)
WIDTH, HEIGHT, SPP, DEPTH = 256, 256, 64, 4
COUNTS = (1, 2, 4)
REPS = 3


def _frames(device, scene):
    """One rank: a warm-up frame, then REPS timed frames of varied seeds
    -> seconds per frame."""
    import torch.distributed as dist

    from misaki_tpu_torch.parallel.sharding import make_mesh, render_sharded
    from misaki_tpu_torch.utils.logging import synced_clock

    mesh = make_mesh(dist.get_world_size(), device)
    scene = scene.to(device)
    render_sharded(mesh, scene, seed=0, depth_cap=DEPTH)
    t0 = synced_clock(device)
    for i in range(REPS):
        render_sharded(mesh, scene, seed=i + 1, depth_cap=DEPTH)
    return (synced_clock(device) - t0) / REPS


def main(argv=None):
    import torch

    from misaki_tpu_torch.parallel.sharding import run_ranks
    from misaki_tpu_torch.scene.compiler import load_and_compile, target_device
    from misaki_tpu_torch.tools.bench import device_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    device = target_device(args.device, "bench_scaling")
    scene = load_and_compile(str(CBOX_XML), spp=SPP, width=WIDTH, height=HEIGHT,
                             device="cpu").replace(max_depth=DEPTH + 1)
    rays = WIDTH * HEIGHT * SPP * (1 + 2 * DEPTH)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    rows = []
    for n in COUNTS:
        backend = "nccl" if 0 < n <= cards else "gloo"
        per_rank, start_s = run_ranks(n, _frames, scene, backend=backend, device=args.device)
        frame_s = max(per_rank)
        rows.append({"processes": n, "backend": backend,
                     "shares_a_card": device.type == "cuda" and n > cards,
                     "frame_s": frame_s, "rays_per_s": rays / frame_s,
                     "frame_s_over_one_process": frame_s / rows[0]["frame_s"] if rows else 1.0,
                     "start_s": start_s})
    dev = device_line(device)
    if args.markdown:
        print(f"cbox {WIDTH}x{HEIGHT} {SPP} spp, depth cap {DEPTH}, "
              f"{rays} rays a frame; {dev}; frames of processes that share a card measure "
              "overhead, not scaling\n")
        print("| processes | backend | shares a card | s/frame | rays/s | over 1 process "
              "| start s |\n|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['processes']} | {r['backend']} | {r['shares_a_card']} | "
                  f"{r['frame_s']:.4f} | {r['rays_per_s']:.4e} | "
                  f"{r['frame_s_over_one_process']:.3f} | {r['start_s']:.2f} |")
    else:
        for r in rows:
            print(json.dumps({**r, "device": dev}))


if __name__ == "__main__":
    main()
