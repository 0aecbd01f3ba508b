"""Sharded path frames: a closed loop of frames of
`misaki_tpu_torch.parallel.sharding.ShardedRenderer`, a standing group of
the configuration's ranks (one a card over NCCL; gloo processes on the
CPU), frame i rendered with its own seed and done when rank 0's developed
RGB image is in host memory.

The set-up starts the group (the ranks' processes, their scene and their
process group count as set-up) and renders a warm-up frame. The check
closes the group, then compares as `path_frames` does, by its own
functions: the frames and rows drawn from the seed, rendered again by the
plain reference, whose frame is the one-process frame.
"""

from dataclasses import replace

from benchmark import common
from benchmark.jobs import path_frames


def setup(cell):
    from misaki_tpu_torch.parallel.sharding import ShardedRenderer

    group = ShardedRenderer(common.program_scene(cell), int(cell.config["layout"]["ranks"]),
                            device=cell.device)
    st = {"cell": cell, "group": group, "frames": [], "seeds": []}
    step(st, -1)                        # the warm-up frame
    st["frames"].clear()
    st["seeds"].clear()
    return st


def step(st, i):
    seed = common.frame_seed(st["cell"].seed, i)
    out = st["group"].render(seed=seed, **path_frames._render_kw(st["cell"]))
    st["frames"].append(out["rgb"].cpu())
    st["seeds"].append(seed)


def _as_path_frames(cell):
    """The cell with its reference sample where `path_frames` reads it."""
    want = cell.config["reference_sample"]["sharded_path_frames"]
    return replace(cell, config={**cell.config, "reference_sample": {"path_frames": want}})


def check(st, cell, run):
    st["group"].close()
    return path_frames.check(st, _as_path_frames(cell), run)


def control(cell, n_frames=100):
    """The check's numbers with the reference in TF32 in the program's place."""
    return path_frames.control(_as_path_frames(cell), n_frames)
