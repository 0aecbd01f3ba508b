"""Path frames: a closed loop of `misaki_tpu_torch.render.driver.render`
calls at the configuration's size, each with its own seed, each done when
its developed RGB image is in host memory.

The check renders a sample of the window's frames again with the plain
reference (`benchmark/reference/path.py`): `frames` frames drawn from the
seed, and of each a band of `rows` rows drawn from the seed (the whole frame
where `rows` is the height). The reference renders the band's lanes and the
filter's reach of rows around it, so the band's pixels receive every sample
that the frame gave them.
"""

import torch

from benchmark import common


def _quiet(done, total):
    """A progress callback that reports nothing."""


def _render_kw(cell):
    return {"chunk_size": 1 << int(cell.traffic["chunk_log2"]),
            "depth_cap": int(cell.traffic["depth_cap"])}


def setup(cell):
    from misaki_tpu_torch.render.driver import render

    st = {"cell": cell, "scene": common.program_scene(cell), "render": render,
          "frames": [], "seeds": []}
    step(st, -1)                        # the warm-up frame
    st["frames"].clear()
    st["seeds"].clear()
    return st


def step(st, i):
    seed = common.frame_seed(st["cell"].seed, i)
    out = st["render"](st["scene"], seed=seed, progress=_quiet, **_render_kw(st["cell"]))
    st["frames"].append(out["rgb"].cpu())
    st["seeds"].append(seed)


def sample(cell, n_frames):
    """[(frame index, y0, y1)]: the frames and rows the check compares."""
    g = common.sample_rng(cell)
    want = cell.config["reference_sample"]["path_frames"]
    H = int(cell.config["height"])
    rows = min(int(want["rows"]), H)
    picks = torch.randperm(n_frames, generator=g)[:int(want["frames"])].tolist()
    out = []
    for i in picks:
        y0 = int(torch.randint(0, H - rows + 1, (1,), generator=g))
        out.append((i, y0, y0 + rows))
    return out


def reference(cell, bands):
    """The reference's rows [y0, y1) of each (seed, y0, y1) frame, (rows, W,
    3) on the host."""
    from benchmark.reference import path

    scene = common.reference_scene(cell)
    return [path.render_rows(scene, seed, y0, y1).cpu() for seed, y0, y1 in bands]


def check(st, cell, run):
    picks = sample(cell, len(st["frames"]))
    program = [st["frames"][i][y0:y1] for i, y0, y1 in picks]
    bands = [(st["seeds"][i], y0, y1) for i, y0, y1 in picks]
    st.clear()
    if cell.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return common.image_numbers(zip(program, reference(cell, bands)))


def control(cell, n_frames=100):
    """The check's numbers with the reference in TF32 in the program's place."""
    from benchmark.reference import precision

    bands = [(common.frame_seed(cell.seed, i), y0, y1) for i, y0, y1 in sample(cell, n_frames)]
    with precision.tf32():
        low = reference(cell, bands)
    return common.image_numbers(zip(low, reference(cell, bands)))
