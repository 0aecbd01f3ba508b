"""Path frames of a scene with `sierpinski` shapes: `path_frames`' closed
loop of `misaki_tpu_torch.render.driver.render` calls, its set-up, step and
sample, checked against the reference that generates the tetrahedra itself
and blocks its casts over faces and lanes
(`benchmark/reference/sierpinski.py`), since `reference/path.py` casts
every ray against every face in one matrix.

The set-up fails where the program compiles another face count than the
configuration's `faces` (a program without the shape drops it).
"""

from pathlib import Path

import torch

from benchmark import common, harness

path_frames = harness.load_module(Path(__file__).with_name("path_frames.py"),
                                  "benchmark_job_path_frames")
step = path_frames.step
sample = path_frames.sample


def setup(cell):
    st = path_frames.setup(cell)
    faces = st["scene"].n_faces
    if faces != int(cell.config["faces"]):
        raise ValueError(f"the program compiled {faces} faces; the configuration has "
                         f"{cell.config['faces']}")
    return st


def reference(cell, bands):
    """The reference's rows [y0, y1) of each (seed, y0, y1) frame, (rows, W,
    3) on the host."""
    from benchmark.reference import sierpinski

    scene = sierpinski.load(cell.path(cell.config["scenes"]["path"]), **common.scene_kwargs(cell))
    return [sierpinski.render_rows(scene, seed, y0, y1).cpu() for seed, y0, y1 in bands]


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
