"""Path frames of Veach's multiple-importance-sampling scene: `path_frames`'
closed loop of `misaki_tpu_torch.render.driver.render` calls, its set-up,
step and sample, checked against the reference that generates the
rectangles and icosphere lights itself, shades the rough conductors and
picks among the lights (`benchmark/reference/veach.py`), its casts blocked
over faces and lanes.

The set-up fails where the program compiles another face count than the
configuration's `faces`. The check reports the numbers of
`common.image_numbers` that the cell's limits name.
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
    from benchmark.reference import veach

    scene = veach.load(cell.path(cell.config["scenes"]["path"]), **common.scene_kwargs(cell))
    return [veach.render_rows(scene, seed, y0, y1).cpu() for seed, y0, y1 in bands]


def numbers(cell, pairs):
    """The image numbers of (program, reference) `pairs` that the cell's
    limits name."""
    got = common.image_numbers(pairs)
    return {k: got[k] for k in cell.limits}


def check(st, cell, run):
    picks = sample(cell, len(st["frames"]))
    program = [st["frames"][i][y0:y1] for i, y0, y1 in picks]
    bands = [(st["seeds"][i], y0, y1) for i, y0, y1 in picks]
    st.clear()
    if cell.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return numbers(cell, zip(program, reference(cell, bands)))


FAULTS = ("selection_pdf_1", "half_samples")


def _faulty_frames(cell, seeds, fault):
    """The program's frames of `seeds` with `fault` planted in it:
    "selection_pdf_1", next-event estimation taking the light it picked with
    probability 1 in place of 1 / n_emitters; "half_samples", 8 of each
    pixel's 16 samples (the frame compiled at half the configuration's spp)."""
    from misaki_tpu_torch.emitter import kernels as emitter
    from misaki_tpu_torch.render.driver import render
    from misaki_tpu_torch.scene.compiler import load_and_compile

    kw = common.scene_kwargs(cell)
    if fault == "half_samples":
        kw["spp"] //= 2
    scene = load_and_compile(cell.path(cell.config["scenes"]["path"]), **kw)
    real = emitter.sample_emitter_direct

    def one_light(scene, *a, **k):
        out = real(scene, *a, **k)
        n = scene.n_emitters
        return dict(out, pdf=out["pdf"] * n, spec=out["spec"] / n)

    if fault == "selection_pdf_1":
        emitter.sample_emitter_direct = one_light
    try:
        return [render(scene, seed=s, progress=path_frames._quiet,
                       **path_frames._render_kw(cell))["rgb"].cpu() for s in seeds]
    finally:
        emitter.sample_emitter_direct = real


def control(cell, n_frames=100, fault=None):
    """The check's numbers with the reference in TF32 in the program's place
    (fault None), or with the program's frames of a fault in `FAULTS`."""
    from benchmark.reference import precision

    picks = sample(cell, n_frames)
    bands = [(common.frame_seed(cell.seed, i), y0, y1) for i, y0, y1 in picks]
    if fault is not None:
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; the job plants {FAULTS}")
        frames = _faulty_frames(cell, [s for s, _, _ in bands], fault)
        low = [f[y0:y1] for f, (_, y0, y1) in zip(frames, bands)]
    else:
        with precision.tf32():
            low = reference(cell, bands)
    return numbers(cell, zip(low, reference(cell, bands)))
