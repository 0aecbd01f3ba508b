"""Photonmapper frames: a closed loop of `misaki_tpu_torch.render.ppm.render_ppm`
calls on the configuration's photonmapper scene (`photonmapper.xml` beside
its sppm scene: the same box under Mitsuba's `photonmapper` integrator),
each with its own seed, each done when its RGB image is in host memory.

`sppm_frames`' step, sample and numbers, checked against the photonmapper
reference (`benchmark/reference/photonmapper.py`): whole frames, compared
by `rgb_rel_l1` alone, as photon frames are.
"""

from pathlib import Path

import torch

from benchmark import common, harness

sppm_frames = harness.load_module(Path(__file__).with_name("sppm_frames.py"),
                                  "benchmark_job_sppm_frames")
step = sppm_frames.step
sample = sppm_frames.sample
numbers = sppm_frames.numbers


def scene_path(cell):
    """The photonmapper XML of the configuration, beside its sppm one."""
    return cell.path(Path(cell.config["scenes"]["sppm"]).with_name("photonmapper.xml"))


def setup(cell):
    from misaki_tpu_torch.render.ppm import render_ppm
    from misaki_tpu_torch.scene.compiler import load_and_compile

    scene = load_and_compile(scene_path(cell), **common.scene_kwargs(cell))
    if scene.integrator != "photonmapper" or (scene.ppm_photons, scene.ppm_iterations) != (
            cell.config["photons"], cell.config["iterations"]):
        raise ValueError("the photonmapper XML's integrator, photons or iterations differ "
                         "from the config's")
    st = {"cell": cell, "scene": scene, "render": render_ppm, "frames": [], "seeds": []}
    step(st, -1)                        # the warm-up frame
    st["frames"].clear()
    st["seeds"].clear()
    return st


def reference(cell, seeds):
    """The reference's frame of each seed, (H, W, 3) on the host."""
    from benchmark.reference import photonmapper

    c = cell.config
    scene = photonmapper.load(scene_path(cell), width=int(c["width"]), height=int(c["height"]),
                              device=cell.device)
    return [photonmapper.render(scene, s, int(cell.traffic["depth_cap"])).cpu() for s in seeds]


def check(st, cell, run):
    picks = sample(cell, len(st["frames"]))
    program = [st["frames"][i] for i in picks]
    seeds = [st["seeds"][i] for i in picks]
    st.clear()
    if cell.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return numbers(program, reference(cell, seeds))


def control(cell, n_frames=100):
    """The check's numbers with the reference in TF32 in the program's place."""
    from benchmark.reference import precision

    seeds = [common.frame_seed(cell.seed, i) for i in sample(cell, n_frames)]
    with precision.tf32():
        low = reference(cell, seeds)
    return numbers(low, reference(cell, seeds))
