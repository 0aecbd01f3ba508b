"""Photon frames: a closed loop of `misaki_tpu_torch.render.ppm.render_ppm`
calls (every iteration's camera pass, photon pass and density estimates),
each with its own seed, each done when its RGB image is in host memory.

Every pixel of a photon frame depends on every photon, so the check
renders whole frames again with the plain reference
(`benchmark/reference/sppm.py`): `frames` of the window's, drawn from the
seed.
"""

import torch

from benchmark import common


def setup(cell):
    from misaki_tpu_torch.render.ppm import render_ppm

    st = {"cell": cell, "scene": common.program_scene(cell), "render": render_ppm,
          "frames": [], "seeds": []}
    step(st, -1)                        # the warm-up frame
    st["frames"].clear()
    st["seeds"].clear()
    return st


def step(st, i):
    seed = common.frame_seed(st["cell"].seed, i)
    out = st["render"](st["scene"], seed=seed, depth_cap=int(st["cell"].traffic["depth_cap"]))
    st["frames"].append(out["rgb"].cpu())
    st["seeds"].append(seed)


def sample(cell, n_frames):
    """The indices of the frames the check compares."""
    want = int(cell.config["reference_sample"]["sppm_frames"]["frames"])
    return torch.randperm(n_frames, generator=common.sample_rng(cell))[:want].tolist()


def reference(cell, seeds):
    """The reference's frame of each seed, (H, W, 3) on the host."""
    from benchmark.reference import sppm

    scene = common.reference_scene(cell)
    return [sppm.render(scene, s, int(cell.traffic["depth_cap"])).cpu() for s in seeds]


def numbers(program, ref):
    """rgb_rel_l1 of `common.image_numbers` alone: one camera sample that
    the two sides' casts send to different sides of the light's edge moves
    its pixel by the light's radiance over the iterations, several times
    the frame's mean, so the widest pixel gap cannot tell such a sample from
    a fault (PERF.md section 2)."""
    return {"rgb_rel_l1": common.image_numbers(zip(program, ref))["rgb_rel_l1"]}


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
