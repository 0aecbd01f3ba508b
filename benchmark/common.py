"""What the job kinds share: seeds, the scenes of both sides, and the image
comparison."""

import torch

_M64 = (1 << 64) - 1


def frame_seed(seed, i):
    """The 32-bit render seed of job i of a run with `seed` (splitmix64 of
    the pair), for any whole `seed` and any i >= -1."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 2) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def sample_rng(cell):
    """A host generator, from the seed, that draws the sample the check
    compares."""
    return torch.Generator().manual_seed(frame_seed(cell.seed, -2))


def scene_kwargs(cell):
    """The compile overrides of the configuration (as the scene XMLs are
    written, photons and iterations come from the sppm XML itself)."""
    c = cell.config
    kw = {"width": int(c["width"]), "height": int(c["height"]), "device": cell.device}
    if cell.traffic["integrator"] == "path":
        kw.update(spp=int(c["spp"]), max_depth=int(c["max_depth"]))
    return kw


def program_scene(cell):
    """The configuration's scene, compiled by the program."""
    from misaki_tpu_torch.scene.compiler import load_and_compile

    scene = load_and_compile(cell.path(cell.config["scenes"][cell.traffic["integrator"]]),
                             **scene_kwargs(cell))
    if scene.integrator == "sppm":
        if (scene.ppm_photons, scene.ppm_iterations) != (cell.config["photons"],
                                                         cell.config["iterations"]):
            raise ValueError("the sppm XML's photons or iterations differ from the config's")
    return scene


def reference_scene(cell):
    """The same scene, read by the reference from the same XML."""
    from benchmark.reference import scene

    return scene.load(cell.path(cell.config["scenes"][cell.traffic["integrator"]]),
                      **scene_kwargs(cell))


def worst(values):
    """The largest of `values`, or NaN where any is NaN (max() would drop
    it)."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values)


def image_numbers(pairs):
    """The numbers the check compares for images: over (program, reference)
    pairs of (rows, W, 3) float tensors, the worst of
      rgb_rel_l1: sum |a - b| / sum |b|, and
      rgb_max_rel: max |a - b| / mean |b| (one pixel altered shows here)."""
    l1 = mx = 0.0
    finite = True
    for a, b in pairs:
        a = a.double()
        b = b.double()
        d = (a - b).abs()
        scale = b.abs().mean()
        l1 = max(l1, float(d.sum() / b.abs().sum()))
        mx = max(mx, float(d.max() / scale))
        finite = finite and bool(torch.isfinite(d).all())
    if not finite:
        l1 = mx = float("nan")
    return {"rgb_rel_l1": l1, "rgb_max_rel": mx}
