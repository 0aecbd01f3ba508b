"""AOV integrator (reference: integrators/aov.cpp:29-144): arbitrary output
variables of the primary intersection, one (H, W, C) image each, beside the
nested radiance integrator's RGB.

`parse_aov_spec` maps the scene's comma-separated "name:type" list to the
supported kinds (aov.cpp:31-60). The driver's chunk loop splats
`chunk_columns` (the AOV channels, then the nested integrator's XYZ) with
alpha and the filter weight into one film, checkpoints and all; `develop`
divides the finished film by the weight and splits it."""

import torch

from misaki_tpu_torch.core import spectrum as spec
from misaki_tpu_torch.render import integrator as integ

# kind -> channel count (aov.cpp Type enum: Depth / Position / UV /
# GeometricNormal / ShadingNormal)
AOV_KINDS = {"depth": 1, "position": 3, "uv": 2, "geo_normal": 3, "sh_normal": 3}


def parse_aov_spec(aovs):
    """("name:type", ...) -> [(out_name, kind), ...]. An unknown kind raises,
    as the reference throws on an invalid AOV type (aov.cpp:50-58); a bare
    "type" names the output after the kind; an empty spec gives every
    kind."""
    out = []
    for entry in aovs:
        entry = entry.strip()
        if not entry:
            continue
        if ":" in entry:
            name, kind = (s.strip() for s in entry.split(":", 1))
        else:
            name = kind = entry
        if kind not in AOV_KINDS:
            raise ValueError(f"aov: unknown type '{kind}' (supported: {sorted(AOV_KINDS)})")
        out.append((name, kind))
    return out or [(k, k) for k in AOV_KINDS]


def n_channels(scene):
    """Film channels of an aov render: the AOVs, XYZ, alpha and weight."""
    return sum(AOV_KINDS[k] for _, k in parse_aov_spec(scene.aovs)) + 5


def chunk_columns(scene, ray, state, depth_cap):
    """-> (the AOV columns of the chunk's lanes in spec order, then the
    nested integrator's XYZ (`scene.aov_nested`: path or direct; volpath
    raises NotImplementedError), state)."""
    aovs, state = integ.sample_aovs(scene, ray, state)
    cols = ()
    for _, kind in parse_aov_spec(scene.aovs):
        a = aovs[kind]
        cols += a if isinstance(a, tuple) else (a,)
    L_spec, state = integ.radiance(scene, ray, state, scene.aov_nested, depth_cap)
    return cols + spec.spectrum_to_xyz(L_spec * ray["wav_weight"], ray["wavelengths"]), state


def develop(scene, film):
    """The finished (H, W, C) film divided by its weight channel ->
    {"rgb": (H, W, 3), "alpha": (H, W), "aovs": {name: (H, W, C)}}."""
    inv_w = torch.where(film[..., -1:] != 0.0, 1.0 / film[..., -1:], 0.0)
    out = {"aovs": {}}
    offset = 0
    for name, kind in parse_aov_spec(scene.aovs):
        w = AOV_KINDS[kind]
        out["aovs"][name] = film[..., offset: offset + w] * inv_w
        offset += w
    out["rgb"] = spec.xyz_to_srgb_image(film[..., offset: offset + 3] * inv_w)
    out["alpha"] = film[..., offset + 3] * inv_w[..., 0]
    return out
