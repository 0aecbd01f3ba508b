"""Registry of differentiable scene-parameter leaves (misaki_tpu/diff/leaves.py).

Each entry maps a stable name to (getter, replacer) over a CompiledScene.
Training code asks for a subset by name, receives the tensors, and gets
back a scene with those tensors swapped in: the compiled tables are the
parameter store. A replacer stores the tensor it is given, never a copy,
so a leaf that requires grad stays in the graph of every render of the
returned scene.

Leaves:
  materials — (N_MAT_COLS, B) packed material columns: reflectance and
              specular sigmoid coefficients, microfacet alpha slots, eta
              (column MC_ETA), conductor eta / k RGB;
  rad_coeff — (E, 3) emitter radiance sigmoid coefficients;
  rad_curve — (E, 95) emitter radiance curves on the CIE grid;
  env_rgb   — (He, We, 3) environment-map texels (the bilinear fetch is
              linear in them);
  sigma_s_amp  — (M,) homogeneous-medium scattering amplitude;
  sigma_a_amp  — (M,) absorption amplitude;
  medium_scale — (M,) overall sigma scale (media/homogeneous.cpp `scale`);
  bitmaps   — (Npad, 3) texel-major table of every bitmap's mip chain
              (misaki_tpu's (3, Npad) atlas transposed; no pages);
  volumes   — (Npad,) grid-volume density table (misaki_tpu's (1, Npad)
              row flattened; the trilinear taps are linear in it).
"""

from dataclasses import replace as dc_replace


def _rep_materials(scene, v):
    return scene.replace(materials=dc_replace(scene.materials, params=v))


def _rep_emitter(field):
    def rep(scene, v):
        return scene.replace(emitters=dc_replace(scene.emitters, **{field: v}))

    return rep


def _rep_media(field):
    def rep(scene, v):
        return scene.replace(media=dc_replace(scene.media, **{field: v}))

    return rep


DIFF_LEAVES = {
    "materials": (lambda s: s.materials.params, _rep_materials),
    "rad_coeff": (lambda s: s.emitters.rad_coeff, _rep_emitter("rad_coeff")),
    "rad_curve": (lambda s: s.emitters.rad_curve, _rep_emitter("rad_curve")),
    "env_rgb": (lambda s: s.emitters.env_rgb, _rep_emitter("env_rgb")),
    "sigma_s_amp": (lambda s: s.media.sigma_s_amp, _rep_media("sigma_s_amp")),
    "sigma_a_amp": (lambda s: s.media.sigma_a_amp, _rep_media("sigma_a_amp")),
    "medium_scale": (lambda s: s.media.scale, _rep_media("scale")),
    "bitmaps": (lambda s: s.bitmaps, lambda s, v: s.replace(bitmaps=v)),
    "volumes": (lambda s: s.volumes, lambda s, v: s.replace(volumes=v)),
}


def _entry(name):
    if name not in DIFF_LEAVES:
        raise KeyError(f"unknown leaf '{name}'; leaves: {', '.join(DIFF_LEAVES)}")
    return DIFF_LEAVES[name]


def leaf_names():
    return tuple(DIFF_LEAVES)


def get_leaves(scene, names):
    """-> {name: tensor} for the requested leaf names (the scene's own
    tensors, not copies)."""
    return {n: _entry(n)[0](scene) for n in names}


def replace_leaves(scene, values):
    """Swap the given {name: tensor} leaves into a new CompiledScene."""
    for n, v in values.items():
        scene = _entry(n)[1](scene, v)
    return scene
