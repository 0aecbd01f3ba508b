"""The material gallery (every BSDF kind but null, a bitmap roughness, a
point light) and the compiled tables of the gallery and both test balls,
the port against misaki_tpu on the CPU.

The tables are numpy on the host in both packages and must be equal to the
bit, but for one column explained in the test. The gallery render runs on
the same XML, seed and depth in both packages, misaki_tpu with
MISAKI_FORCE_PAGED=1 as its own tests run it (its texel fetch through the
paged path's plain reference), and is held to the golden criteria of
tests/test_torch_path.py. The image is small (48x32, 2 spp): the port's CPU
casts are its plain tile walk, which scans every one of the gallery's 361
clusters on a tile of incoherent bounce rays.
"""

import jax
import numpy as np
import pytest

from torch_helpers import SCENES, golden_criteria, n

from misaki_tpu.render import driver as jdriver
from misaki_tpu.scene import compiler as jcomp
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.scene import compiler as pcomp
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
    EM_CONSTANT,
    EM_POINT,
    MASK_FLAG,
    MC_ALPHA_U,
    MC_ALPHA_V,
    MC_SSW,
)
from misaki_tpu_torch.scenes.materials import assets

TESTBALLS = {name: SCENES / "testball" / f"{name}.xml"
             for name in ("roughconductor", "roughdielectric")}
RENDER = dict(spp=2, width=48, height=32)   # the gallery render's size


@pytest.fixture(scope="module")
def gallery_xml(tmp_path_factory):
    return assets.write_assets(tmp_path_factory.mktemp("materials"), res=32)


def _compile_both(path, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISAKI_FORCE_PAGED", "1")
        js = jcomp.load_and_compile(str(path), **kw)
    return jax.tree_util.tree_map(np.asarray, js), js, pcomp.load_and_compile(
        str(path), device="cpu", **kw)


@pytest.mark.parametrize("name", ["gallery", "roughconductor", "roughdielectric"])
def test_tables_equal_misaki_tpu(name, gallery_xml):
    """Material rows, kinds with the mask flag, bitmap slots, bitmaps,
    emitter kinds, positions and radiance models: equal to the bit."""
    path = gallery_xml if name == "gallery" else TESTBALLS[name]
    ja, _, ps = _compile_both(path, spp=1, width=8, height=8)
    got, want = n(ps.materials.params), ja.materials.params
    # one known difference: roughplastic's specular sampling weight reads
    # srgb_model_mean, whose 16 float32 wavelengths torch.linspace and
    # jnp.linspace round differently at 4 points; the weight agrees to an ulp
    rest = np.arange(len(want)) != MC_SSW
    np.testing.assert_array_equal(got[rest], want[rest])
    np.testing.assert_allclose(got[MC_SSW], want[MC_SSW], rtol=2.5e-7, atol=0)
    assert ps.bsdf_kinds == tuple(ja.bsdf_kinds)
    assert ps.bitmap_slots == tuple(ja.bitmap_slots)
    assert ps.emitter_kinds == tuple(ja.emitter_kinds)
    assert ps.environment_idx == ja.environment_idx
    for k in ("position", "rad_coeff", "rad_curve", "kind"):
        np.testing.assert_array_equal(n(getattr(ps.emitters, k)), getattr(ja.emitters, k))
    np.testing.assert_array_equal(n(ps.bitmaps), np.asarray(ja.bitmaps, np.float32).T)
    if name == "gallery":
        # every kind but null, the mask flag, the bitmap alpha, a point light
        assert ps.bsdf_kinds == tuple(sorted((
            BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_DIELECTRIC,
            BSDF_CONDUCTOR, BSDF_PLASTIC, BSDF_DISNEY, MASK_FLAG)))
        assert ps.bitmap_slots == (MC_ALPHA_U, MC_ALPHA_V)
        assert ps.emitter_kinds == (EM_CONSTANT, EM_POINT)
    else:
        assert len(ps.bsdf_kinds) == 2 and ps.emitter_kinds == (EM_CONSTANT,)


def test_from_compiled_carries_the_gallery(gallery_xml):
    """misaki_tpu's compiled gallery carried across by from_compiled: the
    same material rows, kinds with the mask flag, bitmap slots and point
    light, so both packages shade from identical tables."""
    ja, _, _ = _compile_both(gallery_xml, spp=1, width=8, height=8)
    ps = from_compiled(ja, device="cpu")
    np.testing.assert_array_equal(n(ps.materials.params), ja.materials.params)
    assert ps.bsdf_kinds == tuple(ja.bsdf_kinds) and MASK_FLAG in ps.bsdf_kinds
    assert ps.bitmap_slots == tuple(ja.bitmap_slots) == (MC_ALPHA_U, MC_ALPHA_V)
    assert ps.emitter_kinds == (EM_CONSTANT, EM_POINT)
    np.testing.assert_array_equal(n(ps.emitters.position), ja.emitters.position)
    np.testing.assert_array_equal(n(ps.bitmaps), np.asarray(ja.bitmaps, np.float32).T)


def test_gallery_render_matches_misaki_tpu(gallery_xml):
    """The whole slice on the gallery: compile and render, max_depth 5."""
    _, js, ps = _compile_both(gallery_xml, **RENDER)
    assert ps.max_depth == 5
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISAKI_FORCE_PAGED", "1")
        want = np.asarray(jdriver.render(js, seed=7)["rgb"])
    got = n(pdriver.render(ps, seed=7)["rgb"])
    assert got.shape == want.shape == (RENDER["height"], RENDER["width"], 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.mean() > 0.05
    frac_off, mean_err = golden_criteria(got, want)
    assert frac_off < 0.02, frac_off
    assert mean_err < 1e-3, mean_err
