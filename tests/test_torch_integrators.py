"""The debug, direct and aov integrators of the port against misaki_tpu's,
on the CPU: stage by stage on one cbox wavefront, and as whole images on
the scenes that stand for their workloads (misaki_tpu_torch/scenes/
bunny_debug.xml, cbox/direct.xml, envlit/aov.xml).

Stages run on the very same tables (from_compiled) and RNG states, to rtol
1e-5, atol 1e-5, with the PCG32 state after each call equal, which pins the
draw order. Whole images use the golden criteria of tests/torch_helpers.py.
The compiled tables of the three XMLs are equal to the bit, and so are the
clusters, built from the same rows at the port's 128 faces (misaki_tpu's
compiler builds 48-face clusters for debug and aov unless
MISAKI_CLUSTER_FACES says otherwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import CBOX_XML, SCENES, golden_criteria, n, t

from misaki_tpu.accel import cluster as jcluster
from misaki_tpu.accel.build import BRUTE_FORCE_THRESHOLD
from misaki_tpu.render import aov as jaov
from misaki_tpu.render import driver as jdriver
from misaki_tpu.render import integrator as jinteg
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu_torch.render import aov as paov
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.render import integrator as pinteg
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.compiler import load_and_compile as pload
from misaki_tpu_torch.scenes.envlit import assets

SEED = 5
BUNNY_DEBUG_XML = SCENES / "bunny_debug.xml"
DIRECT_XML = SCENES / "cbox" / "direct.xml"


def _close(want, got, rtol=1e-5, atol=1e-5):
    if isinstance(want, (tuple, list)):
        for w, g in zip(want, got):
            _close(w, g, rtol, atol)
        return
    if isinstance(want, dict):
        assert set(want) == set(got)
        for k in want:
            _close(want[k], got[k], rtol, atol)
        return
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


def _state_equal(jstate, pstate):
    for k in ("hi", "lo", "inc_hi", "inc_lo"):
        np.testing.assert_array_equal(n(pstate[k]), np.asarray(jstate[k]).astype(np.int64))


@pytest.fixture(scope="module")
def wavefront():
    """A 32x24, 4 spp cbox wavefront's camera rays in both packages, on the
    same tables, with 2 emitter and 3 BSDF samples for `direct`."""
    js = jload(str(CBOX_XML), spp=4, width=32, height=24).replace(
        direct_light_samples=2, direct_bsdf_samples=3)
    ps = from_compiled(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert (ps.direct_light_samples, ps.direct_bsdf_samples) == (2, 3)
    lane = np.arange(32 * 24 * 4, dtype=np.uint32)
    jray, _, jstate = jdriver.primary_rays(js, jnp.asarray(lane), SEED)
    pray, _, pstate = pdriver.primary_rays(ps, t(lane.astype(np.int64)), SEED)
    return js, ps, (jray, jstate), (pray, pstate)


@pytest.mark.parametrize("fn", ["sample_debug", "sample_aovs", "sample_direct"])
def test_stage_parity(wavefront, fn):
    js, ps, (jray, jstate), (pray, pstate) = wavefront
    want, jstate2 = getattr(jinteg, fn)(js, jray, jstate)
    got, pstate2 = getattr(pinteg, fn)(ps, pray, pstate)
    _close(want, got)
    _state_equal(jstate2, pstate2)
    if fn == "sample_direct":
        # 2 emitter samples (2D each), then 3 BSDF samples (1D + 2D each)
        lit = n(got).sum(axis=0) > 0
        assert lit.mean() > 0.5
    if fn == "sample_aovs":
        assert set(got) == set(pinteg.AOV_NAMES) == set(jinteg.AOV_NAMES)


def _count_off(got, want):
    """Texels off by more than 1e-3 of the image maximum."""
    scale = max(float(np.abs(want).max()), 1e-3)
    return int((np.abs(np.asarray(got) - np.asarray(want)) / scale > 1e-3).sum())


def _golden(got, want, label):
    frac_off, mean_err = golden_criteria(got, want)
    print(f"{label}: {_count_off(got, want)} texels off, share {frac_off:.5f}, "
          f"mean error {mean_err:.3e}")
    assert frac_off < 0.02, (label, frac_off)
    assert mean_err < 1e-3, (label, mean_err)


def test_debug_image_matches_misaki_tpu(capsys):
    kw = dict(spp=1, width=64, height=64)
    want = np.asarray(jdriver.render(jload(str(BUNNY_DEBUG_XML), **kw), seed=3)["rgb"])
    got = n(pdriver.render(pload(str(BUNNY_DEBUG_XML), device="cpu", **kw), seed=3)["rgb"])
    assert got.shape == want.shape == (64, 64, 3)
    # |n| per channel: in [0, 1]; the background (a miss) is 0
    assert 0.05 < float((got > 0).any(axis=-1).mean()) < 0.95
    with capsys.disabled():
        _golden(got, want, "\ndebug bunny")


def test_direct_image_matches_misaki_tpu(capsys):
    kw = dict(spp=8, width=64, height=48)
    js = jload(str(DIRECT_XML), **kw)
    ps = pload(str(DIRECT_XML), device="cpu", **kw)
    assert (ps.integrator, ps.direct_light_samples, ps.direct_bsdf_samples) == ("direct", 2, 2)
    want = np.asarray(jdriver.render(js, seed=7)["rgb"])
    got = n(pdriver.render(ps, seed=7)["rgb"])
    assert np.isfinite(got).all() and got.mean() > 0.02
    with capsys.disabled():
        _golden(got, want, "\ndirect cbox")


@pytest.fixture(scope="module")
def envlit_aov(tmp_path_factory):
    d = tmp_path_factory.mktemp("envlit_aov")
    assets.write_assets(d, sky_shape=(64, 128), floor_res=64)
    return d / "aov.xml"


def test_aov_images_match_misaki_tpu(envlit_aov, monkeypatch, capsys):
    """Every AOV and the nested path's RGB of envlit/aov.xml. The AOVs that
    depend on which face was hit (position, normals, uv) may differ where
    an exact tie resolves to another face (the port takes the largest face
    id); the count of such texels is printed, and the golden criteria bound
    it."""
    kw = dict(spp=2, width=48, height=48)
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")
    js = jload(str(envlit_aov), **kw)
    ps = pload(str(envlit_aov), device="cpu", **kw)
    assert ps.aov_nested == js.aov_nested == "path" and ps.max_depth == 5
    want = jdriver.render(js, seed=7)
    got = pdriver.render(ps, seed=7)
    assert got["film"] is None and set(got["aovs"]) == set(want["aovs"])
    with capsys.disabled():
        print()
        for name in want["aovs"]:
            w, g = np.asarray(want["aovs"][name]), n(got["aovs"][name])
            assert g.shape == w.shape == (48, 48, paov.AOV_KINDS[name])
            _golden(g, w, f"aov {name}")
        _golden(n(got["rgb"]), np.asarray(want["rgb"]), "aov rgb")
        _golden(n(got["alpha"]), np.asarray(want["alpha"]), "aov alpha")
    depth = n(got["aovs"]["depth"])[..., 0]
    assert (depth > 0).mean() > 0.3 and (depth == 0).mean() > 0.05   # floor, bunny and sky


@pytest.mark.parametrize("name", ["bunny_debug", "direct", "aov"])
def test_tables_equal_misaki_tpu(name, envlit_aov, monkeypatch):
    """The three XMLs compile to the same tables, settings and clusters."""
    path = {"bunny_debug": BUNNY_DEBUG_XML, "direct": DIRECT_XML, "aov": envlit_aov}[name]
    kw = dict(spp=2, width=16, height=16)
    monkeypatch.setenv("MISAKI_CLUSTER_FACES", "128")
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")
    js = jax.tree_util.tree_map(np.asarray, jload(str(path), **kw))
    ps = pload(str(path), device="cpu", **kw)
    for group, field in (("geometry", "p0"), ("geometry", "e1"), ("geometry", "e2"),
                         ("geometry", "face_tab"), ("materials", "params"),
                         ("emitters", "kind"), ("emitters", "face_pack"),
                         ("emitters", "rad_coeff"), ("emitters", "env_rgb"),
                         ("camera", "sample_to_camera")):
        np.testing.assert_array_equal(n(getattr(getattr(ps, group), field)),
                                      np.asarray(getattr(getattr(js, group), field)),
                                      err_msg=field)
    for field in ("integrator", "aovs", "aov_nested", "direct_light_samples",
                  "direct_bsdf_samples", "max_depth", "film_width", "film_height", "spp",
                  "n_faces", "emitter_kinds", "bsdf_kinds"):
        assert getattr(ps, field) == getattr(js, field), field
    if ps.n_faces > BRUTE_FORCE_THRESHOLD:   # misaki_tpu's clusters start there
        # misaki_tpu builds its clusters from the float64 vertex rows and the
        # port from the float32 geometry tables (scene/compiler.py), so the
        # bounds round differently and a face near a split may change
        # cluster: the port's clusters are misaki_tpu's build_clusters on the
        # port's rows at 128 faces, to the bit, and as many as the JAX
        # scene's
        rows = [np.asarray(getattr(js.geometry, f))[:, :js.n_faces].T for f in ("p0", "e1", "e2")]
        want = jcluster.build_clusters(*rows, target=128,
                                       face_tab=np.asarray(js.geometry.face_tab)[:, :js.n_faces])
        assert ps.cluster.n_clusters == want.n_clusters == js.cluster.n_clusters
        for field in ("bounds", "tri", "tab"):
            np.testing.assert_array_equal(n(getattr(ps.cluster, field)),
                                          np.asarray(getattr(want, field)))


def test_aov_spec_and_unported_integrators(envlit_aov):
    assert paov.parse_aov_spec(("d:depth", " uv ")) == [("d", "depth"), ("uv", "uv")]
    assert paov.parse_aov_spec(()) == jaov.parse_aov_spec(()) == [(k, k) for k in paov.AOV_KINDS]
    with pytest.raises(ValueError, match="unknown type 'albedo'"):
        paov.parse_aov_spec(("a:albedo",))
    ps = pload(str(envlit_aov), device="cpu", spp=1, width=8, height=8)
    # a nested volpath, which raised before the port carried media, renders
    out = pdriver.render(ps.replace(aov_nested="volpath"), depth_cap=2)
    assert np.isfinite(n(out["rgb"])).all() and float(out["rgb"].mean()) > 0.0
    assert set(out["aovs"]) == {k for k, _ in paov.parse_aov_spec(ps.aovs)}
    # sppm and photonmapper, which raised before the port carried them,
    # render the scene's image and alpha (no AOVs: they are not `aov`); the
    # test's name dates from when they raised
    for integrator in ("sppm", "photonmapper"):
        out = pdriver.render(ps.replace(integrator=integrator, ppm_photons=2048,
                                        ppm_iterations=1))
        assert set(out) == {"film", "rgb", "alpha"} and out["rgb"].shape == (8, 8, 3)
        assert np.isfinite(n(out["rgb"])).all() and float(out["rgb"].mean()) > 0.0
