"""The port's main path against misaki_tpu's, stage by stage on a cbox
wavefront and as a whole image; plus the physics and determinism checks of
tests/test_render_e2e.py, on the port.

Stages are compared on the very same tables (from_compiled) and the same
RNG states: primary rays exactly or to rtol 1e-6, the first-bounce
interaction, material, emitter and BSDF samples to rtol 1e-5 (float32 chains
of a few dozen operations, where the two libraries' transcendental functions
may differ in the last bit). Whole images use the golden-image criteria of
tests/test_golden_images.py: rare paths may branch differently when a
last-bit difference lands on a comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML, FURNACE_XML, golden_criteria, luminance_y, n, t

from misaki_tpu.accel import traverse as jtr
from misaki_tpu.bsdf import kernels as jbsdf
from misaki_tpu.core import rng as jrng
from misaki_tpu.emitter import kernels as jem
from misaki_tpu.render import driver as jdriver
from misaki_tpu.render import interaction as jinter
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu_torch.accel import traverse as ptr
from misaki_tpu_torch.bsdf import kernels as pbsdf
from misaki_tpu_torch.core import rng as prng
from misaki_tpu_torch.emitter import kernels as pem
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.render import interaction as pinter
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.compiler import compile_scene
from misaki_tpu_torch.scene.compiler import load_and_compile as pload
from misaki_tpu_torch.scene.loader import load_string

SEED = 5


def _close(want, got, rtol=1e-5, atol=1e-5):
    if isinstance(want, (tuple, list)):
        for w, g in zip(want, got):
            _close(w, g, rtol, atol)
        return
    if isinstance(want, dict):
        for k in want:
            _close(want[k], got[k], rtol, atol)
        return
    w = np.asarray(want)
    g = n(got)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g.astype(w.dtype), w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def wavefront():
    """A 32x24, 4 spp cbox wavefront through both packages' first bounce."""
    js = jload(str(CBOX_XML), spp=4, width=32, height=24)
    ps = from_compiled(jax.tree_util.tree_map(np.asarray, js))
    L = 32 * 24 * 4
    lane = np.arange(L, dtype=np.uint32)
    jray, jpos, jstate = jdriver.primary_rays(js, jnp.asarray(lane), SEED)
    pray, ppos, pstate = pdriver.primary_rays(ps, t(lane.astype(np.int64)), SEED)

    jhit = jtr.intersect(js, jray["o"], jray["d"], jray["mint"], jray["maxt"])
    phit = ptr.intersect(ps, pray["o"], pray["d"], pray["mint"], pray["maxt"])
    jdiff = (jray["d_dx"], jray["d_dy"])
    pdiff = (pray["d_dx"], pray["d_dy"])
    jsi = jinter.compute_interaction(js, jhit, jray["o"], jray["d"], jray["wavelengths"],
                                     ray_diff=jdiff)
    psi = pinter.compute_interaction(ps, phit, pray["o"], pray["d"], pray["wavelengths"],
                                     ray_diff=pdiff)

    # the bounce's draws, in the integrator's fixed order
    ju_nee, jstate2 = jrng.next_2d(jstate)
    ju1, jstate2 = jrng.next_float32(jstate2)
    ju2, jstate2 = jrng.next_2d(jstate2)
    pu_nee, pstate2 = prng.next_2d(pstate)
    pu1, pstate2 = prng.next_float32(pstate2)
    pu2, pstate2 = prng.next_2d(pstate2)
    return dict(js=js, ps=ps, jray=jray, pray=pray, jpos=jpos, ppos=ppos, jstate=jstate,
                pstate=pstate, jhit=jhit, phit=phit, jsi=jsi, psi=psi,
                ju=(ju_nee, ju1, ju2), pu=(pu_nee, pu1, pu2))


def test_primary_rays(wavefront):
    w = wavefront
    for k in ("o", "d", "d_dx", "d_dy", "mint", "maxt", "wavelengths"):
        _close(w["jray"][k], w["pray"][k], rtol=1e-6, atol=1e-6)
    # 253.82 cosh^2(x): a one-ulp difference of cosh between the libraries
    # doubles in the square
    _close(w["jray"]["wav_weight"], w["pray"]["wav_weight"], rtol=2e-6, atol=0)
    _close(w["jpos"], w["ppos"], rtol=0, atol=0)


def test_rng_state_after_draws(wavefront):
    w = wavefront
    for k in ("hi", "lo", "inc_hi", "inc_lo"):
        np.testing.assert_array_equal(n(w["pstate"][k]), np.asarray(w["jstate"][k]).astype(np.int64))
    for ju, pu in zip(w["ju"], w["pu"]):
        _close(ju, pu, rtol=0, atol=0)


def test_first_hit(wavefront):
    w = wavefront
    jp, pp = np.asarray(w["jhit"]["prim"]), n(w["phit"]["prim"])
    assert (jp >= 0).mean() > 0.5
    # one cluster holding the whole box: the same faces in the same order
    np.testing.assert_array_equal(pp, jp)
    _close(w["jhit"]["t"], w["phit"]["t"], rtol=1e-6, atol=0)
    _close(w["jhit"]["fd"], w["phit"]["fd"], rtol=0, atol=0)


def test_compute_interaction(wavefront):
    w = wavefront
    keys = ("valid", "t", "p", "ng", "sh", "uv", "wi", "prim", "bsdf", "emitter",
            "med_int", "med_ext", "duv_dx", "duv_dy")
    for k in keys:
        _close(w["jsi"][k], w["psi"][k])
    # a hit record without the kernel's face row loads it from the face table
    bare = {k: v for k, v in w["phit"].items() if k != "fd"}
    psi2 = pinter.compute_interaction(w["ps"], bare, w["pray"]["o"], w["pray"]["d"],
                                      w["pray"]["wavelengths"],
                                      ray_diff=(w["pray"]["d_dx"], w["pray"]["d_dy"]))
    for k in keys:
        _close(psi2[k], w["psi"][k], rtol=0, atol=0)


def test_material_params(wavefront):
    w = wavefront
    lam_j, lam_p = w["jray"]["wavelengths"], w["pray"]["wavelengths"]
    jp = jbsdf.material_params(w["js"], w["jsi"]["bsdf"], w["jsi"]["uv"], lam_j)
    pp = pbsdf.material_params(w["ps"], w["psi"]["bsdf"], w["psi"]["uv"], lam_p)
    for k in ("kind", "twosided", "reflectance", "smooth"):
        _close(jp[k], pp[k])


def test_rgb_to_spectral(wavefront):
    w = wavefront
    rgb = np.random.default_rng(8).uniform(0, 2, (3, w["jray"]["o"][0].shape[0]))
    rgb = rgb.astype(np.float32)
    _close(jbsdf.rgb_to_spectral(tuple(jnp.asarray(c) for c in rgb), w["jray"]["wavelengths"]),
           pbsdf.rgb_to_spectral(tuple(t(c) for c in rgb), w["pray"]["wavelengths"]),
           rtol=1e-6, atol=1e-6)


def test_sample_emitter_direct(wavefront):
    w = wavefront
    lam_j, lam_p = w["jray"]["wavelengths"], w["pray"]["wavelengths"]
    jd = jem.sample_emitter_direct(w["js"], w["jsi"]["p"], lam_j, w["ju"][0],
                                   jem.radiance_all(w["js"], lam_j))
    pd = pem.sample_emitter_direct(w["ps"], w["psi"]["p"], lam_p, w["pu"][0],
                                   pem.radiance_all(w["ps"], lam_p))
    for k in ("d", "dist", "pdf", "delta"):
        _close(jd[k], pd[k])
    # spec = radiance / pdf: relative agreement where the pdf is positive
    _close(jd["spec"], pd["spec"], rtol=1e-5, atol=1e-6)
    jpdf = jem.pdf_emitter_direct(w["js"], w["jsi"]["emitter"], w["jray"]["d"],
                                  w["jsi"]["t"], w["jsi"]["ng"])
    ppdf = pem.pdf_emitter_direct(w["ps"], w["psi"]["emitter"], w["pray"]["d"],
                                  w["psi"]["t"], w["psi"]["ng"])
    _close(jpdf, ppdf)


def test_bsdf_sample_eval_pdf(wavefront):
    w = wavefront
    lam_j, lam_p = w["jray"]["wavelengths"], w["pray"]["wavelengths"]
    jp = jbsdf.material_params(w["js"], w["jsi"]["bsdf"], w["jsi"]["uv"], lam_j)
    pp = pbsdf.material_params(w["ps"], w["psi"]["bsdf"], w["psi"]["uv"], lam_p)
    jb = jbsdf.sample_bsdf(jp, w["jsi"]["wi"], w["ju"][1], w["ju"][2])
    pb = pbsdf.sample_bsdf(pp, w["psi"]["wi"], w["pu"][1], w["pu"][2])
    for k in ("wo", "pdf", "weight", "eta", "delta", "null", "valid"):
        _close(jb[k], pb[k])
    _close(jbsdf.eval_bsdf(jp, w["jsi"]["wi"], jb["wo"]), pbsdf.eval_bsdf(pp, w["psi"]["wi"], pb["wo"]))
    _close(jbsdf.pdf_bsdf(jp, w["jsi"]["wi"], jb["wo"]), pbsdf.pdf_bsdf(pp, w["psi"]["wi"], pb["wo"]))


def test_render_matches_misaki_tpu():
    """The slice as a whole: the port's compile + render on the CPU against
    misaki_tpu's, same XML, seed and depth, under the golden criteria."""
    kw = dict(spp=8, width=48, height=36)
    want = np.asarray(jdriver.render(jload(str(CBOX_XML), **kw), seed=7, depth_cap=3)["rgb"])
    got = n(pdriver.render(pload(str(CBOX_XML), **kw), seed=7, depth_cap=3)["rgb"])
    assert got.shape == want.shape == (36, 48, 3)
    frac_off, mean_err = golden_criteria(got, want)
    assert frac_off < 0.02, frac_off
    assert mean_err < 1e-3, mean_err


# ---- the physics and determinism checks of tests/test_render_e2e.py ----

def _furnace(reflectance="1.0"):
    text = open(FURNACE_XML).read().replace('value="1.0"/>', f'value="{reflectance}"/>')
    return compile_scene(load_string(text), spp=64)


def test_furnace_white():
    out = pdriver.render(_furnace(), seed=0, chunk_size=1 << 16, depth_cap=8)
    y = luminance_y(n(out["rgb"]))
    assert abs(float(np.mean(y)) - 1.0) < 0.015, float(np.mean(y))
    assert float(np.max(np.abs(y - 1.0))) < 0.12, float(np.max(np.abs(y - 1.0)))


def test_furnace_albedo_half():
    out = pdriver.render(_furnace("0.5"), seed=1, chunk_size=1 << 16, depth_cap=8)
    y = luminance_y(n(out["rgb"]))
    center, corner = y[14:18, 14:18], y[:4, :4]
    assert abs(float(np.mean(center)) - 0.5) < 0.02, float(np.mean(center))
    assert abs(float(np.mean(corner)) - 1.0) < 0.02, float(np.mean(corner))


@pytest.fixture(scope="module")
def cbox_small():
    return pload(str(CBOX_XML), spp=16, width=64, height=48)


def test_cbox_renders_sane(cbox_small):
    out = pdriver.render(cbox_small, seed=0, chunk_size=1 << 16, depth_cap=4)
    rgb = n(out["rgb"])
    assert np.isfinite(rgb).all()
    assert float(rgb.max()) > 1.0
    assert float(rgb.mean()) > 0.05
    left, right = rgb[:, :21], rgb[:, -21:]
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()
    assert float(np.abs(n(out["alpha"]) - 1).max()) < 1e-3


def test_render_deterministic(cbox_small):
    a = pdriver.render(cbox_small, seed=7, chunk_size=1 << 16, depth_cap=4)
    b = pdriver.render(cbox_small, seed=7, chunk_size=1 << 16, depth_cap=4)
    assert torch.equal(a["rgb"], b["rgb"])


def test_render_chunk_invariant(cbox_small):
    a = pdriver.render(cbox_small, seed=3, chunk_size=1 << 16, depth_cap=4)
    b = pdriver.render(cbox_small, seed=3, chunk_size=1 << 11, depth_cap=4)
    assert np.allclose(n(a["rgb"]), n(b["rgb"]), atol=2e-5)


def test_seed_changes_noise(cbox_small):
    a = n(pdriver.render(cbox_small, seed=0, depth_cap=4)["rgb"])
    b = n(pdriver.render(cbox_small, seed=1, depth_cap=4)["rgb"])
    assert not np.allclose(a, b, atol=1e-4)
    assert abs(a.mean() - b.mean()) < 0.05 * max(a.mean(), 1e-9)


def test_unported_integrator_raises(cbox_small):
    with pytest.raises(NotImplementedError, match="volpath"):
        pdriver.render(cbox_small.replace(integrator="volpath"), depth_cap=1)
