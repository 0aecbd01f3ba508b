"""Core math of the port against misaki_tpu.core, on the same numpy inputs:
vec / frame / warp / spectrum / table / sRGB upsampling to rtol 1e-6 (both
sides are float32; the transcendental functions of the two libraries may
differ in the last bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n, t

from misaki_tpu.core import frame as jframe
from misaki_tpu.core import spectrum as jspec
from misaki_tpu.core import srgb_upsample as jsrgb
from misaki_tpu.core import table as jtable
from misaki_tpu.core import vec as jvec
from misaki_tpu.core import warp as jwarp
from misaki_tpu_torch.core import frame as pframe
from misaki_tpu_torch.core import math as pmath
from misaki_tpu_torch.core import spectrum as pspec
from misaki_tpu_torch.core import srgb_upsample as psrgb
from misaki_tpu_torch.core import table as ptable
from misaki_tpu_torch.core import vec as pvec
from misaki_tpu_torch.core import warp as pwarp

L = 4096
RTOL = 1e-6
ATOL = 1e-7


def _close(a, b, rtol=RTOL, atol=ATOL):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol, atol)
        return
    if isinstance(a, dict):
        for k in a:
            _close(a[k], b[k], rtol, atol)
        return
    np.testing.assert_allclose(n(b), np.asarray(a), rtol=rtol, atol=atol)


def _both(x):
    """numpy (..., L) array -> (jax tuple, torch tuple) of its rows."""
    return tuple(jnp.asarray(r) for r in x), tuple(t(r) for r in x)


@pytest.fixture(scope="module")
def data():
    rs = np.random.default_rng(5)
    a = rs.normal(size=(3, L)).astype(np.float32)
    b = rs.normal(size=(3, L)).astype(np.float32)
    nrm = a / np.linalg.norm(a, axis=0, keepdims=True)
    u2 = rs.uniform(size=(2, L)).astype(np.float32)
    return a, b, nrm.astype(np.float32), u2


@pytest.mark.parametrize("fn", ["add", "sub", "mul", "dot", "cross", "norm",
                                "normalize", "max_abs", "lerp"])
def test_vec(fn, data):
    a, b, _, u2 = data
    ja, pa = _both(a)
    jb, pb = _both(b)
    if fn in ("norm", "normalize", "max_abs"):
        want, got = getattr(jvec, fn)(ja), getattr(pvec, fn)(pa)
    elif fn == "lerp":
        want = jvec.lerp(ja, jb, jnp.asarray(u2[0]))
        got = pvec.lerp(pa, pb, t(u2[0]))
    else:
        want, got = getattr(jvec, fn)(ja, jb), getattr(pvec, fn)(pa, pb)
    _close(want, got)


def test_frame(data):
    a, _, nrm, _ = data
    jn, pn = _both(nrm)
    jv, pv = _both(a)
    jf, pf = jframe.make_frame(jn), pframe.make_frame(pn)
    _close(jf, pf)
    _close(jframe.to_local(jf, jv), pframe.to_local(pf, pv))
    _close(jframe.to_world(jf, jv), pframe.to_world(pf, pv))
    _close(jframe.sin_theta(jv), pframe.sin_theta(pv))


@pytest.mark.parametrize("fn", ["square_to_uniform_triangle",
                                "square_to_uniform_disk_concentric",
                                "square_to_cosine_hemisphere",
                                "square_to_uniform_sphere"])
def test_warp(fn, data):
    _, _, _, u2 = data
    # include the exact corners and the center, where the warps branch
    u2 = u2.copy()
    u2[:, :5] = np.array([[0.0, 0.5, 0.0, 0.999999, 0.5], [0.0, 0.5, 0.5, 0.0, 0.0]])
    ju, pu = _both(u2)
    _close(getattr(jwarp, fn)(ju), getattr(pwarp, fn)(pu), atol=1e-6)


def test_warp_pdfs(data):
    _, _, nrm, _ = data
    jn, pn = _both(nrm)
    _close(jwarp.square_to_cosine_hemisphere_pdf(jn), pwarp.square_to_cosine_hemisphere_pdf(pn))
    _close(jwarp.square_to_uniform_sphere_pdf(jn), pwarp.square_to_uniform_sphere_pdf(pn))


@pytest.mark.parametrize("n_bins", [2, 5, 95])
def test_hat_eval(n_bins):
    rs = np.random.default_rng(n_bins)
    values = rs.uniform(-1, 2, n_bins).astype(np.float32)
    # interior points, exact integers and both clamped ends
    x = np.concatenate([rs.uniform(-2, n_bins + 1, 2000 - n_bins),
                        np.arange(n_bins, dtype=np.float64)]).astype(np.float32).reshape(4, -1)
    want = jtable.hat_eval(values, jnp.asarray(x))
    got = ptable.hat_eval(values, t(x))
    _close(want, got)
    want_m = jtable.hat_eval_multi([values, 2 * values], jnp.asarray(x))
    got_m = ptable.hat_eval_multi([values, t(2 * values)], t(x))
    _close(want_m, got_m)


@pytest.fixture(scope="module")
def wavelengths():
    rs = np.random.default_rng(9)
    u = rs.uniform(size=L).astype(np.float32)
    return u, np.asarray(jspec.sample_wavelength(jnp.asarray(u))[0])


def test_sample_wavelength(wavelengths):
    u, _ = wavelengths
    _close(jspec.sample_wavelength(jnp.asarray(u)), pspec.sample_wavelength(t(u)), rtol=2e-6)


def test_spectrum_to_xyz(wavelengths):
    _, lam = wavelengths
    value = np.random.default_rng(2).uniform(0, 3, lam.shape).astype(np.float32)
    _close(jspec.cie1931_xyz(jnp.asarray(lam)), pspec.cie1931_xyz(t(lam)))
    _close(jspec.spectrum_to_xyz(jnp.asarray(value), jnp.asarray(lam)),
           pspec.spectrum_to_xyz(t(value), t(lam)))


def test_color_matrices(data):
    a, _, _, _ = data
    ja, pa = _both(np.abs(a))
    _close(jspec.xyz_to_srgb(ja), pspec.xyz_to_srgb(pa))
    _close(jspec.srgb_to_xyz(ja), pspec.srgb_to_xyz(pa))
    img = np.abs(a).T.reshape(64, 64, 3)
    # a matrix product: the two libraries sum the three terms in their own
    # order, so a value that cancels to ~0 keeps only an absolute bound
    _close(jspec.xyz_to_srgb_image(jnp.asarray(img)), pspec.xyz_to_srgb_image(t(img)),
           atol=1e-6)


def test_eval_d65_and_pdf(wavelengths):
    _, lam = wavelengths
    _close(jspec.eval_d65(jnp.asarray(lam), 2.0), pspec.eval_d65(t(lam), 2.0))
    _close(jspec.pdf_rgb_spectrum(jnp.asarray(lam)), pspec.pdf_rgb_spectrum(t(lam)))


def test_srgb_model_eval(wavelengths):
    _, lam = wavelengths
    rs = np.random.default_rng(4)
    coeff = (rs.normal(size=(3, L)) * np.array([[1e-4], [1e-1], [10.0]])).astype(np.float32)
    jc, pc = _both(coeff)
    _close(jsrgb.srgb_model_eval(jc, jnp.asarray(lam)), psrgb.srgb_model_eval(pc, t(lam)))


@pytest.mark.parametrize("rgb", [
    (0.5, 0.5, 0.5),
    (0.885809, 0.698859, 0.666422),  # cbox white walls
    (0.105421, 0.37798, 0.076425),  # cbox green
    (0.570068, 0.0430135, 0.0443706),  # cbox red
    (0.45, 0.30, 0.90),
    (0.2, 0.2, 0.2),
])
def test_fit_srgb_coeffs(rgb):
    np.testing.assert_allclose(psrgb.fit_srgb_coeffs(rgb), jsrgb.fit_srgb_coeffs(rgb),
                               rtol=1e-6, atol=1e-12)


def test_sqrt_correctly_rounded():
    """The port's float32 sqrt on the CPU equals the float64 root rounded
    once to float32 (correctly rounded, as 53 >= 2 * 24 + 2) on 2^20 random
    float32 inputs spread over many binades, and on 0, inf and a subnormal."""
    rs = np.random.default_rng(17)
    x = np.exp2(rs.uniform(-40, 40, 1 << 20)).astype(np.float32)
    x[:4] = [0.0, np.inf, 1e-40, 1.0]
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = n(pmath.sqrt(t(x)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # what the helper repairs: torch's own float32 sqrt on this CPU, counted
    raw = torch.sqrt(t(x)).numpy()
    print(f"torch.sqrt float32 differs from the correctly rounded root on "
          f"{int((raw != want).sum())} of {x.size} inputs")


@pytest.mark.parametrize("fn", ["cos", "sin"])
def test_cos_sin_rounded_once(fn):
    """The port's float32 cos and sin on the CPU equal the float64 value
    rounded once to float32, on 2^20 angles of the concentric disk's range
    [-pi/4, 3pi/4]; the count of lanes where each of torch's own float32
    function and the port's differs from XLA's is printed."""
    rs = np.random.default_rng(23)
    x = rs.uniform(-np.pi / 4, 3 * np.pi / 4, 1 << 20).astype(np.float32)
    want = getattr(np, fn)(x.astype(np.float64)).astype(np.float32)
    got = n(getattr(pmath, fn)(t(x)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    xla = np.asarray(getattr(jnp, fn)(jnp.asarray(x)))
    raw = getattr(torch, fn)(t(x)).numpy()
    print(f"{fn}: torch float32 differs from XLA on {int((raw != xla).sum())}, the port on "
          f"{int((got != xla).sum())} of {x.size} inputs")


def test_mean_wavelengths_equal_jnp_linspace():
    """The 16 wavelengths of srgb_model_mean, bit for bit as jnp.linspace
    makes them."""
    want = np.asarray(jnp.linspace(360.0, 830.0, 16))
    got = np.asarray(psrgb.MEAN_WAVELENGTHS, np.float32)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # and the model mean over them, summed in jnp.mean's order
    coeff = (np.random.default_rng(3).normal(size=(4096, 3))
             * [1e-4, 1e-1, 10.0]).astype(np.float32)
    np.testing.assert_array_equal(n(psrgb.srgb_model_mean(coeff)),
                                  np.asarray(jsrgb.srgb_model_mean(coeff)))
