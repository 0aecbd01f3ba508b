"""Every BSDF kind, the mask wrapper and the point light of the port against
misaki_tpu on the same inputs, on the CPU.

Material rows (plain sigmoid spectra, roughness values, IORs, the plastic
and Disney parameters, mask opacities) and directions and samples are made
with numpy from a seed; both packages' `material_params` load them from the
same table and their `eval_bsdf`, `pdf_bsdf` and `sample_bsdf` run on the
same lanes, seeded by a stable hash of the case's name (the same inputs in
every process). Tolerance: rtol 1e-5, atol 1e-6 on values, pdfs, weights
and `wo`; `valid`, `delta`, `null` and `eta` equal. A sampled lane where
misaki_tpu's sample is its own `pdf_bsdf` and `eval_bsdf / pdf_bsdf` at its
`wo` holds the port's pdf and weight to those at the port's own `wo`:
comparing both samples' pdfs would feed a last-bit difference of `wo`
through a Jacobian. Other lanes (delta lobes, the rough dielectric's
scaled-alpha sampler) hold them to misaki_tpu's sample. Two kinds of lane
are exempt, and each case prints how many:

  * a lane within 1e-6 of a branch threshold (u1 against the Fresnel term
    or another lobe probability; s1 at the GGX sampler's tan poles 0.25 and
    0.75), which may branch the other way in one package: at most 0.1% of
    the lanes;
  * an ill-conditioned lane that still agrees to rtol 1e-3, atol 1e-5: at
    most 0.2% of the lanes.
    A float32 cancellation such as sin = sqrt(1 - cos^2) near the pole, the
    refraction Jacobian's (wi.m + eta wo.m)^2 or Disney's tint (a near-black
    base over its luminance) turns a last-bit difference of a transcendental
    function (exp, log, pow, atan2) into up to 1e-4 relative. The port's
    sqrt is correctly rounded on the CPU, as XLA's is (core/math.py `sqrt`);
    torch's own float32 sqrt is not, and exempted up to 0.5% of the lanes.

A sampled lane off misaki_tpu beyond either bound is held instead to
misaki_tpu's own formulas taken in float64 (jax x64) on the same float32
inputs, within the same bound, where misaki_tpu's float32 error there is
the larger: the port takes the rough dielectric sampler in float64, whose
float32 formulas on a microfacet seen at a grazing angle are ill-conditioned
(misaki_tpu's float32 pdf is off the formulas' by up to 25% there).
"""

import zlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import FURNACE_XML, lanes_off, n, nearer_float64, t

from misaki_tpu.bsdf import kernels as jbsdf
from misaki_tpu.core import fresnel as jfresnel
from misaki_tpu.core import frame as jframe
from misaki_tpu.core import math as jmath
from misaki_tpu.core import microfacet as jmf
from misaki_tpu.core import srgb_upsample as jsrgb
from misaki_tpu.emitter import kernels as jem
from misaki_tpu.scene import compiler as jcomp
from misaki_tpu.scene import loader as jloader
from misaki_tpu_torch.bsdf import kernels as pbsdf
from misaki_tpu_torch.core import fresnel as pfresnel
from misaki_tpu_torch.core import frame as pframe
from misaki_tpu_torch.core import math as pmath
from misaki_tpu_torch.core import microfacet as pmf
from misaki_tpu_torch.core import srgb_upsample as psrgb
from misaki_tpu_torch.emitter import kernels as pem
from misaki_tpu_torch.scene import compiler as pcomp
from misaki_tpu_torch.scene import loader as ploader
from misaki_tpu_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_NULL,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
    MASK_FLAG,
    MC_ALPHA_U,
    MC_ALPHA_V,
    MC_DISTR,
    MC_DS_CC_GLOSS,
    MC_DS_SUBSURFACE,
    MC_ETA,
    MC_ETA_RGB,
    MC_FDR,
    MC_K_RGB,
    MC_KIND,
    MC_MASK,
    MC_NONLINEAR,
    MC_OPACITY,
    MC_REFL,
    MC_SPEC_REFL,
    MC_SPEC_TRANS,
    MC_SSW,
    MC_TWOSIDED,
    N_MAT_COLS,
    SCALAR_SLOT_COLS,
)

L = 4096
N_ROWS = 64
RTOL, ATOL = 1e-5, 1e-6
COND_RTOL, COND_ATOL = 1e-3, 1e-5   # the ill-conditioned lanes' bound
EXEMPT_SHARE = 1e-3   # lanes near a branch threshold
COND_SHARE = 2e-3     # ill-conditioned lanes
NEAR = 1e-6


# ---------------------------------------------------------------------------
# the core helpers the BSDFs call
# ---------------------------------------------------------------------------

def _close(want, got, rtol=RTOL, atol=ATOL):
    if isinstance(want, (tuple, list)):
        for w, g in zip(want, got):
            _close(w, g, rtol, atol)
        return
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def lanes():
    rs = np.random.default_rng(11)
    v = rs.normal(size=(3, L)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    w = rs.normal(size=(3, L)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0, keepdims=True)
    u = rs.uniform(size=(3, L)).astype(np.float32)
    return v, w, u


@pytest.mark.parametrize("fn", ["safe_rsqrt", "safe_acos", "safe_asin", "sqr", "lerp", "dot",
                                "cross", "norm", "normalize"])
def test_math_helpers(fn, lanes):
    v, w, u = lanes
    a, b = 1.2 * v.T, w.T   # (L, 3): the trailing-axis helpers
    if fn in ("safe_rsqrt", "sqr"):
        args = (u[0] - 0.3,)
    elif fn in ("safe_acos", "safe_asin"):
        args = (2.2 * u[0] - 1.1,)
    elif fn == "lerp":
        args = (v[0], w[0], u[0])
    elif fn in ("dot", "cross"):
        args = (a, b)
    else:
        args = (a,)
    want = np.asarray(getattr(jmath, fn)(*(jnp.asarray(x) for x in args)))
    got = n(getattr(pmath, fn)(*(t(x) for x in args)))
    # every helper's lanes lie on the leading axis
    bad = ~np.isclose(got, want, rtol=1e-6, atol=1e-7).reshape(L, -1).all(axis=1)
    first = np.nonzero(bad)[0][:8]
    assert not bad.any(), (
        f"{fn}: {int(bad.sum())} of {L} lanes differ (cpu capability "
        f"{torch.backends.cpu.get_cpu_capability()}, {torch.get_num_threads()} threads); "
        f"lanes {first.tolist()}: inputs {[x[first] for x in args]}, "
        f"misaki_tpu {want[first]}, port {got[first]}")


def test_tan_theta(lanes):
    v, _, _ = lanes
    _close(jframe.tan_theta(tuple(jnp.asarray(c) for c in v)),
           pframe.tan_theta(tuple(t(c) for c in v)), rtol=1e-6, atol=1e-7)


def test_fresnel_dielectric(lanes):
    """Both sides of the interface, total internal reflection from inside,
    grazing and normal incidence, and eta 1."""
    v, _, u = lanes
    cos_i = v[2].copy()
    cos_i[:4] = [0.0, 1.0, -1.0, -0.05]
    eta = (1.0 + u[0]).astype(np.float32)
    eta[4:8] = 1.0
    want = jfresnel.fresnel(jnp.asarray(cos_i), jnp.asarray(eta))
    got = pfresnel.fresnel(t(cos_i), t(eta))
    _close(want, got)
    # under TIR cos_theta_t clamps to safe_sqrt's 1e-10, so F is 1 to the
    # bit away from grazing and within a few ulps at |cos_i| ~ 1e-3
    tir = (cos_i < 0) & (1.0 - eta ** 2 * (1.0 - cos_i ** 2) < 0)
    f_tir = n(got[0])[tir]
    assert tir.sum() > 100 and np.all(np.abs(f_tir - 1.0) < 2e-6)
    assert np.all(f_tir[np.abs(cos_i[tir]) > 1e-2] == 1.0)
    _close(jfresnel.fresnel(jnp.asarray(cos_i), 1.5), pfresnel.fresnel(t(cos_i), 1.5))


def test_fresnel_conductor_and_reflect(lanes):
    v, w, u = lanes
    rs = np.random.default_rng(3)
    eta = rs.uniform(0.1, 2.0, (4, L)).astype(np.float32)
    k = rs.uniform(0.5, 5.0, (4, L)).astype(np.float32)
    cos_i = np.abs(v[2])
    _close(jfresnel.fresnel_conductor(jnp.asarray(cos_i), jnp.asarray(eta), jnp.asarray(k)),
           pfresnel.fresnel_conductor(t(cos_i), t(eta), t(k)))
    jv, pv = tuple(jnp.asarray(c) for c in v), tuple(t(c) for c in v)
    jm, pm = tuple(jnp.asarray(c) for c in w), tuple(t(c) for c in w)
    _close(jfresnel.reflect(jv), pfresnel.reflect(pv))
    _close(jfresnel.reflect_m(jv, jm), pfresnel.reflect_m(pv, pm))
    ctt, eti = jnp.asarray(u[0] - 0.5), jnp.asarray(u[1] + 0.5)
    _close(jfresnel.refract(jv, ctt, eti), pfresnel.refract(pv, t(u[0] - 0.5), t(u[1] + 0.5)))
    _close(jfresnel.refract_m(jv, jm, ctt, eti),
           pfresnel.refract_m(pv, pm, t(u[0] - 0.5), t(u[1] + 0.5)))
    eta1 = np.linspace(0.5, 2.5, 64).astype(np.float32)
    _close(jfresnel.fresnel_diffuse_reflectance(jnp.asarray(eta1)),
           pfresnel.fresnel_diffuse_reflectance(t(eta1)))


@pytest.mark.parametrize("aniso", [False, True])
def test_sample_eval_ggx(aniso, lanes):
    v, _, u = lanes
    rs = np.random.default_rng(4)
    au = rs.uniform(0.02, 0.8, L).astype(np.float32)
    av = rs.uniform(0.02, 0.8, L).astype(np.float32) if aniso else au
    s = (u[0], u[1])
    jm, jpdf = jmf.sample_ggx(tuple(jnp.asarray(x) for x in s), jnp.asarray(au), jnp.asarray(av))
    pm, ppdf = pmf.sample_ggx(tuple(t(x) for x in s), t(au), t(av))
    bad, loose = _lane_mismatch2(np.stack([np.asarray(c) for c in jm]), torch.stack(pm))
    near = n((torch.abs(t(u[1]) - 0.25) < NEAR) | (torch.abs(t(u[1]) - 0.75) < NEAR))
    _assert_lanes(bad, loose, near, f"sample_ggx aniso={aniso}")
    _close(jpdf, ppdf)
    jv = tuple(jnp.asarray(c) for c in v)
    pv = tuple(t(c) for c in v)
    _close(jmf.eval_ggx(jv, jnp.asarray(au), jnp.asarray(av)), pmf.eval_ggx(pv, t(au), t(av)))
    _close(jmf.pdf_ggx(jv, jnp.asarray(au), jnp.asarray(av)), pmf.pdf_ggx(pv, t(au), t(av)))
    np.testing.assert_array_equal(n(pmf.clamp_alpha(t(au - 0.5))),
                                  np.asarray(jmf.clamp_alpha(jnp.asarray(au - 0.5))))


@pytest.mark.parametrize("distr", ["ggx", "beckmann", "per_lane"])
def test_smith_g1_and_G(distr, lanes):
    v, w, u = lanes
    rs = np.random.default_rng(5)
    au = rs.uniform(0.02, 1.0, L).astype(np.float32)
    av = rs.uniform(0.02, 1.0, L).astype(np.float32)
    d = {"ggx": pmf.GGX, "beckmann": pmf.BECKMANN,
         "per_lane": (u[2] > 0.5).astype(np.int32)}[distr]
    jd = jnp.asarray(d) if distr == "per_lane" else d
    pd = t(d) if distr == "per_lane" else d
    h = v + w
    h /= np.linalg.norm(h, axis=0, keepdims=True)
    jv, jw, jh = (tuple(jnp.asarray(c) for c in x) for x in (v, w, h))
    pv, pw, ph = (tuple(t(c) for c in x) for x in (v, w, h))
    ja, jb, pa, pb = jnp.asarray(au), jnp.asarray(av), t(au), t(av)
    _close(jmf.smith_g1(jv, jh, ja, jb, jd), pmf.smith_g1(pv, ph, pa, pb, pd))
    _close(jmf.G(jv, jw, jh, ja, jb, jd), pmf.G(pv, pw, ph, pa, pb, pd))


def test_srgb_model_mean():
    """float32 in both; the two libraries' 16 wavelengths on 360..830 differ
    in the last bit at 3 of 16 points (jnp.linspace and torch.linspace round
    differently), so the means agree to the stated tolerance, not to the bit."""
    rs = np.random.default_rng(6)
    coeff = np.stack([rs.normal(size=200) * 1e-4, rs.normal(size=200) * 0.1,
                      rs.normal(size=200) * 5.0], axis=-1)
    _close(jsrgb.srgb_model_mean(coeff), psrgb.srgb_model_mean(coeff))
    _close(jsrgb.srgb_model_mean(coeff[0]), psrgb.srgb_model_mean(coeff[0]))


# ---------------------------------------------------------------------------
# material rows and the BSDF cases
# ---------------------------------------------------------------------------

def _spec_slot(rs):
    """A plain sigmoid-spectrum slot with random coefficients that keep the
    sigmoid's argument within about +-2.5 on 360..830 nm, so reflectances
    stay in about [0.05, 0.95] as a fitted sRGB colour's do (near 0 the
    sigmoid's 0.5 v / sqrt(v^2 + 1) + 0.5 cancels, and Disney's tint divides
    that last-bit noise by the luminance)."""
    slot = np.zeros(13)
    slot[1:4] = [rs.normal() * 1e-6, rs.normal() * 1e-3, rs.normal() * 0.5]
    slot[7:13] = [1, 0, 0, 0, 1, 0]
    return slot


def _scalar_slot(value):
    slot = np.zeros(SCALAR_SLOT_COLS)
    slot[1] = slot[2] = value
    slot[3:9] = [1, 0, 0, 0, 1, 0]
    return slot


def _row(kind, rs, **kw):
    """One material row of `kind` with random parameters."""
    row = np.zeros(N_MAT_COLS)
    row[MC_KIND] = kind
    row[MC_TWOSIDED] = kw.get("twosided", 0.0)
    row[MC_DISTR] = kw.get("distr", pmf.GGX)
    row[MC_ETA] = rs.uniform(1.2, 2.0)
    row[MC_ETA_RGB: MC_ETA_RGB + 3] = rs.uniform(0.1, 2.0, 3)
    row[MC_K_RGB: MC_K_RGB + 3] = rs.uniform(0.5, 5.0, 3)
    for base in (MC_REFL, MC_SPEC_REFL, MC_SPEC_TRANS):
        row[base: base + 13] = _spec_slot(rs)
    a_u = rs.uniform(0.03, 0.7)
    a_v = rs.uniform(0.03, 0.7) if kw.get("aniso") else a_u
    if kind == BSDF_DISNEY:
        a_u = a_v = rs.uniform(0.1, 1.0)   # roughness, not an alpha
        for base in range(MC_DS_SUBSURFACE, MC_DS_CC_GLOSS + 1, SCALAR_SLOT_COLS):
            row[base: base + SCALAR_SLOT_COLS] = _scalar_slot(rs.uniform(0.0, 1.0))
    row[MC_ALPHA_U: MC_ALPHA_U + SCALAR_SLOT_COLS] = _scalar_slot(a_u)
    row[MC_ALPHA_V: MC_ALPHA_V + SCALAR_SLOT_COLS] = _scalar_slot(a_v)
    if kind == BSDF_PLASTIC:
        row[MC_SSW] = rs.uniform(0.1, 0.9)
        row[MC_NONLINEAR] = kw.get("nonlinear", 0.0)
        row[MC_FDR] = pcomp._fresnel_diffuse_reflectance(row[MC_ETA])
    if kw.get("mask"):
        row[MC_MASK] = 1.0
        row[MC_OPACITY: MC_OPACITY + 13] = _spec_slot(rs)
    return row


# case -> (kinds in the table, row options, lanes from inside the surface)
CASES = {
    "diffuse_twosided": ((BSDF_DIFFUSE,), {"twosided": "half"}, True),
    "roughconductor_ggx": ((BSDF_ROUGH_CONDUCTOR,), {}, False),
    "roughconductor_beckmann_aniso": ((BSDF_ROUGH_CONDUCTOR,),
                                      {"distr": pmf.BECKMANN, "aniso": True}, False),
    "conductor": ((BSDF_CONDUCTOR,), {}, False),
    "roughdielectric": ((BSDF_ROUGH_DIELECTRIC,), {}, True),
    "dielectric_tir": ((BSDF_DIELECTRIC,), {}, True),
    "roughplastic_linear": ((BSDF_PLASTIC,), {}, False),
    "roughplastic_nonlinear": ((BSDF_PLASTIC,), {"nonlinear": 1.0}, False),
    "disney": ((BSDF_DISNEY,), {"aniso": False}, False),
    "null": ((BSDF_NULL,), {}, True),
    "mask_diffuse": ((BSDF_DIFFUSE,), {"mask": True}, False),
    "mask_roughconductor": ((BSDF_ROUGH_CONDUCTOR,), {"mask": True}, False),
    "every_kind": ((BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC,
                    BSDF_DIELECTRIC, BSDF_CONDUCTOR, BSDF_NULL, BSDF_PLASTIC, BSDF_DISNEY),
                   {"mask": "half", "twosided": "half"}, True),
}


def _case_seed(name):
    """The numpy seed of a case's inputs, the same in every process."""
    return zlib.crc32(name.encode())


def _case_inputs(name):
    kinds, opts, inside = CASES[name]
    rs = np.random.default_rng(_case_seed(name))
    rows = []
    for i in range(N_ROWS):
        o = dict(opts)
        for k in ("twosided", "mask"):
            if o.get(k) == "half":
                o[k] = float(i % 2) if k == "twosided" else bool(i // 2 % 2)
        o.setdefault("twosided", 0.0)
        if name == "every_kind":
            o["distr"] = pmf.GGX if i % 3 else pmf.BECKMANN
        rows.append(_row(kinds[i % len(kinds)], rs, **o))
    params = np.stack(rows, axis=-1).astype(np.float32)
    bsdf_kinds = tuple(sorted(set(kinds) | ({MASK_FLAG} if opts.get("mask") else set())))
    ids = rs.integers(0, N_ROWS, L).astype(np.int32)
    wi = rs.normal(size=(3, L))
    wi[2] = np.abs(wi[2]) if not inside else np.where(rs.uniform(size=L) < 0.35,
                                                      -np.abs(wi[2]), np.abs(wi[2]))
    if name == "dielectric_tir":
        # a quarter of the lanes inside the glass beyond the critical angle
        g = slice(0, L // 4)
        cz = rs.uniform(0.02, 0.5, L // 4)
        wi[:2, g] *= np.sqrt(1.0 - cz * cz) / np.linalg.norm(wi[:2, g], axis=0)
        wi[2, g] = -cz
    wi /= np.linalg.norm(wi, axis=0, keepdims=True)
    wo = rs.normal(size=(3, L))
    wo /= np.linalg.norm(wo, axis=0, keepdims=True)
    uv = rs.uniform(size=(2, L))
    lam = rs.uniform(360.0, 830.0, (4, L))
    u = rs.uniform(size=(3, L))
    f32 = [x.astype(np.float32) for x in (wi, wo, uv, lam, u)]
    return params, bsdf_kinds, ids, *f32


def _scene(params, kinds, tensor):
    return SimpleNamespace(materials=SimpleNamespace(params=tensor(params)), bsdf_kinds=kinds,
                           bitmap_slots=(), bitmap_meta=(), diff_mode=False)


def _near_thresholds(name, pp, wi, u):
    """Lanes whose u1 or s1 lies within NEAR of a branch threshold of the
    sampling path, from the port's intermediates."""
    u1, s1 = t(u[0]), t(u[2])
    near = (torch.abs(s1 - 0.25) < NEAR) | (torch.abs(s1 - 0.75) < NEAR)
    kind = pp["kind"]
    wi_t = tuple(t(c) for c in wi)
    flip = pp["twosided"] & (wi_t[2] < 0.0)
    wi_f = (wi_t[0], wi_t[1], torch.where(flip, -wi_t[2], wi_t[2]))
    if pp["mask"] is not None:
        op = pbsdf._mask_op_prob(pp)
        near |= pp["mask"] & (torch.abs(u1 - op) < NEAR)
        u1 = torch.where(pp["mask"], torch.clamp(u1 / op, max=1.0 - 1e-7), u1)
    cti = wi_f[2]
    thr = []
    if BSDF_DIELECTRIC in pp["kinds"]:
        thr.append((kind == BSDF_DIELECTRIC, pfresnel.fresnel(cti, pp["eta"])[0]))
    if BSDF_ROUGH_DIELECTRIC in pp["kinds"]:
        sc = 1.2 - 0.2 * torch.sqrt(torch.abs(cti))
        mv, _ = pmf.sample_ggx((t(u[1]), s1), pp["alpha_u"] * sc, pp["alpha_v"] * sc)
        f = pfresnel.fresnel(wi_f[0] * mv[0] + wi_f[1] * mv[1] + cti * mv[2], pp["eta"])[0]
        thr.append((kind == BSDF_ROUGH_DIELECTRIC, f))
    if BSDF_PLASTIC in pp["kinds"]:
        thr.append((kind == BSDF_PLASTIC, pbsdf._plastic_prob_specular(pp, cti)))
    if BSDF_DISNEY in pp["kinds"]:
        ds = pp["disney"]
        prob_d = (1.0 - ds["metallic"]) * 0.5
        u1r = (u1 - prob_d) / torch.clamp(1.0 - prob_d, min=1e-6)
        thr.append((kind == BSDF_DISNEY, prob_d))
        near |= (kind == BSDF_DISNEY) & (torch.abs(u1r - 1.0 / (1.0 + ds["clearcoat"])) < NEAR)
    for sel, value in thr:
        near |= sel & (torch.abs(u1 - value) < NEAR)
    return n(near)


def _lane_mismatch(want, got, rtol=RTOL, atol=ATOL):
    """Per lane (last axis): does got differ from want beyond the tolerance."""
    w, g = np.asarray(want), n(got)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        bad = g.astype(w.dtype) != w
        return bad.reshape(-1, bad.shape[-1]).any(axis=0)
    return lanes_off(w, g, rtol, atol)


def _lane_mismatch2(want, got):
    """(beyond the tolerance, beyond the ill-conditioned lanes' bound)."""
    return (_lane_mismatch(want, got),
            _lane_mismatch(want, got, rtol=COND_RTOL, atol=COND_ATOL))


def _sample_float64(params, kinds, ids, wi, uv, lam, u):
    """misaki_tpu's material_params and sample_bsdf on the case's float32
    inputs, taken in float64 (jax x64): the formulas' own values, against
    which a lane where the port and misaki_tpu part is judged."""
    with jax.enable_x64(True):
        def d(a):
            return jnp.asarray(np.asarray(a, np.float64))

        jp = jbsdf.material_params(_scene(params.astype(np.float64), kinds, jnp.asarray),
                                   jnp.asarray(ids), tuple(d(c) for c in uv), d(lam))
        out = jbsdf.sample_bsdf(jp, tuple(d(c) for c in wi), d(u[0]), (d(u[1]), d(u[2])))
        return {"wo": np.stack([np.asarray(c) for c in out["wo"]]),
                "pdf": np.asarray(out["pdf"]), "weight": np.asarray(out["weight"])}


def _held_to_float64(want, got, ref, bad, loose):
    """The lanes of (bad, loose) that stay off where a lane off misaki_tpu's
    float32 value `want` is held to the float64 value `ref` instead: within
    the same bound of it, and misaki_tpu's own error there the larger."""
    nearer = nearer_float64(want, n(got), ref)
    bad64, loose64 = _lane_mismatch2(ref, got)
    return bad & ~(nearer & ~bad64), loose & ~(nearer & ~loose64)


def _assert_lanes(bad, loose, near, label, capsys=None):
    """Every lane agrees, but for the exempt ones of the module docstring:
    near a threshold (at most EXEMPT_SHARE of the lanes), or within the
    ill-conditioned bound (at most COND_SHARE)."""
    exempt = bad & (near | ~loose)
    if capsys is not None:
        with capsys.disabled():
            print(f"\n{label}: {int((bad & near).sum())} of {bad.size} lanes exempt near a "
                  f"branch threshold, {int((exempt & ~near).sum())} ill-conditioned")
    assert not (bad & ~exempt).any(), f"{label}: {int((bad & ~exempt).sum())} lanes differ"
    assert (bad & near).sum() <= EXEMPT_SHARE * bad.size, f"{label}: {int((bad & near).sum())}"
    assert (exempt & ~near).sum() <= COND_SHARE * bad.size, f"{label}: {int(exempt.sum())}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_bsdf_kind_parity(name, capsys):
    params, kinds, ids, wi, wo, uv, lam, u = _case_inputs(name)
    js, ps = _scene(params, kinds, jnp.asarray), _scene(params, kinds, t)
    jp = jbsdf.material_params(js, jnp.asarray(ids), tuple(jnp.asarray(c) for c in uv),
                               jnp.asarray(lam))
    pp = pbsdf.material_params(ps, t(ids), tuple(t(c) for c in uv), t(lam))
    for k in ("kind", "twosided", "distr", "reflectance", "spec_refl", "spec_trans", "alpha_u",
              "alpha_v", "eta", "eta_spec", "k_spec", "smooth", "ssw", "fdr", "nonlinear",
              "ds_spec0", "ds_sheen"):
        assert not _lane_mismatch(jp[k], pp[k]).any(), k
    assert (jp["mask"] is None) == (pp["mask"] is None)
    if pp["mask"] is not None:
        assert not _lane_mismatch(jp["opacity"], pp["opacity"]).any()
        assert pp["mask"].any()
        if CASES[name][1]["mask"] == "half":
            assert not pp["mask"].all()
    if pp["disney"] is not None:
        for k in pp["disney"]:
            assert not _lane_mismatch(jp["disney"][k], pp["disney"][k]).any(), k

    jwi, pwi = tuple(jnp.asarray(c) for c in wi), tuple(t(c) for c in wi)
    jwo, pwo = tuple(jnp.asarray(c) for c in wo), tuple(t(c) for c in wo)
    no_lane = np.zeros(L, bool)
    bad, loose = _lane_mismatch2(jbsdf.eval_bsdf(jp, jwi, jwo), pbsdf.eval_bsdf(pp, pwi, pwo))
    _assert_lanes(bad, loose, no_lane, f"{name} eval")
    bad, loose = _lane_mismatch2(jbsdf.pdf_bsdf(jp, jwi, jwo), pbsdf.pdf_bsdf(pp, pwi, pwo))
    _assert_lanes(bad, loose, no_lane, f"{name} pdf")

    ju1, ju2 = jnp.asarray(u[0]), (jnp.asarray(u[1]), jnp.asarray(u[2]))
    jb = jbsdf.sample_bsdf(jp, jwi, ju1, ju2)
    pb = pbsdf.sample_bsdf(pp, pwi, t(u[0]), (t(u[1]), t(u[2])))
    bad, loose = np.zeros(L, bool), np.zeros(L, bool)
    for k in ("eta", "valid", "delta", "null"):
        bad |= _lane_mismatch(jb[k], pb[k], rtol=0.0, atol=0.0)
    loose |= bad
    # pdf and weight: where misaki_tpu's own sample is its pdf_bsdf and
    # eval_bsdf / pdf_bsdf at its own wo, those at the port's wo; elsewhere
    # (delta and invalid lanes, the rough dielectric's scaled-alpha sampler)
    # misaki_tpu's sample
    def at(wo_):
        wo_ = tuple(jnp.asarray(np.asarray(c)) for c in wo_)
        pdf_ = np.asarray(jbsdf.pdf_bsdf(jp, jwi, wo_), np.float64)
        f_ = np.asarray(jbsdf.eval_bsdf(jp, jwi, wo_), np.float64)
        return pdf_, f_ / np.where(pdf_ > 0.0, pdf_, 1.0)[None, :]

    j_pdf, j_w = np.asarray(jb["pdf"]), np.asarray(jb["weight"])
    own_pdf, own_w = at(jb["wo"])
    consistent = (np.asarray(jb["valid"]) & ~np.asarray(jb["delta"]) & (j_pdf > 0.0)
                  & ~_lane_mismatch(j_pdf, own_pdf) & ~_lane_mismatch(j_w, own_w))
    pdf_at, w_at = at(n(c) for c in pb["wo"])
    want_pdf = np.where(consistent, pdf_at, j_pdf)
    want_w = np.where(consistent[None, :], w_at, j_w)
    # a lane off misaki_tpu beyond a bound is held to the float64 value
    # instead, where misaki_tpu's own error is the larger (an ill-conditioned
    # formula: a refraction on a microfacet seen at a grazing angle, which
    # the port takes in float64)
    ref = None
    for key, want, got in (("pdf", want_pdf, pb["pdf"]), ("weight", want_w, pb["weight"]),
                           ("wo", np.stack([np.asarray(c) for c in jb["wo"]]),
                            torch.stack(pb["wo"]))):
        b, lo = _lane_mismatch2(want, got)
        if b.any():
            ref = ref or _sample_float64(params, kinds, ids, wi, uv, lam, u)
            b, lo = _held_to_float64(want, got, ref[key], b, lo)
        bad, loose = bad | b, loose | lo
    # the sampled directions' eval and pdf, where the samples agree
    ok = t(~bad)
    pwo_s = tuple(torch.where(ok, c, 0.0) for c in pb["wo"])
    jwo_s = tuple(jnp.asarray(n(c)) for c in pwo_s)
    for fj, fp in ((jbsdf.eval_bsdf, pbsdf.eval_bsdf), (jbsdf.pdf_bsdf, pbsdf.pdf_bsdf)):
        b, lo = _lane_mismatch2(fj(jp, jwi, jwo_s), fp(pp, pwi, pwo_s))
        bad, loose = bad | b, loose | lo
    near = _near_thresholds(name, pp, wi, u)
    _assert_lanes(bad, loose, near, f"{name} sample (valid {float(n(pb['valid']).mean()):.3f}, "
                  f"delta {float(n(pb['delta']).mean()):.3f})", capsys)
    # the case reaches its branches
    if name == "dielectric_tir":
        assert n(pb["valid"]).all() and (n(pb["eta"]) == 1.0)[: L // 4].all()
    if name in ("roughdielectric", "dielectric_tir"):
        assert (n(pb["eta"]) != 1.0).mean() > 0.3
    if name.startswith("mask"):
        assert 0.3 < n(pb["null"]).mean() < 0.9


# ---------------------------------------------------------------------------
# the point light
# ---------------------------------------------------------------------------

POINT_XML = open(FURNACE_XML).read().replace(
    '<emitter type="constant">',
    '<emitter type="point"><point name="position" x="0.5" y="3" z="-1"/>'
    '<rgb name="intensity" value="4, 3, 2"/></emitter>\n    <emitter type="constant">')


@pytest.fixture(scope="module")
def point_scenes():
    js = jcomp.compile_scene(jloader.load_string(POINT_XML))
    ps = pcomp.compile_scene(ploader.load_string(POINT_XML), device="cpu")
    return js, ps


def test_point_emitter_compiles(point_scenes):
    js, ps = point_scenes
    assert ps.emitter_kinds == tuple(js.emitter_kinds) == (2, 1)
    assert ps.environment_idx == js.environment_idx == 1
    for k in ("kind", "position", "area"):
        np.testing.assert_array_equal(n(getattr(ps.emitters, k)),
                                      np.asarray(getattr(js.emitters, k)))
    np.testing.assert_allclose(n(ps.emitters.rad_coeff), np.asarray(js.emitters.rad_coeff),
                               rtol=1e-6)


def test_sample_point_emitter(point_scenes):
    """`_sample_point_emitter` alone, then `sample_emitter_direct` over both
    emitters (the point light's lanes delta), and `pdf_emitter_direct`,
    which gives a point light 0."""
    js, ps = point_scenes
    rs = np.random.default_rng(8)
    p = rs.uniform(-1.0, 1.0, (3, L)).astype(np.float32)
    u2 = rs.uniform(size=(2, L)).astype(np.float32)
    lam = rs.uniform(360.0, 830.0, (4, L)).astype(np.float32)
    jpt, ppt = tuple(jnp.asarray(c) for c in p), tuple(t(c) for c in p)
    ju2, pu2 = tuple(jnp.asarray(c) for c in u2), tuple(t(c) for c in u2)
    jl, pl = jnp.asarray(lam), t(lam)
    want = jem._sample_point_emitter(js, 0, jpt, jl, ju2)
    got = pem._sample_point_emitter(ps, 0, ppt, pl, pu2)
    for k in ("d", "dist", "pdf", "spec"):
        _close(want[k], got[k])
    jrad, prad = jem.radiance_all(js, jl), pem.radiance_all(ps, pl)
    want = jem.sample_emitter_direct(js, jpt, jl, ju2, jrad)
    got = pem.sample_emitter_direct(ps, ppt, pl, pu2, prad)
    for k in ("d", "dist", "pdf", "spec"):
        _close(want[k], got[k])
    np.testing.assert_array_equal(n(got["delta"]), np.asarray(want["delta"]))
    assert 0.4 < n(got["delta"]).mean() < 0.6
    ids = rs.integers(-1, 2, L).astype(np.int32)
    _close(jem.pdf_emitter_direct(js, jnp.asarray(ids), want["d"], want["dist"], want["d"]),
           pem.pdf_emitter_direct(ps, t(ids), got["d"], got["dist"], got["d"]))
    assert (n(pem.pdf_emitter_direct(ps, t(np.zeros(L, np.int32)), got["d"], got["dist"],
                                     got["d"])) == 0.0).all()
