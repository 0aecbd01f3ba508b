"""The volpath integrator and participating media of the port against
misaki_tpu's, on the CPU: the compiled media tables, the medium stages lane
by lane, the closed forms of tests/test_volpath.py and
tests/test_grid_volume.py, and whole renders.

Scenes: the absorbing slab and the null-plane stack of
tests/test_volpath.py, the linear-gradient grid slab of
tests/test_grid_volume.py (density (k + 0.5) / 16), the port's teapot
stand-in (misaki_tpu_torch/scenes/teapot/scene.xml), its grid-volume scene
(scenes/volume/, a 16^3 grid here) and a small volpath scene with a bitmap
floor and a bitmap-opacity mask (the texel-fetch route, misaki_tpu with
MISAKI_FORCE_PAGED=1 as in tests/test_torch_textures_env.py).

Tolerances: the compiled tables are equal to the bit. Stage values rtol
1e-5; sampled directions and pdfs rtol 1e-4 (the libraries' log1p / exp /
cos / sin differ in the last bit on a few percent of float32 inputs, which
sampled quantities carry through a few more operations), as in
tests/test_torch_bsdf.py. Grid densities: misaki_tpu fetches the grid
rounded to bfloat16 (misaki_tpu/core/table.py `fetch_lowp`), the port in
float32, so the port is held to a float64 trilinear within 1e-6 relative on
a random float32 grid, and to misaki_tpu only on grids bfloat16 holds
exactly, where its fetch is exact. Renders meet the golden criteria of
tests/torch_helpers.py; a sampled distance within an ulp of the surface
can decide scatter against surface differently in the two libraries, and
the share of lanes that do is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_grid_volume import CUBE_OBJ, SCENE_XML as GRID_XML
from test_volpath import ABSORB_SLAB_XML, NULL_STACK_XML, _null_stack_obj, _slab_obj
from torch_helpers import SCENES, golden_criteria, n, t

from misaki_tpu.render import driver as jdriver
from misaki_tpu.render import integrator as jinteg
from misaki_tpu.render import medium as jmed
from misaki_tpu.scene.compiler import compile_scene as jcompile
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu.scene.loader import load_string as jload_string
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.render import integrator as pinteg
from misaki_tpu_torch.render import medium as pmed
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.compiler import compile_scene
from misaki_tpu_torch.scene.compiler import load_and_compile as pload
from misaki_tpu_torch.scene.loader import load_string
from misaki_tpu_torch.scenes.envlit.assets import write_rgbe
from misaki_tpu_torch.scenes.volume import assets as volume_assets

TEAPOT_XML = SCENES / "teapot" / "scene.xml"
RTOL, RTOL_SAMPLED = 1e-5, 1e-4
MEDIA_FIELDS = ("kind", "sigma_s", "sigma_a", "sigma_s_coeff", "sigma_a_coeff", "sigma_s_amp",
                "sigma_a_amp", "scale", "g", "density_vol")

BITMAP_VOLPATH_XML = """<scene version="0.6.0">
  <integrator type="volpath"><integer name="max_depth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world"><lookat origin="0, 1.5, 3" target="0, 0.3, 0" up="0, 1, 0"/></transform>
    <sampler type="independent"><integer name="sample_count" value="4"/></sampler>
    <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="18"/></film>
  </sensor>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
  <shape type="rectangle">
    <transform name="to_world"><rotate x="1" angle="-90"/><scale x="2" y="2" z="2"/></transform>
    <bsdf type="diffuse"><texture type="bitmap" name="reflectance">
      <string name="filename" value="tex.hdr"/></texture></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><scale x="0.6" y="0.6" z="1"/><translate x="-0.5" y="0.6" z="0.2"/></transform>
    <bsdf type="mask"><texture type="bitmap" name="opacity">
      <string name="filename" value="tex.hdr"/></texture><bsdf type="diffuse"/></bsdf>
  </shape>
  <shape type="sphere">
    <float name="radius" value="0.4"/><point name="center" x="0.4" y="0.4" z="0"/>
    <bsdf type="null"/>
    <medium type="homogeneous" name="interior">
      <rgb name="sigma_s" value="1.5, 1.5, 1.5"/><rgb name="sigma_a" value="0.2, 0.5, 0.9"/>
      <float name="g" value="-0.3"/>
    </medium>
  </shape>
</scene>
"""


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{name: (misaki_tpu scene, XML path)}: every scene compiled by
    misaki_tpu (MISAKI_FORCE_PAGED=1 for the bitmap scene's compile)."""
    tmp = tmp_path_factory.mktemp("volpath")
    xmls = {
        "slab": ABSORB_SLAB_XML.replace("__slab__", _slab_obj(tmp)),
        "null_stack": NULL_STACK_XML.replace("__stack__", _null_stack_obj(tmp, 3)),
    }
    (tmp / "cube.obj").write_text(CUBE_OBJ)
    W = 16
    x = (np.arange(W) + 0.5) / W
    np.save(tmp / "grid.npy", np.broadcast_to(x[None, None, :], (W, W, W)).astype(np.float32))
    xmls["grid_slab"] = GRID_XML % {"sa": "4.0"}
    write_rgbe(tmp / "tex.hdr", np.random.default_rng(4).uniform(
        0.1, 0.9, (8, 8, 3)).astype(np.float32))
    xmls["bitmap"] = BITMAP_VOLPATH_XML
    paths = {}
    for name, xml in xmls.items():
        paths[name] = tmp / f"{name}.xml"
        paths[name].write_text(xml)
    paths["teapot"] = TEAPOT_XML
    paths["volume"] = volume_assets.write_assets(tmp / "volume", res=16)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISAKI_FORCE_PAGED", "1")
        for name, path in paths.items():
            out[name] = (jload(str(path)), path)
    return out


def _port(js):
    return from_compiled(jax.tree_util.tree_map(np.asarray, js), device="cpu")


@pytest.mark.parametrize("name", ["slab", "null_stack", "grid_slab", "teapot", "volume",
                                  "bitmap"])
def test_compile_matches_jax(scenes, name, monkeypatch):
    """The port's compiler on the XML: the media table, the volume table and
    its meta, the face table (FC_MED_INT / FC_MED_EXT) equal to the bit, the
    integrator and the aov's nested default."""
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")
    js, path = scenes[name]
    ps = pload(str(path), device="cpu")
    for f in MEDIA_FIELDS:
        want, got = np.asarray(getattr(js.media, f)), n(getattr(ps.media, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(n(ps.volumes), np.asarray(js.volumes).reshape(-1))
    assert ps.volume_meta == tuple(js.volume_meta)
    np.testing.assert_array_equal(n(ps.geometry.face_tab), np.asarray(js.geometry.face_tab))
    assert ps.integrator == js.integrator == "volpath"
    assert ps.aov_nested == js.aov_nested
    if name in ("grid_slab", "volume"):
        assert len(ps.volume_meta) == 1 and int(ps.media.density_vol[0]) == 0
    if name == "teapot":
        assert ps.media.kind.shape[0] == 2 and ps.max_depth == -1


def _lanes(L, seed):
    rs = np.random.default_rng(seed)
    wav = rs.uniform(360.0, 830.0, (4, L)).astype(np.float32)
    return rs, wav


def _close(want, got, rtol, atol=1e-6):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


def test_fetch_medium_matches_jax(scenes):
    """Per-lane medium parameters for ids -1 (vacuum), 0 and 1 of the
    teapot's two media at random wavelengths."""
    js, _ = scenes["teapot"]
    ps = _port(js)
    L = 513
    rs, wav = _lanes(L, 1)
    ids = rs.integers(-1, 2, L).astype(np.int32)
    want = jmed.fetch_medium(js, jnp.asarray(ids), jnp.asarray(wav))
    got = pmed.fetch_medium(ps, t(ids), t(wav))
    for k in ("sigma_s", "sigma_t", "g"):
        _close(want[k], got[k], RTOL)
    np.testing.assert_array_equal(n(got["vacuum"]), ids < 0)
    assert n(got["sigma_t"])[:, ids < 0].max() == 0.0


def _medium_lanes(js, ps, L, seed, ids):
    rs, wav = _lanes(L, seed)
    wp = jmed.fetch_medium(js, jnp.asarray(ids), jnp.asarray(wav))
    pp = pmed.fetch_medium(ps, t(ids), t(wav))
    channel = rs.integers(0, 4, L).astype(np.int32)
    u = rs.random(L, dtype=np.float32)
    return rs, wp, pp, channel, u


def test_sample_distance_homogeneous_matches_jax(scenes):
    """Free-flight sampling in the teapot's media and in vacuum, with
    surfaces at random distances and misses (tmax inf)."""
    js, _ = scenes["teapot"]
    ps = _port(js)
    L = 4097
    ids = np.random.default_rng(2).integers(-1, 2, L).astype(np.int32)
    rs, wp, pp, channel, u = _medium_lanes(js, ps, L, 2, ids)
    tmax = rs.uniform(0.0, 6.0, L).astype(np.float32)
    tmax[rs.random(L) < 0.2] = np.inf
    want = jmed.sample_distance(wp, jnp.asarray(channel), jnp.asarray(u), jnp.asarray(tmax))
    got = pmed.sample_distance(pp, t(channel), t(u), t(tmax))
    scatter = np.asarray(want["scatter"])
    assert 0.1 < scatter.mean() < 0.9
    flipped = n(got["scatter"]) != scatter
    assert flipped.mean() <= 1e-3, flipped.mean()
    keep = ~flipped
    for k, rtol in (("t", RTOL_SAMPLED), ("pdf", RTOL_SAMPLED), ("rho", RTOL)):
        _close(np.asarray(want[k])[keep], n(got[k])[keep], rtol)
    _close(np.asarray(want["tr"])[:, keep], n(got["tr"])[:, keep], RTOL_SAMPLED)


def _grid_rays(rs, L):
    """Rays that start around the unit cube and cross it."""
    o = rs.uniform(-0.5, 1.5, (3, L)).astype(np.float32)
    target = rs.uniform(0.1, 0.9, (3, L))
    d = target - o
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("what", ["sample_distance", "transmittance_ray"])
def test_grid_medium_matches_jax(scenes, what):
    """The marched grid medium (HETERO_STEPS fixed steps) on the gradient
    slab, whose densities bfloat16 holds exactly: the scatter point, its
    pdf, transmittance and density, and the transmittance over a segment."""
    js, _ = scenes["grid_slab"]
    ps = _port(js)
    L = 1025
    ids = np.zeros(L, np.int32)
    ids[::7] = -1
    rs, wp, pp, channel, u = _medium_lanes(js, ps, L, 3, ids)
    o, d = _grid_rays(rs, L)
    tmax = rs.uniform(0.2, 3.0, L).astype(np.float32)
    jo, jd = tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d)
    po, pd = tuple(t(c) for c in o), tuple(t(c) for c in d)
    if what == "transmittance_ray":
        want = jmed.transmittance_ray(js, wp, jnp.asarray(ids), jo, jd, jnp.asarray(tmax))
        got = pmed.transmittance_ray(ps, pp, t(ids), po, pd, t(tmax))
        assert 0.0 < float(np.asarray(want).min()) < 0.9
        _close(want, got, RTOL_SAMPLED)
        return
    want = jmed.sample_distance(wp, jnp.asarray(channel), jnp.asarray(u), jnp.asarray(tmax),
                                scene=js, o=jo, d=jd, med_ids=jnp.asarray(ids))
    got = pmed.sample_distance(pp, t(channel), t(u), t(tmax), scene=ps, o=po, d=pd,
                               med_ids=t(ids))
    scatter = np.asarray(want["scatter"])
    assert 0.1 < scatter.mean() < 0.9
    flipped = n(got["scatter"]) != scatter
    assert flipped.mean() <= 2e-3, flipped.mean()
    keep = ~flipped
    for k in ("t", "pdf", "rho"):
        w, g = np.asarray(want[k])[keep], n(got[k])[keep]
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=k)
        _close(w[fin], g[fin], RTOL_SAMPLED)
    _close(np.asarray(want["tr"])[:, keep], n(got["tr"])[:, keep], RTOL_SAMPLED)


@pytest.mark.parametrize("g", [0.0, 0.5, -0.3, 5e-5])
def test_phase_matches_jax(g):
    """HG eval and sample (the |g| < 1e-4 branch included) against
    misaki_tpu's."""
    rs = np.random.default_rng(5)
    L = 2049
    wi = rs.normal(size=(3, L))
    wi = (wi / np.linalg.norm(wi, axis=0)).astype(np.float32)
    wo = rs.normal(size=(3, L))
    wo = (wo / np.linalg.norm(wo, axis=0)).astype(np.float32)
    u2 = rs.random((2, L), dtype=np.float32)
    gg = np.full(L, g, np.float32)
    jwi, pwi = tuple(jnp.asarray(c) for c in wi), tuple(t(c) for c in wi)
    _close(jmed.phase_eval(jwi, tuple(jnp.asarray(c) for c in wo), jnp.asarray(gg)),
           pmed.phase_eval(pwi, tuple(t(c) for c in wo), t(gg)), RTOL)
    jwo, jpdf, jw = jmed.phase_sample(jwi, jnp.asarray(gg), tuple(jnp.asarray(c) for c in u2))
    pwo, ppdf, pw = pmed.phase_sample(pwi, t(gg), tuple(t(c) for c in u2))
    for a, b in zip(jwo, pwo):
        _close(a, b, RTOL_SAMPLED, atol=1e-5)
    _close(jpdf, ppdf, RTOL_SAMPLED)
    assert float(pw.min()) == float(pw.max()) == 1.0


@pytest.mark.parametrize("name", ["teapot", "null_stack", "bitmap"])
def test_attenuated_transmittance_matches_jax(scenes, name, monkeypatch):
    """The segments=4 march of closest-hit casts: shadow rays from random
    points in and around the media toward random points, each lane starting
    in a random medium (so some march through an inconsistent boundary and
    zero), through the glass (blocked), the null sphere and, on the bitmap
    scene, the bitmap-opacity mask."""
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")
    js, _ = scenes[name]
    ps = _port(js)
    L = 1537
    rs, wav = _lanes(L, 6)
    lo, hi = {"teapot": ((-1.5, 0.0, -1.2), (3.0, 2.2, 1.6)),
              "null_stack": ((-1.0, -1.0, -0.5), (1.0, 1.0, 0.5)),
              "bitmap": ((-1.2, 0.05, -1.0), (1.2, 1.4, 1.0))}[name]
    p = rs.uniform(lo, hi, (L, 3)).T.astype(np.float32)
    q = rs.uniform(lo, hi, (L, 3)).T.astype(np.float32)
    if name == "null_stack":
        q[2] += 4.0
    dvec = q - p
    dist = np.linalg.norm(dvec, axis=0).astype(np.float32)
    d = (dvec / dist).astype(np.float32)
    n_media = int(js.media.kind.shape[0])
    ids = rs.integers(-1, n_media, L).astype(np.int32)
    want = jinteg._attenuated_transmittance(
        js, tuple(jnp.asarray(c) for c in p), tuple(jnp.asarray(c) for c in d),
        jnp.asarray(dist), jnp.asarray(ids), jnp.asarray(wav))
    got = pinteg._attenuated_transmittance(ps, tuple(t(c) for c in p), tuple(t(c) for c in d),
                                           t(dist), t(ids), t(wav))
    want = np.asarray(want)
    lit = want.max(axis=0) > 0
    assert 0.05 < lit.mean() < 0.95 or name == "null_stack", lit.mean()
    _close(want, got, RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# closed forms (tests/test_volpath.py, tests/test_grid_volume.py)
# ---------------------------------------------------------------------------

def _flat_mp(sigma_s, sigma_a, L):
    ss = torch.full((4, L), sigma_s)
    return {"sigma_s": ss, "sigma_t": ss + sigma_a, "g": torch.zeros(L),
            "vacuum": torch.zeros(L, dtype=torch.bool)}


def test_transmittance_closed_form():
    dist = torch.tensor([0.0, 0.5, 1.0, 2.0, 10.0])
    tr = pmed.eval_transmittance(_flat_mp(0.3, 0.7, 5), dist)
    np.testing.assert_allclose(n(tr), np.exp(-n(dist))[None, :] * np.ones((4, 1)), rtol=1e-5)


def test_distance_sampling_unbiased():
    """E[escape tr / pdf] = exp(-sigma_t T) and E[scatter sigma_s tr / pdf]
    = albedo (1 - exp(-sigma_t T)) (homogeneous.cpp:21-50)."""
    L = 50_000
    sigma_s, sigma_a, T = 0.4, 0.6, 1.3
    rs = np.random.default_rng(7)
    ms = pmed.sample_distance(_flat_mp(sigma_s, sigma_a, L),
                              t(rs.integers(0, 4, L).astype(np.int32)),
                              t(rs.random(L, dtype=np.float32)), torch.full((L,), T))
    ms = {k: n(v) for k, v in ms.items()}
    esc = np.where(~ms["scatter"], ms["tr"][0] / np.maximum(ms["pdf"], 1e-30), 0.0)
    assert abs(esc.mean() - np.exp(-T)) < 5e-3
    sct = np.where(ms["scatter"], sigma_s * ms["tr"][0] / np.maximum(ms["pdf"], 1e-30), 0.0)
    assert abs(sct.mean() - sigma_s * (1.0 - np.exp(-T))) < 5e-3


def test_hg_normalisation_and_sampling():
    """The HG pdf integrates to 1 over the sphere; sampled directions have
    the mean cosine g and weight 1."""
    for g in (0.0, 0.4, -0.6):
        mu = torch.linspace(-1.0, 1.0, 20001, dtype=torch.float64)
        pdf = n(pmed.hg_pdf(mu, torch.tensor(g, dtype=torch.float64)))
        assert abs(2.0 * np.pi * np.trapezoid(pdf, n(mu)) - 1.0) < 1e-3, g
    L = 100_000
    rs = np.random.default_rng(3)
    u2 = tuple(t(rs.random(L, dtype=np.float32)) for _ in range(2))
    z, o = torch.zeros(L), torch.ones(L)
    for g in (0.0, 0.5):
        wo, _, w = pmed.phase_sample((z, z, o), torch.full((L,), g), u2)
        assert abs(float(wo[2].mean()) - g) < 5e-3, g
        assert float(w.min()) == 1.0


def test_absorbing_slab_closed_form(scenes):
    """The port's volpath through the null slab of sigma_a 0.5 and
    thickness 2: the centre pixels are exp(-1) of the environment."""
    ps = pload(str(scenes["slab"][1]), device="cpu", spp=64)
    rgb = n(pdriver.render(ps, seed=0, depth_cap=8)["rgb"])
    assert np.isfinite(rgb).all()
    c = rgb[6:10, 6:10].mean()
    assert abs(c - np.exp(-1.0)) < 0.05 * np.exp(-1.0), c


def _trilinear64(grid, p):
    """misaki_tpu's cell-centred, border-clamped trilinear in float64 on a
    unit-cube point p (3, L)."""
    D, H, W = grid.shape
    f = [np.clip(p[0] * W - 0.5, 0, W - 1), np.clip(p[1] * H - 0.5, 0, H - 1),
         np.clip(p[2] * D - 0.5, 0, D - 1)]
    i0 = [np.floor(c).astype(np.int64) for c in f]
    w1 = [c - i for c, i in zip(f, i0)]
    i1 = [np.minimum(i + 1, s - 1) for i, s in zip(i0, (W, H, D))]
    out = np.zeros(p.shape[1])
    for zi, wz in ((i0[2], 1 - w1[2]), (i1[2], w1[2])):
        for yi, wy in ((i0[1], 1 - w1[1]), (i1[1], w1[1])):
            for xi, wx in ((i0[0], 1 - w1[0]), (i1[0], w1[0])):
                out += grid.astype(np.float64)[zi, yi, xi] * wx * wy * wz
    return out


def test_grid_density_float64_trilinear(scenes):
    """On a random float32 grid (one misaki_tpu would round to bfloat16),
    the port's float32 trilinear is within 1e-6 relative of float64; 0
    outside the box, 1 without a volume."""
    js, _ = scenes["grid_slab"]
    ps = _port(js)
    rs = np.random.default_rng(8)
    grid = rs.uniform(0.0, 1.0, (16, 16, 16)).astype(np.float32)
    ps = ps.replace(volumes=t(grid.reshape(-1)))
    L = 8192
    p = rs.uniform(0.0, 1.0, (3, L)).astype(np.float32)
    got = n(pmed.grid_density(ps, torch.zeros(L, dtype=torch.int32), tuple(t(c) for c in p)))
    want = _trilinear64(grid, p.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    out = (torch.full((L,), 2.0), t(p[1]), t(p[2]))
    assert float(pmed.grid_density(ps, torch.zeros(L, dtype=torch.int32), out).abs().max()) == 0
    none = pmed.grid_density(ps, torch.full((L,), -1, dtype=torch.int32), tuple(t(c) for c in p))
    assert float(none.min()) == float(none.max()) == 1.0


def test_grid_density_matches_jax(scenes):
    """On the gradient slab (densities (k + 0.5) / 16, exact in bfloat16,
    so misaki_tpu's bfloat16 fetch is exact there) the two trilinears
    agree, inside and outside the box."""
    js, _ = scenes["grid_slab"]
    ps = _port(js)
    rs = np.random.default_rng(9)
    L = 4099
    p = rs.uniform(-0.2, 1.2, (3, L)).astype(np.float32)
    ids = rs.integers(-1, 1, L).astype(np.int32)
    want = jmed.grid_density(js, jnp.asarray(ids), tuple(jnp.asarray(c) for c in p))
    got = pmed.grid_density(ps, t(ids), tuple(t(c) for c in p))
    _close(want, got, 1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# sample_volpath and whole renders
# ---------------------------------------------------------------------------

def test_sample_volpath_stage_matches_jax(scenes):
    """One teapot wavefront (48x27, 2 spp, depth cap 4) through
    sample_volpath in both packages on the same tables and PCG32 states:
    the states after it equal (the draw order: one channel draw, then nine
    per iteration), and the lanes' spectra within rtol 1e-4 on all but a
    share of lanes that a last-bit decision sent elsewhere."""
    js = jload(str(TEAPOT_XML), spp=2, width=48, height=27)
    ps = _port(js)
    lane = np.arange(48 * 27 * 2, dtype=np.uint32)
    jray, _, jstate = jdriver.primary_rays(js, jnp.asarray(lane), 5)
    pray, _, pstate = pdriver.primary_rays(ps, t(lane.astype(np.int64)), 5)
    want, jstate2 = jinteg.sample_volpath(js, jray, jstate, 4)
    got, pstate2 = pinteg.sample_volpath(ps, pray, pstate, 4)
    for k in ("hi", "lo", "inc_hi", "inc_lo"):
        np.testing.assert_array_equal(n(pstate2[k]), np.asarray(jstate2[k]).astype(np.int64))
    want, got = np.asarray(want, np.float64), n(got).astype(np.float64)
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=0)
    print(f"\nteapot sample_volpath: {off.mean():.4%} of {off.size} lanes off")
    assert want.max() > 0 and np.isfinite(got).all()
    assert off.mean() <= 0.01, off.mean()


RENDERS = {
    # name: (compile overrides, seed, depth cap)
    "slab": (dict(spp=8), 1, 6),
    "no_medium": (dict(spp=16), 0, 4),  # tests/test_volpath.py:174-194
    "grid_slab": (dict(spp=4, width=24, height=18), 3, 4),
    "bitmap": ({}, 4, 4),
    "teapot": (dict(spp=2, width=48, height=27), 5, 6),
}


@pytest.mark.parametrize("name", list(RENDERS))
def test_volpath_render_matches_jax(scenes, name, monkeypatch):
    """Whole volpath frames on the same tables under the golden criteria:
    the absorbing slab, volpath without media (tests/test_volpath.py's
    sphere under the environment), the grid slab, the bitmap scene (the
    texel fetch in material_params and the mask branch of the
    transmittance march) and the teapot stand-in at 48x27 x 2 spp."""
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")
    kw, seed, depth_cap = RENDERS[name]
    if name == "no_medium":
        xml = ABSORB_SLAB_XML.replace(
            ABSORB_SLAB_XML[ABSORB_SLAB_XML.index("<shape"):
                            ABSORB_SLAB_XML.index("</shape>") + len("</shape>")],
            '<shape type="sphere"><float name="radius" value="0.2"/><bsdf type="diffuse"/>'
            '</shape>')
        js = jcompile(jload_string(xml), **kw)
        ps_xml = compile_scene(load_string(xml), device="cpu", **kw)
        np.testing.assert_array_equal(n(ps_xml.geometry.face_tab),
                                      np.asarray(js.geometry.face_tab))
    else:
        js = scenes[name][0]
        if kw:
            js = jload(str(scenes[name][1]), **kw)
    ps = _port(js)
    want = np.asarray(jdriver.render(js, seed=seed, depth_cap=depth_cap)["rgb"])
    got = n(pdriver.render(ps, seed=seed, depth_cap=depth_cap)["rgb"])
    frac, mean_err = golden_criteria(got, want)
    print(f"\n{name}: {frac:.4%} of texels off, mean error {mean_err:.3e}")
    assert np.isfinite(got).all() and want.mean() > 0.01
    assert frac < 0.02 and mean_err < 1e-3, (frac, mean_err)
    if name == "no_medium":
        np.testing.assert_allclose(got[0, 0], (1.2047, 0.9484, 0.9087), atol=0.03)
