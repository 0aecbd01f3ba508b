"""The photon-mapping integrators (`sppm`, `photonmapper`) of the port
against misaki_tpu's, on the CPU: the settings, photon emission lane by
lane, the camera pass, one photon depth's density estimate, the glossy pair
sum, one iteration's state, whole renders, checkpoint / resume, progress
and the CLI.

Scenes: the port's cbox under misaki_tpu_torch/scenes/cbox/sppm.xml and
photonmapper.xml at 32x24 with 2048 photons (one PHOTON_BLOCK) and 2
iterations, depth budget 5 from the XML; the gallery (a point light, a
constant environment and glossy balls) and envlit (an envmap and a bitmap
floor) written small. misaki_tpu runs with MISAKI_FORCE_PAGED=1, as its own
texture tests run it (its texel fetch through the paged path's plain
reference).

Tolerances: the compiled settings are equal; emitter samples, camera-pass
values and visible points rtol 1e-5 (float32 chains of a few dozen
operations whose transcendental functions may differ in the last bit),
booleans equal. The density estimate's counts are equal and its flux sums
within rtol 1e-5 (the port's twin and misaki_tpu add the same products in
matmuls of another order). The glossy pair sum rtol 1e-4: per pair a
full BSDF evaluation, divided by a cosine, then summed in sub-blocks of
another size than misaki_tpu's 64 photons. An iteration's state rtol 1e-4
(the radius update takes a square root of a ratio of sums). Whole images
meet the golden criteria of tests/torch_helpers.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_driver import _cli, read_exr
from torch_helpers import SCENES, golden_criteria, n, t

from misaki_tpu.core import rng as jrng
from misaki_tpu.core import spectrum as jspec
from misaki_tpu.emitter import kernels as jem
from misaki_tpu.render import driver as jdriver
from misaki_tpu.render import ppm as jppm
from misaki_tpu.scene.compiler import compile_scene as jcompile
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu.scene.loader import load_string as jload_string
from misaki_tpu_torch.accel import traverse as ptr
from misaki_tpu_torch.core import rng as prng
from misaki_tpu_torch.core import spectrum as pspec
from misaki_tpu_torch.emitter import kernels as pem
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.render import integrator as pinteg
from misaki_tpu_torch.render import ppm as pppm
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.compiler import compile_scene
from misaki_tpu_torch.scene.compiler import load_and_compile as pload
from misaki_tpu_torch.scene.loader import load_string
from misaki_tpu_torch.scene.types import EM_AREA, EM_CONSTANT, EM_ENVMAP, EM_POINT
from misaki_tpu_torch.scenes.envlit import assets as envlit_assets
from misaki_tpu_torch.scenes.materials import assets as materials_assets
from misaki_tpu_torch.utils import tracing

CBOX = {name: SCENES / "cbox" / f"{name}.xml" for name in ("sppm", "photonmapper")}
SMALL = dict(width=32, height=24)
PHOTONS, ITERS, SEED = 2048, 2, 3
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _forced_paged(monkeypatch):
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")


def _port(js):
    return from_compiled(jax.tree_util.tree_map(np.asarray, js), device="cpu")


def _small(js):
    return js.replace(ppm_photons=PHOTONS, ppm_iterations=ITERS)


@pytest.fixture(scope="module")
def cbox():
    """{integrator: (misaki_tpu scene, port scene)} of the cbox XMLs at
    32x24, 2048 photons, 2 iterations."""
    out = {}
    for name, xml in CBOX.items():
        js = _small(jload(str(xml), **SMALL))
        out[name] = (js, _port(js))
    return out


@pytest.fixture(scope="module")
def extra_scenes(tmp_path_factory):
    """{name: (misaki_tpu scene, port scene)} of the gallery and envlit,
    written small, under sppm."""
    d = tmp_path_factory.mktemp("ppm")
    xmls = {"gallery": materials_assets.write_assets(d / "materials", res=32),
            "envlit": envlit_assets.write_assets(d / "envlit", sky_shape=(64, 128),
                                                 floor_res=64)}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISAKI_FORCE_PAGED", "1")
        for name, xml in xmls.items():
            js = jload(str(xml), width=16, height=12).replace(integrator="sppm", max_depth=2)
            out[name] = (js, _port(js))
    return out


def _close(want, got, rtol=RTOL, atol=1e-5):
    if isinstance(want, (tuple, list)):
        for w, g in zip(want, got):
            _close(w, g, rtol, atol)
        return
    w, g = np.asarray(want), n(got)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g.astype(w.dtype), w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _wavelengths(L, it, seed):
    """misaki_tpu's per-iteration hero wavelengths, one shared draw."""
    u, _ = jrng.next_float32(jrng.seed((jnp.uint32(0xA511E9B3), jnp.uint32(it)),
                                       (jnp.uint32(seed), jnp.uint32(7))))
    return jspec.sample_wavelength(jnp.full((L,), u))


# ---------------------------------------------------------------------------
# settings, budget, structure
# ---------------------------------------------------------------------------

PPM_XML = """<scene version="0.6.0">
  <integrator type="{integrator}">{props}</integrator>
  <sensor type="perspective"><float name="fov" value="40"/>
    <transform name="to_world"><lookat origin="0, 0, 4" target="0, 0, 0" up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="6"/></film>
  </sensor>
  <shape type="sphere"><bsdf type="diffuse"/></shape>
  <emitter type="constant"/>
</scene>
"""


@pytest.mark.parametrize("integrator,props", [
    ("sppm", ""),
    ("sppm", '<integer name="photons" value="5000"/><integer name="iterations" value="3"/>'
             '<float name="initial_radius" value="0.2"/>'),
    ("photonmapper", '<integer name="photon_count" value="300"/>'
                     '<float name="photon_radius" value="0.05"/>'),
])
def test_settings_compile_like_misaki_tpu(integrator, props):
    """ppm_photons, ppm_iterations and ppm_radius under every name
    misaki_tpu's compiler reads, with its defaults; carried by
    from_compiled and replace."""
    text = PPM_XML.format(integrator=integrator, props=props)
    js = jcompile(jload_string(text))
    ps = compile_scene(load_string(text), device="cpu")
    got = (ps.integrator, ps.ppm_photons, ps.ppm_iterations, ps.ppm_radius)
    assert got == (js.integrator, js.ppm_photons, js.ppm_iterations, js.ppm_radius)
    fc = _port(js)
    assert (fc.ppm_photons, fc.ppm_iterations, fc.ppm_radius) == got[1:]
    assert ps.replace(ppm_photons=7).ppm_photons == 7


def test_cbox_xmls(cbox):
    for name, xml in CBOX.items():
        ps = pload(str(xml), device="cpu")
        assert (ps.integrator, ps.ppm_photons, ps.ppm_iterations, ps.ppm_radius,
                ps.max_depth) == (name, 262144, 8, 0.0, 5)
        assert pppm.photon_count(ps) == 262144


@pytest.mark.parametrize("max_depth,cap", [(5, 16), (-1, 4), (9, 3), (1, 16)])
def test_budget_and_photon_count(cbox, max_depth, cap):
    js, ps = cbox["sppm"]
    assert pppm.depth_budget(ps.replace(max_depth=max_depth), cap) == jppm._depth_budget(
        js.replace(max_depth=max_depth), cap)
    for photons in (1, 2048, 2049, 262144):
        assert pppm.photon_count(ps.replace(ppm_photons=photons)) == \
            -(-photons // jppm.PHOTON_BLOCK) * jppm.PHOTON_BLOCK


@pytest.mark.parametrize("n_vps", [1, 768, 4096, 65536, 1 << 23])
def test_glossy_block(n_vps):
    """A power of two that divides every rounded photon count, with
    sub-block x visible points at most 2^22 where it can be."""
    g = pppm.glossy_block(n_vps, 262144)
    assert g & (g - 1) == 0 and 262144 % g == 0 and 2048 % g == 0
    assert g * n_vps <= max(pppm.GLOSSY_LANES, n_vps)
    assert g == pppm.PHOTON_BLOCK or 2 * g * n_vps > pppm.GLOSSY_LANES


@pytest.mark.parametrize("name,integrator", [
    ("cbox", "sppm"), ("cbox", "photonmapper"), ("envlit", "sppm"), ("envlit", "photonmapper"),
    ("gallery", "sppm"),
])
def test_launches_per_iteration(cbox, extra_scenes, name, integrator, monkeypatch):
    """The launches a frame makes on the card (`launches_per_iteration`),
    counted at their call sites on the CPU: per iteration D camera casts
    and D photon casts (closest hit), D shadow casts in sppm (any hit), D - 1
    density estimates in sppm (photon depths >= 1) and D in the
    photonmapper, and the texel fetches of envlit's bitmap and envmap and
    the gallery's bitmap roughness."""
    from misaki_tpu_torch.render import texel_fetch as ptf

    if name == "cbox":
        ps = cbox[integrator][1]
    else:
        ps = extra_scenes[name][1].replace(integrator=integrator, ppm_photons=2048,
                                           ppm_iterations=2, max_depth=3)
    calls = {"closest": 0, "anyhit": 0, "density": 0, "fetch": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ptr, "intersect", counting("closest", ptr.intersect))
    monkeypatch.setattr(ptr, "ray_test", counting("anyhit", ptr.ray_test))
    monkeypatch.setattr(pppm, "density_estimate", counting("density", pppm.density_estimate))
    monkeypatch.setattr(ptf, "fetch4_plain", counting("fetch", ptf.fetch4_plain))
    pdriver.render(ps, seed=1)
    D, it = pppm.depth_budget(ps, 16), ps.ppm_iterations
    sppm = integrator == "sppm"
    want = pppm.launches_per_iteration(ps, D)
    assert calls == {k: it * v for k, v in want.items()}
    assert want["closest"] == 2 * D and want["anyhit"] == (D if sppm else 0)
    assert want["density"] == (D - 1 if sppm else D)
    assert (want["fetch"] > 0) == (name != "cbox")


def test_radiance_names_render_ppm(cbox):
    _, ps = cbox["sppm"]
    for integrator in ("sppm", "photonmapper"):
        with pytest.raises(NotImplementedError, match="render_ppm"):
            pinteg.radiance(ps, None, None, integrator)


# ---------------------------------------------------------------------------
# photon emission
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kinds", [
    ("cbox", {EM_AREA}), ("gallery", {EM_POINT, EM_CONSTANT}), ("envlit", {EM_ENVMAP}),
])
def test_sample_emitter_ray(cbox, extra_scenes, name, kinds):
    """Emitter::sample_ray lane by lane: area (cbox), point and constant
    (the gallery), envmap (envlit, through the texel fetch)."""
    js, ps = cbox["sppm"] if name == "cbox" else extra_scenes[name]
    assert set(ps.emitter_kinds) == kinds
    L = 4096
    rs = np.random.default_rng(11)
    u = rs.uniform(0, 1, (5, L)).astype(np.float32)
    jw, _ = jspec.sample_wavelength(jnp.asarray(u[0]))
    pw = t(np.asarray(jw))
    want = jem.sample_emitter_ray(js, jw, jnp.asarray(u[0]), (jnp.asarray(u[1]), jnp.asarray(u[2])),
                                  (jnp.asarray(u[3]), jnp.asarray(u[4])),
                                  jem.radiance_all(js, jw))
    got = pem.sample_emitter_ray(ps, pw, t(u[0]), (t(u[1]), t(u[2])), (t(u[3]), t(u[4])),
                                 pem.radiance_all(ps, pw))
    for k in ("o", "d", "n", "flux", "valid"):
        _close(want[k], got[k], rtol=1e-4 if name == "envlit" else RTOL, atol=1e-4)
    valid = n(got["valid"])
    assert valid.mean() > 0.5 and np.isfinite(n(got["flux"])).all()


# ---------------------------------------------------------------------------
# the camera pass, density estimation, the glossy pair sum
# ---------------------------------------------------------------------------

def _camera_both(js, ps, sppm_mode, it=1):
    L = ps.film_width * ps.film_height
    jw, jww = _wavelengths(L, it, SEED)
    budget = pppm.depth_budget(ps, 16)
    want = jppm._camera_pass(js, jnp.uint32(it), jnp.uint32(SEED), jw, jww, budget, sppm_mode,
                             jem.radiance_all(js, jw))
    pw = t(np.asarray(jw))
    got = pppm._camera_pass(ps, it, SEED, pw, budget, sppm_mode, pem.radiance_all(ps, pw))
    return want, got


VP_KEYS = ("p", "wi", "n", "beta", "rho", "valid", "glossy")


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_camera_pass(cbox, integrator):
    """Emitted, environment and (sppm) NEE radiance, the visible-point record
    and primary hits of one iteration's camera pass."""
    js, ps = cbox[integrator]
    (jv, jvp, jhit), (pv, pvp, phit) = _camera_both(js, ps, integrator == "sppm")
    _close(jv, pv)
    for k in VP_KEYS:
        _close(jvp[k], pvp[k])
    _close(jhit, phit)
    assert n(pvp["valid"]).mean() > 0.5 and n(pv).max() > 0.0


@pytest.fixture(scope="module")
def gallery_vps(extra_scenes):
    """The gallery's camera pass under sppm at depth budget 2: glossy
    visible points parked at the depth cap with their materials."""
    js, ps = extra_scenes["gallery"]
    return _camera_both(js, ps, True)


def test_camera_pass_glossy_visible_points(gallery_vps):
    (jv, jvp, jhit), (pv, pvp, phit) = gallery_vps
    _close(jv, pv)
    for k in VP_KEYS:
        _close(jvp[k], pvp[k])
    glossy = n(pvp["glossy"])
    assert glossy.sum() > 0 and (n(pvp["rho"])[:, glossy] == 0).all()
    for k in ("reflectance", "alpha_u", "alpha_v", "eta", "spec_refl", "k_spec"):
        _close(jvp["mat"][k], pvp["mat"][k])


def _photons(rs, vp_p, P, spread, facing=None):
    """P photons scattered around the visible points at vp_p (3, N), flux
    random, a fifth dead; incoming directions random on the sphere, and so
    are the normals, or with `facing` (3, N) near the direction of the
    visible point each photon lies by."""
    near = rs.integers(0, vp_p.shape[1], P)
    p = (vp_p[:, near] + rs.normal(0.0, spread, (3, P))).astype(np.float32)

    def unit(v):
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    nrm = rs.normal(size=(3, P))
    if facing is not None:
        nrm = facing[:, near] + 0.3 * nrm
    return {"p": p, "wi": unit(rs.normal(size=(3, P))), "n": unit(nrm),
            "flux": rs.uniform(0.0, 2.0, (4, P)).astype(np.float32),
            "ok": rs.uniform(size=P) < 0.8}


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_density_estimate(cbox, integrator):
    """One photon depth's density estimate (the plain twin, the CPU path)
    against misaki_tpu's _density_blocks on the camera pass's visible points
    and 4096 photons around them (two blocks)."""
    js, ps = cbox[integrator]
    sppm_mode = integrator == "sppm"
    (_, jvp, _), (_, pvp, _) = _camera_both(js, ps, sppm_mode)
    rs = np.random.default_rng(5)
    vp_p = np.stack([n(c) for c in pvp["p"]])
    ph = _photons(rs, vp_p, 4096, 8.0)
    r2 = (rs.uniform(15.0, 35.0, vp_p.shape[1]) ** 2).astype(np.float32)

    def j3(x):
        return tuple(jnp.asarray(c) for c in x)

    def p3(x):
        return tuple(t(c) for c in x)

    want = jppm._density_blocks(jvp, jnp.asarray(r2), j3(ph["p"]), j3(ph["wi"]), j3(ph["n"]),
                                j3(ph["flux"]), jnp.asarray(ph["ok"]), sppm_mode)
    before = tracing.launches["density"]
    got = pppm.density_estimate(pvp, t(r2), p3(ph["p"]), p3(ph["wi"]), p3(ph["n"]),
                                t(ph["flux"]), t(ph["ok"]), sppm_mode)
    assert tracing.launches["density"] == before   # the CPU takes the twin
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert n(got[1]).sum() > 500
    scale = float(np.abs(np.asarray(want[0])).max())
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=RTOL, atol=1e-6 * scale)


def test_density_glossy(gallery_vps):
    """The glossy pair sum (full BSDF per pair) against misaki_tpu's
    _density_blocks_glossy on the gallery's visible points and 2048 photons
    around them: photon shading frames from random normals, local incoming
    directions in the upper hemisphere."""
    from misaki_tpu.core import frame as jframe
    from misaki_tpu_torch.core import frame as pframe

    (_, jvp, _), (_, pvp, _) = gallery_vps
    rs = np.random.default_rng(9)
    glossy = n(pvp["glossy"])
    vp_p = np.stack([n(c) for c in pvp["p"]])[:, glossy]
    ph = _photons(rs, vp_p, 2048, 0.05, facing=np.stack([n(c) for c in pvp["wi"]])[:, glossy])
    wl = ph["wi"].copy()
    wl[2] = np.abs(wl[2])
    r2 = np.full(glossy.shape[0], 0.08 ** 2, np.float32)
    jsh = jframe.make_frame(tuple(jnp.asarray(c) for c in ph["n"]))
    psh = pframe.make_frame(tuple(t(c) for c in ph["n"]))
    want = jppm._density_blocks_glossy(
        jvp, jnp.asarray(r2), tuple(jnp.asarray(c) for c in ph["p"]), jsh,
        tuple(jnp.asarray(c) for c in wl), tuple(jnp.asarray(c) for c in ph["flux"]),
        jnp.asarray(ph["ok"]))
    got = pppm._density_glossy(pvp, t(r2), tuple(t(c) for c in ph["p"]), psh,
                               tuple(t(c) for c in wl), t(ph["flux"]), t(ph["ok"]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert n(got[1]).sum() > 200
    scale = float(np.abs(np.asarray(want[0])).max())
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=1e-4, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# an iteration, whole renders, checkpoint, progress, the CLI
# ---------------------------------------------------------------------------

def _state(L, r0):
    return {"value": np.zeros((3, L), np.float32), "tau": np.zeros((3, L), np.float32),
            "n": np.zeros(L, np.float32), "radius": np.full(L, r0, np.float32),
            "alpha": np.zeros(L, np.float32), "iters": np.zeros((), np.float32)}


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_iteration_state(cbox, integrator):
    """One iteration from a state with radii of 20 and some counts: value,
    tau, n, radius, alpha, iters."""
    js, ps = cbox[integrator]
    L = ps.film_width * ps.film_height
    st = _state(L, 20.0)
    st["n"][:] = np.random.default_rng(2).uniform(0, 5, L).astype(np.float32)
    budget = pppm.depth_budget(ps, 16)
    want = jppm._ppm_iteration(js, {k: jnp.asarray(v) for k, v in st.items()}, jnp.uint32(1),
                               jnp.uint32(SEED), budget, integrator == "sppm")
    got = pppm.ppm_iteration(ps, {k: t(v) for k, v in st.items()}, 1, SEED, budget,
                             integrator == "sppm")
    for k in st:
        scale = float(np.abs(np.asarray(want[k])).max())
        np.testing.assert_allclose(n(got[k]), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)
    assert float(np.asarray(want["tau"]).max()) > 0.0


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_render_matches_misaki_tpu(cbox, integrator):
    """The slice as a whole: both packages' render() on the same tables,
    seed and depth cap, under the golden criteria."""
    js, ps = cbox[integrator]
    want = np.asarray(jdriver.render(js, seed=SEED, depth_cap=16)["rgb"])
    out = pdriver.render(ps, seed=SEED)
    got = n(out["rgb"])
    assert out["film"] is None and got.shape == want.shape == (24, 32, 3)
    frac_off, mean_err = golden_criteria(got, want)
    assert frac_off < 0.02 and mean_err < 1e-3, (frac_off, mean_err)
    assert np.isfinite(got).all() and got.mean() > 0.01
    alpha = n(out["alpha"])
    assert 0.7 < alpha.mean() <= 1.0


def test_checkpoint_resume_and_progress(cbox, tmp_path):
    """A 4-iteration render stopped by its progress callback after
    iteration 3 and resumed from the per-iteration snapshot equals the
    uninterrupted render to the bit; progress sees every iteration; the
    snapshot of another seed is ignored; the snapshot goes at the end."""
    ps = cbox["sppm"][1].replace(ppm_iterations=4)
    seen = []
    ref = pdriver.render(ps, seed=4, progress=lambda d, tot: seen.append((d, tot)))
    assert seen == [(i, 4) for i in range(1, 5)]
    ck = str(tmp_path / "ppm.npz")

    def stop(done, total):
        if done == 3:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        pdriver.render(ps, seed=4, checkpoint_path=ck, checkpoint_every=1, progress=stop)
    with np.load(ck) as data:
        assert int(data["next_it"]) == 2   # the snapshot before the stop
    other = pdriver.render(ps, seed=5, checkpoint_path=ck, checkpoint_every=1)
    assert not torch.equal(other["rgb"], ref["rgb"])
    with pytest.raises(KeyboardInterrupt):
        pdriver.render(ps, seed=4, checkpoint_path=ck, checkpoint_every=1, progress=stop)
    seen = []
    out = pdriver.render(ps, seed=4, checkpoint_path=ck, checkpoint_every=1,
                         progress=lambda d, tot: seen.append(d))
    assert seen == [3, 4]
    assert torch.equal(out["rgb"], ref["rgb"]) and torch.equal(out["alpha"], ref["alpha"])
    assert not (tmp_path / "ppm.npz").exists()


def test_cli_renders_photonmapper(tmp_path):
    """The CLI on the CPU with --seed, --depth, --checkpoint: a PNG and an
    EXR of the render's pixels."""
    xml = tmp_path / "pm.xml"
    xml.write_text(open(CBOX["photonmapper"]).read()
                   .replace('value="262144"', 'value="2048"')
                   .replace('name="iterations" value="8"', 'name="iterations" value="2"'))
    flags = ["--device", "cpu", "--width", 16, "--height", 12, "--seed", 2, "--depth", 3,
             "--checkpoint", tmp_path / "ck.npz", "--checkpoint-every", 1]
    _cli(xml, "-o", tmp_path / "pm.exr", *flags, cwd=tmp_path)
    _cli(xml, "-o", tmp_path / "pm.png", *flags, cwd=tmp_path)
    assert (tmp_path / "pm.png").stat().st_size > 0 and not (tmp_path / "ck.npz").exists()
    scene = pload(str(xml), device="cpu", width=16, height=12)
    want = pdriver.render(scene, seed=2, depth_cap=3)
    got = read_exr(tmp_path / "pm.exr")
    for i, c in enumerate("RGB"):
        np.testing.assert_array_equal(got[c], n(want["rgb"])[..., i])
    np.testing.assert_array_equal(got["A"], n(want["alpha"]))
