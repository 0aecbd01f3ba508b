"""The port's gradients (misaki_tpu_torch.diff) against `jax.grad` of the same
renders in misaki_tpu, and the port's own checks of tests/test_diff_leaves.py
and tests/test_diff_and_sharding.py.

Scenes: the env-lit quad with an 8x16 .hdr, the 8x8 bitmap floor and the
rough-conductor and rough-dielectric quads of tests/test_diff_leaves.py, and
the port's Cornell box at 16x12 x 8 spp with depth cap 2. Both packages
render the same tables (`from_compiled`) with leaf values drawn by numpy from
a fixed seed, carried across with `leaves_from_jax` / `grads_to_jax`, and
the loss is the image mean, as in the JAX tests.

Bounds: each leaf's relative L1 `sum|port - jax| / sum|jax|` <= 5e-3 (float32
chains whose last bits differ between the libraries, summed in another
order), `bitmaps` <= 2e-2: misaki_tpu's differentiable bitmap fetch takes
bf16 operands (misaki_tpu/core/table.py:44-58), the port's float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_grid_volume import CUBE_OBJ, SCENE_XML as GRID_XML
from torch_helpers import CBOX_XML, SCENES, n, t

from misaki_tpu.diff import get_leaves as jget
from misaki_tpu.diff import leaf_names as jleaf_names
from misaki_tpu.diff import replace_leaves as jreplace
from misaki_tpu.parallel import sharding as jsharding
from misaki_tpu.render.driver import render as jrender
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu_torch.diff import get_leaves, leaf_names, replace_leaves
from misaki_tpu_torch.diff.backprop import image_grads
from misaki_tpu_torch.diff.train import DEFAULT_TRAIN_LEAVES, lever_direction, train_step
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.scene import from_compiled, grads_to_jax, leaves_from_jax
from misaki_tpu_torch.scene.types import MC_ALPHA_U, MC_ALPHA_V, MC_ETA
from misaki_tpu_torch.utils import tracing

REL_L1 = 5e-3
REL_L1_BITMAPS = 2e-2
TEAPOT_XML = SCENES / "teapot" / "scene.xml"
MEDIA_LEAVES = ("sigma_s_amp", "sigma_a_amp", "medium_scale", "volumes")

ENV_XML = """<scene version="0.6.0">
  <integrator type="path"><integer name="max_depth" value="2"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="4"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="16"/>
      <integer name="height" value="12"/>
      <rfilter type="gaussian"/>
    </film>
  </sensor>
  <emitter type="envmap">
    <string name="filename" value="env.hdr"/>
    <float name="scale" value="1.0"/>
  </emitter>
  <shape type="obj">
    <string name="filename" value="quad.obj"/>
    <bsdf type="diffuse"/>
  </shape>
</scene>
"""

BITMAP_XML = """<scene version="0.6.0">
  <integrator type="path"><integer name="max_depth" value="2"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 0.8, 2.5" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="16"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="24"/>
      <integer name="height" value="18"/>
    </film>
  </sensor>
  <emitter type="constant"><spectrum name="radiance" value="0.00936329"/></emitter>
  <shape type="obj">
    <string name="filename" value="floor.obj"/>
    <bsdf type="diffuse">
      <texture type="bitmap" name="reflectance">
        <string name="filename" value="tex.hdr"/>
      </texture>
    </bsdf>
  </shape>
</scene>
"""

ROUGH_XML = """<scene version="0.6.0">
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="60"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sample_count" value="8"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="16"/>
      <integer name="height" value="12"/>
    </film>
  </sensor>
  <emitter type="constant"><spectrum name="radiance" value="0.01"/></emitter>
  <shape type="obj">
    <string name="filename" value="quad.obj"/>
    <bsdf type="{bsdf}">
      <float name="alpha" value="0.3"/>
      <string name="distribution" value="ggx"/>
    </bsdf>
  </shape>
</scene>
"""

# the quads of tests/test_envmap.py (facing down: the env-lit image is the
# sky) and tests/test_diff_leaves.py (facing the camera)
QUAD_DOWN_OBJ = "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nf 1 2 3\nf 1 3 4\n"
QUAD_UP_OBJ = "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\nf 1 3 2\nf 1 4 3\n"
FLOOR_OBJ = ("v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
             "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nf 1/1 3/3 2/2\nf 1/1 4/4 3/3\n")


def write_flat_hdr(path, rgb):
    """Flat (non-RLE) Radiance RGBE file (tests/test_envmap.py's writer)."""
    H, W, _ = rgb.shape
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode()
    m = rgb.max(axis=-1)
    exp = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, 2.0 ** (8.0 - exp), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    e8 = np.where(m > 1e-32, exp + 128, 0).astype(np.uint8)
    path.write_bytes(header + np.concatenate([mant, e8[..., None]], axis=-1).tobytes())


class Case:
    """One scene in both packages with seeded leaf values; the JAX and the
    port's gradients of the image mean, each computed once."""

    def __init__(self, js, names, values, seed, depth_cap, diff_mode=False):
        self.names, self.seed, self.depth_cap = names, seed, depth_cap
        self.js = js.replace(diff_mode=diff_mode)
        self.values = {k: np.asarray(v, np.float32) for k, v in values.items()}
        base = from_compiled(jax.tree_util.tree_map(np.asarray, js), device="cpu")
        self.ps = replace_leaves(base.replace(diff_mode=diff_mode),
                                 {k: t(v) for k, v in leaves_from_jax(self.values).items()})
        self._jax = self._port = None

    def jax_loss(self, values):
        img = jrender(jreplace(self.js, values), seed=self.seed, depth_cap=self.depth_cap)
        return jnp.mean(img["rgb"])

    def jax_grads(self):
        if self._jax is None:
            g = jax.jit(jax.grad(self.jax_loss))({k: jnp.asarray(v)
                                                   for k, v in self.values.items()})
            self._jax = {k: np.asarray(v) for k, v in g.items()}
        return self._jax

    def port(self):
        """-> (loss, {leaf: gradient in JAX's layout})."""
        if self._port is None:
            loss, _, g = image_grads(self.ps, self.names, lambda rgb: rgb.mean(),
                                     seed=self.seed, depth_cap=self.depth_cap)
            self._port = (float(loss), grads_to_jax(g))
        return self._port

    def port_loss(self, values):
        """The port's image mean at the leaf values {name: array in JAX's
        layout}."""
        sc = replace_leaves(self.ps, {k: t(v) for k, v in leaves_from_jax(values).items()})
        out = pdriver.render(sc, seed=self.seed, depth_cap=self.depth_cap)
        return float(out["rgb"].double().mean())


def live_coeff(rs, e):
    """(e, 3) radiance sigmoid coefficients in the sigmoid's live range
    (the compiler's are saturated, (0, 0, 1e5), where the gradient is
    float32 noise)."""
    return np.stack([rs.normal(0.0, 1e-6, e), rs.normal(0.0, 1e-3, e),
                     rs.uniform(-0.5, 0.5, e)], axis=1).astype(np.float32)


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("diff")
    rs = np.random.default_rng(7)
    (tmp / "quad_down.obj").write_text(QUAD_DOWN_OBJ)
    (tmp / "quad.obj").write_text(QUAD_UP_OBJ)
    (tmp / "floor.obj").write_text(FLOOR_OBJ)
    write_flat_hdr(tmp / "env.hdr", rs.uniform(0.2, 1.0, (8, 16, 3)).astype(np.float32))
    write_flat_hdr(tmp / "tex.hdr", rs.uniform(0.1, 0.9, (8, 8, 3)).astype(np.float32))

    def scene(name, xml):
        (tmp / name).write_text(xml)
        return jload(str(tmp / name))

    out = {}
    js = scene("env.xml", ENV_XML.replace("quad.obj", "quad_down.obj"))
    env = np.asarray(js.emitters.env_rgb)
    out["env"] = Case(js, ("env_rgb",),
                      {"env_rgb": env * rs.uniform(0.5, 1.5, env.shape)}, seed=1, depth_cap=2)
    js = scene("bitmap.xml", BITMAP_XML)
    leaves = {k: np.asarray(v) for k, v in jget(js, ("bitmaps", "rad_curve")).items()}
    leaves["bitmaps"] = leaves["bitmaps"] * rs.uniform(0.5, 1.5, leaves["bitmaps"].shape)
    out["bitmap"] = Case(js, ("bitmaps", "rad_curve"), leaves, seed=1, depth_cap=2)
    for bsdf in ("roughconductor", "roughdielectric"):
        js = scene(f"{bsdf}.xml", ROUGH_XML.format(bsdf=bsdf))
        leaves = {k: np.asarray(v) for k, v in jget(js, ("materials",)).items()}
        leaves["rad_coeff"] = live_coeff(rs, js.n_emitters)
        out[bsdf] = Case(js, ("materials", "rad_coeff"), leaves, seed=0, depth_cap=2,
                         diff_mode=True)
    js = jload(str(CBOX_XML), spp=8, width=16, height=12)
    leaves = {k: np.asarray(v) for k, v in jget(js, DEFAULT_TRAIN_LEAVES).items()}
    leaves["rad_curve"] = leaves["rad_curve"] * rs.uniform(0.8, 1.2, leaves["rad_curve"].shape)
    leaves["rad_coeff"] = live_coeff(rs, js.n_emitters)
    out["cbox"] = Case(js, DEFAULT_TRAIN_LEAVES, leaves, seed=0, depth_cap=2)
    # volpath: the teapot stand-in's two media at seeded amplitudes and
    # scales, and the grid slab of tests/test_grid_volume.py with spectral
    # sigma_a (tests/test_diff_leaves.py:177-240) at its compiled densities
    # (k + 0.5) / 8, which bfloat16 holds exactly
    js = jload(str(TEAPOT_XML), spp=4, width=16, height=12)
    leaves = {k: np.asarray(v) * rs.uniform(0.8, 1.2, np.shape(v))
              for k, v in jget(js, MEDIA_LEAVES[:3]).items()}
    out["teapot_media"] = Case(js, MEDIA_LEAVES[:3], leaves, seed=1, depth_cap=3)
    (tmp / "cube.obj").write_text(CUBE_OBJ)
    x = (np.arange(8) + 0.5) / 8
    np.save(tmp / "grid.npy", np.broadcast_to(x[None, None, :], (8, 8, 8)).astype(np.float32))
    xml = (GRID_XML % {"sa": 4.0}).replace('value="4.0, 4.0, 4.0"', 'value="2.0, 4.0, 8.0"')
    (tmp / "grid.xml").write_text(xml)
    js = jload(str(tmp / "grid.xml"), spp=4, width=16, height=12)
    out["grid"] = Case(js, ("volumes",), {"volumes": np.asarray(js.volumes)}, seed=2,
                       depth_cap=3)
    return out


@pytest.mark.parametrize("name", ["env", "bitmap", "roughconductor", "roughdielectric", "cbox",
                                  "teapot_media", "grid"])
def test_grads_match_jax(cases, name, capsys):
    """Every leaf's gradient against jax.grad of the same render, and every
    gradient finite; prints each leaf's relative L1. `volumes` is held to
    the bitmaps' bound: misaki_tpu's density fetch takes bfloat16 operands
    (misaki_tpu/render/medium.py:140, `table.fetch_lowp`), so its cotangent
    into the grid is rounded to bfloat16, the port's is float32."""
    case = cases[name]
    want = case.jax_grads()
    _, got = case.port()
    errs = {k: rel_l1(got[k], want[k]) for k in case.names}
    with capsys.disabled():
        print(f"\n{name}: relative L1 against jax.grad "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    for k in case.names:
        assert got[k].shape == want[k].shape, k
        assert np.isfinite(got[k]).all(), k
        assert np.abs(want[k]).sum() > 0, k
        bound = REL_L1_BITMAPS if k in ("bitmaps", "volumes") else REL_L1
        assert errs[k] <= bound, f"{name} {k}: relative L1 {errs[k]:.3e} > {bound}"


@pytest.mark.parametrize("name, leaf, step", [("env", "env_rgb", 0.05),
                                              ("bitmap", "bitmaps", 0.02)])
def test_texel_gradient_matches_fd(cases, name, leaf, step):
    """The image is linear in the env and bitmap texels at a fixed seed, so
    the directional central difference along sign(g) matches g . d within
    5% (tests/test_diff_leaves.py)."""
    case = cases[name]
    _, g = case.port()
    d = np.sign(g[leaf]) * step
    v0 = case.values[leaf]
    plus = case.port_loss({**case.values, leaf: v0 + d})
    minus = case.port_loss({**case.values, leaf: v0 - d})
    fd = (plus - minus) / 2.0
    expected = float(np.sum(g[leaf].astype(np.float64) * d))
    assert expected > 0
    assert abs(fd - expected) <= 0.05 * abs(expected), (fd, expected)


def test_reflectance_gradient_matches_fd(cases):
    """cbox materials: the directional FD over the top-8 gradient entries,
    each step divided by its sigmoid coefficient's lever arm, within 10%
    (tests/test_diff_and_sharding.py:52-67)."""
    case = cases["cbox"]
    _, g = case.port()
    gm = g["materials"]
    dc = lever_direction(gm)
    v0 = case.values["materials"]
    fd = (case.port_loss({**case.values, "materials": v0 + dc})
          - case.port_loss({**case.values, "materials": v0 - dc})) / 2.0
    expected = float(np.sum(gm.astype(np.float64) * dc))
    assert expected > 0
    assert abs(fd - expected) <= 0.1 * max(abs(fd), abs(expected)), (fd, expected)


@pytest.mark.parametrize("leaf", MEDIA_LEAVES)
def test_media_gradient_matches_fd(cases, leaf):
    """Each media leaf's autograd gradient against a directional central
    difference along sign(g), within 10%, on the medium's transmittance:
    the sum of `_attenuated_transmittance` over shadow rays crossing the
    teapot's media (the amplitudes and scales), and of `transmittance_ray`
    through the grid slab (the densities). A frame is no such check: at a
    fixed seed its estimator is piecewise constant in sigma (a lane's
    scatter-or-escape decision flips), and the pathwise gradient, which
    misaki_tpu takes too, leaves the flips out (tests/test_diff_leaves.py:
    177-190)."""
    from misaki_tpu_torch.render import integrator as pinteg
    from misaki_tpu_torch.render import medium as pmed

    case = cases["grid" if leaf == "volumes" else "teapot_media"]
    rs = np.random.default_rng(12)
    L = 2048
    wav = t(rs.uniform(360.0, 830.0, (4, L)).astype(np.float32))
    if leaf == "volumes":
        o = (t(np.full(L, -0.2, np.float32)), t(rs.uniform(0.1, 0.9, L).astype(np.float32)),
             t(rs.uniform(0.1, 0.9, L).astype(np.float32)))
        d = (torch.ones(L), torch.zeros(L), torch.zeros(L))
        ids = torch.zeros(L, dtype=torch.int32)

        def f(sc):
            mp = pmed.fetch_medium(sc, ids, wav)
            return pmed.transmittance_ray(sc, mp, ids, o, d, torch.full((L,), 1.6)).sum()
    else:
        # from around each medium toward the far side of it, starting in it
        centre = np.array([[0.0, 1.0, 0.0], [1.9, 0.6, 0.6]])[rs.integers(0, 2, L)]
        radius = np.where(centre[:, 0] > 1.0, 0.6, 1.0)[:, None]
        a = rs.normal(size=(L, 3))
        b = rs.normal(size=(L, 3))
        p = centre + 0.8 * radius * a / np.linalg.norm(a, axis=1, keepdims=True)
        q = centre + 0.8 * radius * b / np.linalg.norm(b, axis=1, keepdims=True)
        dist = np.linalg.norm(q - p, axis=1)
        dn = (q - p) / dist[:, None]
        ids = t(np.where(centre[:, 0] > 1.0, 1, 0).astype(np.int32))
        pt = tuple(t(c.astype(np.float32)) for c in p.T)
        dt = tuple(t(c.astype(np.float32)) for c in dn.T)

        def f(sc):
            return pinteg._attenuated_transmittance(sc, pt, dt, t(dist.astype(np.float32)),
                                                    ids, wav).sum()

    v0 = {leaf: t(leaves_from_jax({leaf: case.values[leaf]})[leaf])}
    x = v0[leaf].clone().requires_grad_()
    f(replace_leaves(case.ps, {leaf: x})).backward()
    g = n(x.grad).astype(np.float64)
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    step = np.sign(g) * (0.01 if leaf == "volumes" else 0.01 * np.abs(n(v0[leaf])))

    def at(sign):
        with torch.no_grad():
            v = t((n(v0[leaf]) + sign * step).astype(np.float32))
            return float(f(replace_leaves(case.ps, {leaf: v})))

    fd = (at(1) - at(-1)) / 2.0
    expected = float(np.sum(g * step))
    assert expected > 0
    assert abs(fd - expected) <= 0.1 * abs(expected), (fd, expected)


def test_alpha_gradient_only_in_diff_mode(cases):
    """Microfacet alpha: exactly 0 outside diff_mode, non-zero in it."""
    case = cases["roughconductor"]
    rows = list(range(MC_ALPHA_U, MC_ALPHA_V + 9))
    _, g_diff = case.port()
    assert np.isfinite(g_diff["materials"]).all()
    assert np.abs(g_diff["materials"][rows]).max() > 0.0, "diff_mode must attach alpha"
    perf = case.ps.replace(diff_mode=False)
    _, _, g_perf = image_grads(perf, ("materials",), lambda rgb: rgb.mean(), seed=case.seed,
                               depth_cap=case.depth_cap)
    assert n(g_perf["materials"])[rows].max() == 0.0
    assert n(g_perf["materials"])[rows].min() == 0.0, "alpha must stay detached"


def test_eta_gradient_flows(cases):
    """A rough dielectric's eta carries gradient in diff_mode."""
    _, g = cases["roughdielectric"].port()
    assert np.isfinite(g["materials"]).all()
    assert np.abs(g["materials"][MC_ETA]).max() > 0.0


def test_two_pass_equals_whole_frame_autograd(cases):
    """image_grads against one autograd graph of the whole frame, film and
    loss included (rtol 1e-5): in one pass (the frame fits a chunk) and in
    two (a primal, then a chunked re-render)."""
    case = cases["cbox"]
    ps = case.ps
    leaves = {k: v.detach().clone().requires_grad_() for k, v in get_leaves(
        ps, case.names).items()}
    sc = replace_leaves(ps, leaves)
    W, H, spp = sc.film_width, sc.film_height, sc.spp
    film = film_mod.new_film_flat(H, W, 5, sc.filter_type, sc.filter_stddev)
    pdriver._render_chunk(sc, film, 0, W * H * spp, case.seed, W * H * spp, case.depth_cap)
    rgb, _ = film_mod.develop(film_mod.film_from_flat(film, H, W, sc.filter_type,
                                                      sc.filter_stddev))
    loss = rgb.mean()
    loss.backward()
    _, got = case.port()
    want = grads_to_jax({k: v.grad for k, v in leaves.items()})
    for k in case.names:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[k]).max())
    # small chunks give the same gradient: the film is the sum of its chunks
    _, _, g_small = image_grads(ps, case.names, lambda r: r.mean(), seed=case.seed,
                                depth_cap=case.depth_cap, chunk_size=200)
    for k, v in grads_to_jax(g_small).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5 * np.abs(want[k]).max())


@pytest.mark.parametrize("name", ["env", "bitmap"])
def test_one_pass_equals_two_passes(cases, name):
    """Through the texel fetch's backward: image_grads of a frame that fits
    one chunk runs no primal, and gives the loss, image and gradients of the
    two-pass route (a primal, then 200-lane chunks) to rtol 1e-5."""
    ps, case = cases[name].ps, cases[name]
    runs = []
    for chunk in (1 << 20, 200):
        stats = {}
        runs.append((*image_grads(ps, case.names, lambda r: r.mean(), seed=case.seed,
                                  depth_cap=case.depth_cap, chunk_size=chunk, stats=stats),
                     stats))
    (l1, rgb1, g1, st1), (l2, rgb2, g2, st2) = runs
    assert st1["chunks"] == 1 and st1["primal_s"] == 0.0
    assert st2["chunks"] > 1 and st2["primal_s"] > 0.0
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    np.testing.assert_allclose(n(rgb1), n(rgb2), rtol=1e-5, atol=1e-6)
    for k in case.names:
        assert np.isfinite(n(g1[k])).all(), k
        np.testing.assert_allclose(n(g1[k]), n(g2[k]), rtol=1e-5,
                                   atol=1e-5 * np.abs(n(g2[k])).max())


def test_train_step_matches_sharded(cases):
    """train_step against misaki_tpu's train_step_sharded on a one-device
    CPU mesh: the loss to rtol 1e-5, each gradient to the parity bound."""
    case = cases["cbox"]
    rs = np.random.default_rng(11)
    target = rs.uniform(0.0, 0.5, (case.ps.film_height, case.ps.film_width, 3)).astype(
        np.float32)
    js = jreplace(case.js, {k: jnp.asarray(v) for k, v in case.values.items()})
    mesh = jsharding.make_mesh(1)
    j_loss, j_grads = jsharding.train_step_sharded(mesh, js, target, seed=3, depth_cap=2)
    p_loss, p_grads = train_step(case.ps, target, seed=3, depth_cap=2)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    got = grads_to_jax(p_grads)
    for k in DEFAULT_TRAIN_LEAVES:
        assert np.isfinite(got[k]).all(), k
        err = rel_l1(got[k], np.asarray(j_grads[k]))
        assert err <= REL_L1, f"{k}: relative L1 {err:.3e}"


def test_leaf_registry(cases):
    """The port's leaves (misaki_tpu's nine, in its order) and their layouts
    in both packages."""
    ps, js = cases["bitmap"].ps, cases["bitmap"].js
    assert leaf_names() == jleaf_names() == (
        "materials", "rad_coeff", "rad_curve", "env_rgb", "sigma_s_amp", "sigma_a_amp",
        "medium_scale", "bitmaps", "volumes")
    mine = get_leaves(ps, leaf_names())
    theirs = {k: np.asarray(v) for k, v in jget(js, leaf_names()).items()}
    for k, v in leaves_from_jax(theirs).items():
        assert tuple(mine[k].shape) == v.shape, k
    # a replaced leaf is the very tensor given: no copy
    x = mine["bitmaps"].clone().requires_grad_()
    assert replace_leaves(ps, {"bitmaps": x}).bitmaps is x
    back = grads_to_jax({k: t(v) for k, v in leaves_from_jax(theirs).items()})
    for k, v in theirs.items():
        np.testing.assert_array_equal(back[k], v)
    # the media leaves of a scene without media: empty tables, a stub grid
    for k in ("sigma_s_amp", "sigma_a_amp", "medium_scale"):
        assert tuple(mine[k].shape) == (0,), k
    assert tuple(mine["volumes"].shape) == (8,)
    with pytest.raises(KeyError):
        get_leaves(ps, ("nope",))
    assert ps.diff_mode is False and ps.replace(diff_mode=True).diff_mode is True


def test_inference_frame_unchanged_by_leaves(cases):
    """A frame under inference_mode renders the same film whether or not its
    leaves require grad (the forward only gains detaches)."""
    case = cases["env"]
    ref = pdriver.render(case.ps, seed=2, depth_cap=2)["film"]
    leaves = {k: v.detach().clone().requires_grad_() for k, v in get_leaves(
        case.ps, ("env_rgb",)).items()}
    got = pdriver.render(replace_leaves(case.ps, leaves), seed=2, depth_cap=2)["film"]
    assert torch.equal(got, ref)


def test_fetch4_gradient_matches_plain_autograd():
    """On the CPU, Fetch4's gradients (the table's through
    fetch4_backward_plain, the weights' in plain PyTorch) equal torch
    autograd through fetch4_plain's own ops, dead taps included; neither
    pass counts as a kernel launch."""
    from misaki_tpu_torch.render import texel_fetch as tf

    rs = np.random.default_rng(9)
    N, L = 300, 4000
    table = rs.uniform(-1.0, 2.0, (N, 3)).astype(np.float32)
    idx = rs.integers(0, N, (4, L)).astype(np.int32)
    w = rs.uniform(0.0, 1.0, (4, L)).astype(np.float32)
    dead = rs.uniform(size=(4, L)) < 0.2
    idx[dead & (rs.uniform(size=(4, L)) < 0.5)] = -3
    idx[dead & (idx >= 0)] = N + 5
    w[rs.uniform(size=(4, L)) < 0.05] = 0.0
    g_out = t(rs.normal(size=(3, L)).astype(np.float32))
    grads = []
    for fn in (tf.fetch4, tf.fetch4_plain):
        tab, ww = t(table).requires_grad_(), t(w).requires_grad_()
        before = (tracing.launches["fetch"], tracing.launches["fetch_bwd"])
        out = fn(tab, t(idx), ww)
        out.backward(g_out)
        assert (tracing.launches["fetch"], tracing.launches["fetch_bwd"]) == before
        grads.append((out.detach(), tab.grad, ww.grad))
    (o1, gt1, gw1), (o2, gt2, gw2) = grads
    assert torch.equal(o1, o2)
    torch.testing.assert_close(gt1, gt2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gw1, gw2, rtol=1e-6, atol=1e-6)
    live = (w != 0) & (idx >= 0) & (idx < N)
    assert (n(gw1)[~live] == 0).all()
    # the table's gradient without the weights' asks for no weight gradient
    tab = t(table).requires_grad_()
    tf.fetch4(tab, t(idx), t(w)).backward(g_out)
    torch.testing.assert_close(tab.grad, gt2, rtol=1e-6, atol=1e-6)


def test_fetch4_backward_routes_by_device():
    """fetch4_backward takes the twin on CPU tensors, checks its inputs,
    and has no kernel for another device; constant inputs or no_grad keep
    the fetch out of autograd."""
    from misaki_tpu_torch.render import texel_fetch as tf

    rs = np.random.default_rng(4)
    idx = t(rs.integers(0, 50, (4, 64)).astype(np.int32))
    w = t(rs.uniform(size=(4, 64)).astype(np.float32))
    g = t(rs.normal(size=(3, 64)).astype(np.float32))
    assert torch.equal(tf.fetch4_backward(idx, w, g, 50), tf.fetch4_backward_plain(idx, w, g, 50))
    with pytest.raises(ValueError, match="grad_out"):
        tf.fetch4_backward(idx, w, g[:2].contiguous(), 50)
    with pytest.raises(ValueError, match="int32"):
        tf.fetch4_backward(idx.long(), w, g, 50)
    with pytest.raises(ValueError, match="device meta"):
        tf.fetch4_backward(idx.to("meta"), w.to("meta"), g.to("meta"), 50)
    with pytest.raises(ValueError, match="0 < N"):
        tf.fetch4_backward(idx, w, g, 0)
    with pytest.raises(ValueError, match="contiguous"):
        tf.fetch4_backward(idx, w, g.T.contiguous().T, 50)
    # no taps: an all-zero gradient of the table's shape
    empty = tf.fetch4_backward(idx[:, :0].contiguous(), w[:, :0].contiguous(),
                               g[:, :0].contiguous(), 50)
    assert empty.shape == (50, 3) and not empty.any()
    table = t(rs.uniform(size=(50, 3)).astype(np.float32)).requires_grad_()
    assert tf.fetch4(table, idx, w).grad_fn is not None
    with torch.no_grad():
        assert not tf.fetch4(table, idx, w).requires_grad
    assert not tf.fetch4(table.detach(), idx, w).requires_grad


@pytest.mark.parametrize("name", ["conductor", "dielectric_tir", "diffuse_twosided", "disney",
                                  "every_kind", "mask_diffuse", "mask_roughconductor",
                                  "roughconductor_beckmann_aniso", "roughconductor_ggx",
                                  "roughdielectric", "roughplastic_linear",
                                  "roughplastic_nonlinear"])
def test_bsdf_gradients_match_jax(name):
    """d/d(material columns) of sum(eval_bsdf) + sum(sample weight) in
    diff_mode on tests/test_torch_bsdf.py's lanes of each case, against
    jax.grad, to relative L1 5e-3; the port's finite everywhere. Where
    misaki_tpu's is not finite (every_kind: a model evaluated on another
    kind's lanes whose GGX reciprocal overflows, times the zero cotangent
    of the select), the entries are left out of the comparison: the port
    keeps those reciprocals' values detached (core/microfacet.py)."""
    import test_torch_bsdf as tb

    params, kinds, ids, wi, wo, uv, lam, u = tb._case_inputs(name)

    def run(lib, bsdf, P, asarray):
        sc = tb._scene(params, kinds, asarray)
        sc.materials.params, sc.diff_mode = P, True
        p = bsdf.material_params(sc, asarray(ids), tuple(asarray(c) for c in uv), asarray(lam))
        wi_, wo_ = tuple(asarray(c) for c in wi), tuple(asarray(c) for c in wo)
        b = bsdf.sample_bsdf(p, wi_, asarray(u[0]), (asarray(u[1]), asarray(u[2])))
        return lib.sum(bsdf.eval_bsdf(p, wi_, wo_)) + lib.sum(b["weight"])

    want = np.asarray(jax.grad(lambda P: run(jnp, tb.jbsdf, P, jnp.asarray))(
        jnp.asarray(params)))
    P = t(params).requires_grad_()
    run(torch, tb.pbsdf, P, t).backward()
    got = n(P.grad)
    assert np.isfinite(got).all()
    ok = np.isfinite(want)
    assert ok.mean() > 0.9
    assert rel_l1(got[ok], want[ok]) <= REL_L1
