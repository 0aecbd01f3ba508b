"""Bitmap textures, the envmap emitter and the texel fetch: the port against
misaki_tpu on the same inputs, on the CPU.

misaki_tpu runs with MISAKI_FORCE_PAGED=1, as its own tests do
(tests/test_envmap.py, tests/test_bitmap_raydiff.py): its compile takes the
paged-backend texture caps, which are the port's constants, and its texel
fetches go through `paged_fetch(interpret=True)`, which is exact float32.
(Without it, its bitmaps go through a bfloat16 fetch about 1% off.)

Tolerances: the compiled tables are equal to the bit. The paged kernel sums
a lane's taps page by page, so a lane whose taps straddle a page boundary
adds in another order than the port: rtol 1e-6 against it. Texture and
envmap evaluations are float32 chains of a few dozen operations where the
libraries' transcendental functions may differ in the last bit: rtol 1e-5,
and 1e-4 for sampled directions and pdfs (acos/sin/cos of sampled angles).
The small envlit render meets the golden-image criteria.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import golden_criteria, n, t

from misaki_tpu.emitter import kernels as jem
from misaki_tpu.render import driver as jdriver
from misaki_tpu.render import textures as jtex
from misaki_tpu.render.paged_fetch import pack_pages, paged_fetch
from misaki_tpu.scene import compiler as jcomp
from misaki_tpu_torch.bsdf import kernels as pbsdf
from misaki_tpu_torch.emitter import kernels as pem
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.render import integrator as pinteg
from misaki_tpu_torch.render import texel_fetch as tf
from misaki_tpu_torch.render import textures as ptex
from misaki_tpu_torch.scene import compiler as pcomp
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.types import MC_ALPHA_U, MC_REFL, N_MAT_COLS
from misaki_tpu_torch.scenes.envlit import assets
from misaki_tpu_torch.utils import tracing

L = 257  # not a multiple of the paged kernel's 256-lane tile

TWO_BITMAPS_XML = """<scene version="0.6.0">
  <sensor type="perspective">
    <transform name="to_world"><lookat origin="0, 3, 6" target="0, 0, 0" up="0, 1, 0"/></transform>
    <film type="hdrfilm"><integer name="width" value="8"/><integer name="height" value="6"/></film>
  </sensor>
  <emitter type="envmap"><string name="filename" value="{env}"/></emitter>
  <shape type="rectangle">
    <bsdf type="diffuse"><texture type="bitmap" name="reflectance">
      <string name="filename" value="small.hdr"/></texture></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><translate x="3"/></transform>
    <bsdf type="diffuse"><texture type="bitmap" name="reflectance">
      <string name="filename" value="floor.hdr"/>
      <transform name="to_uv"><scale x="3" y="2"/></transform></texture></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="to_world"><translate x="-3"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.5, 0.7"/></bsdf>
  </shape>
</scene>
"""


@pytest.fixture(autouse=True)
def _forced_paged(monkeypatch):
    monkeypatch.setenv("MISAKI_FORCE_PAGED", "1")


def _write_rle_hdr(path, rgb):
    """New-style RLE Radiance writer: every channel of every scanline as
    runs (for repeated bytes) and literals."""
    H, W, _ = rgb.shape
    m = rgb.max(axis=-1)
    exp = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, 2.0 ** (8.0 - exp), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe = np.concatenate([mant, np.where(m > 1e-32, exp + 128, 0).astype(np.uint8)[..., None]],
                          axis=-1)
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {H} +X {W}\n".encode())
    for y in range(H):
        out += bytes([2, 2, W >> 8, W & 0xFF])
        for ch in range(4):
            row = rgbe[y, :, ch]
            x = 0
            while x < W:
                run = 1
                while x + run < W and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                else:
                    lit = min(W - x, 128)
                    out += bytes([lit]) + row[x: x + lit].tobytes()
                    x += lit
    path.write_bytes(bytes(out))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Small envlit assets (a 64x128 sky, a 64x64 floor), an 8x8 bitmap, and
    a 64x128 env with black rows and columns (ties in both CDFs)."""
    d = tmp_path_factory.mktemp("envlit")
    xml = assets.write_assets(d, sky_shape=(64, 128), floor_res=64)
    rs = np.random.default_rng(4)
    assets.write_rgbe(d / "small.hdr", rs.uniform(0.05, 0.9, (8, 8, 3)).astype(np.float32))
    env = rs.uniform(0.0, 3.0, (64, 128, 3)).astype(np.float32)
    env[10:20] = 0.0
    env[:, 40:56] = 0.0
    env[30:34, 90:94] = 40.0
    assets.write_rgbe(d / "ties.hdr", env)
    for name, env_file in (("two.xml", "sky.hdr"), ("ties.xml", "ties.hdr")):
        (d / name).write_text(TWO_BITMAPS_XML.format(env=env_file))
    return d, xml


@pytest.fixture(scope="module")
def scenes(files):
    """{name: (misaki_tpu scene, port scene)} compiled from the same XML."""
    d, xml = files
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MISAKI_FORCE_PAGED", "1")
        for name, path, kw in (("envlit", xml, dict(spp=4, width=32, height=24)),
                               ("two", d / "two.xml", {}), ("ties", d / "ties.xml", {})):
            out[name] = (jcomp.load_and_compile(str(path), **kw),
                         pcomp.load_and_compile(str(path), device="cpu", **kw))
    return out


# ---------------------------------------------------------------------------
# (a) the RGBE reader and the compiled tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rle", [False, True])
def test_rgbe_reader(tmp_path, rle):
    rs = np.random.default_rng(11)
    rgb = rs.uniform(0.0, 5.0, (13, 40, 3)).astype(np.float32)
    rgb[2:5, 3:30] = [1.0, 2.0, 0.5]          # long runs for the RLE writer
    rgb[7] = 0.0
    path = tmp_path / "x.hdr"
    (_write_rle_hdr if rle else assets.write_rgbe)(path, rgb)
    got = pcomp.read_image_rgb(path)
    np.testing.assert_array_equal(got, jcomp._read_rgbe_hdr(path))
    assert got.shape == rgb.shape and got.dtype == np.float32
    # 8-bit mantissas of a shared exponent: within 1/128 of the texel's max
    assert (np.abs(got - rgb) <= rgb.max(-1, keepdims=True) / 128 + 1e-7).all()


def test_non_hdr_image_needs_imageio(tmp_path):
    (tmp_path / "x.png").write_bytes(b"\x89PNG")
    try:
        import imageio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="imageio"):
            pcomp.read_image_rgb(tmp_path / "x.png")
    else:
        with pytest.raises(Exception):
            pcomp.read_image_rgb(tmp_path / "x.png")


TABLES = [("emitters", "env_rgb"), ("emitters", "env_pmf"), ("emitters", "env_marg_cdf"),
          ("emitters", "env_cond_cdf"), ("emitters", "env_to_world"),
          ("emitters", "env_to_local"), ("materials", "params"), (None, "bitmaps")]


@pytest.mark.parametrize("name", ["envlit", "two"])
@pytest.mark.parametrize("group,field", TABLES)
def test_compiled_tables_exact(scenes, name, group, field):
    js, ps = scenes[name]
    want = np.asarray(getattr(js if group is None else getattr(js, group), field))
    got = n(getattr(ps if group is None else getattr(ps, group), field))
    if field == "bitmaps":
        want = want.T                         # the port's table is texel-major
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["envlit", "two"])
def test_compiled_static(scenes, name):
    js, ps = scenes[name]
    for field in ("bitmap_meta", "bitmap_slots", "emitter_kinds", "has_environment",
                  "environment_idx", "n_emitters", "bsdf_kinds", "n_faces"):
        assert getattr(ps, field) == getattr(js, field), field
    assert ps.bitmap_slots == (MC_REFL,)
    assert len(ps.bitmap_meta) == (2 if name == "two" else 1)


def _texture(kind):
    scale_uv = {"to_uv": np.diag([3.0, 2.0, 1.0, 1.0])}
    if kind == "uniform":
        return {"type": "uniform", "props": {"value": 0.25}, "children": []}
    if kind == "bitmap":
        return {"type": "bitmap", "props": {"filename": "small.hdr", **scale_uv}, "children": []}
    return {"type": "checkerboard", "props": scale_uv, "children": [
        ("color0", {"type": "uniform", "props": {"value": 0.7}, "children": []})]}


@pytest.mark.parametrize("kind", ["property", "uniform", "bitmap", "checkerboard"])
def test_scalar_slot_compile(files, kind):
    """The 9-column scalar slot of each texture kind, and the bitmap it loads."""
    d, _ = files
    obj = {"type": "roughconductor", "props": {"alpha": 0.3},
           "children": [] if kind == "property" else [("alpha", _texture(kind))]}
    pb, jb = pcomp._BitmapBuilder(str(d)), jcomp._BitmapBuilder(str(d))
    np.testing.assert_array_equal(pcomp.scalar_slot(obj, "alpha", 0.1, pb),
                                  jcomp.scalar_slot(obj, "alpha", 0.1, jb))
    got, want = pb.finalize(), jb.finalize()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]).T)
    assert got[1] == want[1]


def test_envmap_sampling_tables_decoupled(files):
    """A 32x64 map with max_res=(8, 16): radiance texels at full resolution,
    the importance tables cut to 8x16."""
    d, _ = files
    rs = np.random.default_rng(2)
    assets.write_rgbe(d / "dec.hdr", rs.uniform(0.0, 2.0, (32, 64, 3)).astype(np.float32))
    obj = {"type": "envmap", "props": {"filename": "dec.hdr", "scale": 2.0}, "children": []}
    got = pcomp._load_envmap(obj, str(d), max_res=(8, 16))
    want = jcomp._load_envmap(obj, str(d), max_res=(8, 16))
    assert got[0].shape == (32, 64, 3) and got[1].shape == (8, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_from_compiled_carries_textures(scenes):
    js, ps = scenes["two"]
    import jax

    fc = from_compiled(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    for group, field in TABLES:
        a = getattr(fc if group is None else getattr(fc, group), field)
        b = getattr(ps if group is None else getattr(ps, group), field)
        assert torch.equal(a, b), field
    assert fc.bitmap_meta == ps.bitmap_meta and fc.bitmap_slots == ps.bitmap_slots


# ---------------------------------------------------------------------------
# (b) the texel fetch against the paged Pallas kernel
# ---------------------------------------------------------------------------

def _taps(N, rs):
    """idx4/w4 (4, L) with dead taps (w = 0 at ids out of range) and taps
    that straddle the kernel's 1024-texel pages."""
    idx = rs.integers(0, N, (4, L)).astype(np.int32)
    w = rs.uniform(0.0, 1.0, (4, L)).astype(np.float32)
    idx[:, :40] = (1020 + np.arange(4))[:, None]            # one lane, two pages
    idx[:, 40:80] = (2 * 1024 - 2 + np.arange(4))[:, None]
    dead = rs.uniform(size=(4, L)) < 0.2
    w[dead] = 0.0
    idx[0, :10][w[0, :10] == 0] = -7
    idx[3, 10:20] = np.where(w[3, 10:20] == 0, N + 100, idx[3, 10:20])
    w[:, 100:110] = 0.0                                       # all taps dead
    return idx, w


def test_fetch4_plain_matches_paged_kernel():
    rs = np.random.default_rng(3)
    N = 5000
    table = rs.uniform(-2.0, 5.0, (3, N)).astype(np.float32)
    idx, w = _taps(N, rs)
    want = np.asarray(paged_fetch(jnp.asarray(pack_pages(table)), jnp.asarray(idx),
                                  jnp.asarray(w), interpret=True))
    got = n(tf.fetch4_plain(t(table.T.copy()), t(idx), t(w)))
    assert got.shape == (3, L)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * np.abs(want).max())
    # dead taps add exactly nothing: lanes with every tap dead are 0
    assert (got[:, 100:110] == 0).all()
    ref = sum(table[:, np.clip(idx[k], 0, N - 1)].astype(np.float64) * w[k] for k in range(4))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_fetch4_routes_by_device():
    rs = np.random.default_rng(5)
    table = t(rs.uniform(size=(300, 3)).astype(np.float32))
    idx, w = (t(x) for x in _taps(300, rs))
    before = tracing.launches["fetch"]
    assert torch.equal(tf.fetch4(table, idx, w), tf.fetch4_plain(table, idx, w))
    assert tracing.launches["fetch"] == before        # the CPU twin is not a launch
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        tf.fetch4(torch.cat([table, table[:, :1]], dim=1), idx, w)
    with pytest.raises(ValueError, match="device meta"):
        tf.fetch4(table.to("meta"), idx.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        tf.fetch4(table, idx.to(torch.int64), w)
    with pytest.raises(ValueError, match="4, L"):
        tf.fetch4(table, idx[:3].contiguous(), w[:3].contiguous())


# ---------------------------------------------------------------------------
# (c) bitmap fetches and the slot modes
# ---------------------------------------------------------------------------

def _uv_duv(seed, spread=0.3):
    rs = np.random.default_rng(seed)
    u = rs.uniform(-1.5, 2.5, L).astype(np.float32)
    v = rs.uniform(-1.5, 2.5, L).astype(np.float32)
    duv = rs.uniform(-spread, spread, (4, L)).astype(np.float32)
    duv[:, :20] = 0.0                          # level 0
    return u, v, duv


def _close(want, got, rtol=1e-5, atol=1e-6):
    for w_, g in zip(want, got):
        np.testing.assert_allclose(n(g), np.asarray(w_), rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_duv", [False, True])
@pytest.mark.parametrize("tid", [0, 1])
def test_bitmap_fetch_rgb(scenes, tid, with_duv):
    js, ps = scenes["two"]
    u, v, duv = _uv_duv(tid + 10)
    jd = ((jnp.asarray(duv[0]), jnp.asarray(duv[1])), (jnp.asarray(duv[2]), jnp.asarray(duv[3])))
    pd = ((t(duv[0]), t(duv[1])), (t(duv[2]), t(duv[3])))
    want = jtex.bitmap_fetch_rgb(js, tid, jnp.asarray(u), jnp.asarray(v),
                                 jd if with_duv else None)
    got = ptex.bitmap_fetch_rgb(ps, tid, t(u), t(v), pd if with_duv else None)
    _close(want, got)


def _bitmap_taps_from_meta(scene, tex_id, u, v, duv=None):
    """bitmap_taps as the port computed it before the scene carried its
    level table: each call built the texture's (offset, W, H) rows from the
    static meta."""
    W0, H0, levels = scene.bitmap_meta[tex_id]
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    if duv is None:
        lvl = torch.zeros_like(u)
    else:
        (dudx, dvdx), (dudy, dvdy) = duv
        fp = torch.maximum(torch.maximum(torch.abs(dudx), torch.abs(dudy)) * W0,
                           torch.maximum(torch.abs(dvdx), torch.abs(dvdy)) * H0)
        lvl = torch.clamp(torch.floor(torch.log2(torch.clamp(fp, min=1.0))), 0.0,
                          len(levels) - 1.0)
    has_lvl = lvl >= 0.0
    geo = torch.tensor(levels, dtype=torch.int32)[torch.where(has_lvl, lvl, 0.0).to(torch.int64)]
    off, W, H = geo[:, 0], geo[:, 1], geo[:, 2]
    fu, fv = u * W.to(torch.float32) - 0.5, v * H.to(torch.float32) - 0.5
    j0, i0 = torch.floor(fu), torch.floor(fv)
    tu, tv = fu - j0, fv - i0
    j0w, j1w = torch.remainder(j0.to(torch.int32), W), torch.remainder(j0.to(torch.int32) + 1, W)
    i0w, i1w = torch.remainder(i0.to(torch.int32), H), torch.remainder(i0.to(torch.int32) + 1, H)
    idx4 = torch.stack([off + i0w * W + j0w, off + i0w * W + j1w,
                        off + i1w * W + j0w, off + i1w * W + j1w])
    w4 = torch.stack([(1.0 - tu) * (1.0 - tv), tu * (1.0 - tv), (1.0 - tu) * tv, tu * tv])
    return (torch.where(has_lvl[None, :], idx4, 0).to(torch.int32),
            torch.where(has_lvl[None, :], w4, 0.0))


@pytest.mark.parametrize("with_duv", [False, True])
@pytest.mark.parametrize("name,tid", [("envlit", 0), ("two", 0), ("two", 1)])
def test_bitmap_taps_level_table(scenes, name, tid, with_duv):
    """The scene's (offset, W, H) level table, built once at compile time,
    gives bitmap_taps the same taps as the per-call table it replaced;
    NaN footprints select no level."""
    _, ps = scenes[name]
    levels = ps.bitmap_meta[tid][2]
    assert ps.bitmap_levels.dtype == torch.int32 and ps.bitmap_levels.device == ps.device
    assert torch.equal(ps.bitmap_levels[tid, :len(levels)], torch.tensor(levels, dtype=torch.int32))
    u, v, duv = _uv_duv(tid + 30)
    duv[:, 20:24] = np.nan
    pd = ((t(duv[0]), t(duv[1])), (t(duv[2]), t(duv[3]))) if with_duv else None
    got = ptex.bitmap_taps(ps, tid, t(u), t(v), pd)
    want = _bitmap_taps_from_meta(ps, tid, t(u), t(v), pd)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if with_duv:
        assert (got[1][:, 20:24] == 0).all()


def _slot_cols(kind, seed):
    """Material columns of L lanes mixing every slot mode: a plain colour,
    a checkerboard, and each of the scene's two bitmaps."""
    rs = np.random.default_rng(seed)
    cols = np.zeros((N_MAT_COLS, L), np.float32)
    if kind == "spectral":
        base, w = MC_REFL, 13
        cols[base + 1: base + 7] = rs.uniform(-2, 2, (6, L))
        cols[base + 7: base + 13] = np.array([2, 0.5, 0.1, -0.3, 1.5, 0.2])[:, None]
    else:
        base, w = MC_ALPHA_U, 9
        cols[base + 1: base + 3] = rs.uniform(0, 1, (2, L))
        cols[base + 3: base + 9] = np.array([2, 0.5, 0.1, -0.3, 1.5, 0.2])[:, None]
    mode = rs.integers(0, 4, L)
    cols[base] = np.minimum(mode, 2)
    bitmap = mode >= 2
    cols[base + 1, bitmap] = mode[bitmap] - 2   # texture id 0 or 1
    return base, w, cols


@pytest.mark.parametrize("kind", ["spectral", "scalar"])
def test_slot_modes(scenes, kind):
    js, ps = scenes["two"]
    base, width, cols = _slot_cols(kind, 21)
    u, v, duv = _uv_duv(22, spread=0.05)
    jd = ((jnp.asarray(duv[0]), jnp.asarray(duv[1])), (jnp.asarray(duv[2]), jnp.asarray(duv[3])))
    pd = ((t(duv[0]), t(duv[1])), (t(duv[2]), t(duv[3])))
    lam = np.random.default_rng(23).uniform(360, 830, (4, L)).astype(np.float32)
    jslot = jnp.asarray(cols[base: base + width])
    if kind == "spectral":
        want = jtex.eval_spectral_slot(jslot, (jnp.asarray(u), jnp.asarray(v)), jnp.asarray(lam),
                                       scene=js, duv=jd)
        got = pbsdf.spectral_slot(ps, t(cols), base, (t(u), t(v)), t(lam), pd)
    else:
        want = jtex.eval_scalar_slot(jslot, (jnp.asarray(u), jnp.asarray(v)), scene=js, duv=jd)
        got = pbsdf.scalar_slot(ps.replace(bitmap_slots=(MC_REFL, MC_ALPHA_U)), t(cols), base,
                                (t(u), t(v)), pd)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    # a slot not listed in bitmap_slots skips the fetch: its bitmap lanes
    # read the slot's first value (the texture id) as a plain one
    if kind == "scalar":
        plain = n(pbsdf.scalar_slot(ps, t(cols), base, (t(u), t(v)), pd))
        bitmap = cols[base] == 2
        assert bitmap.any()
        np.testing.assert_array_equal(plain[bitmap], cols[base + 1][bitmap])
        np.testing.assert_array_equal(plain[~bitmap], n(got)[~bitmap])


# ---------------------------------------------------------------------------
# (d) the envmap: direction <-> uv, pdf and the 2D-CDF sampler
# ---------------------------------------------------------------------------

def _dirs(seed, count=4096):
    d = np.random.default_rng(seed).normal(size=(3, count)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, :2] = [[0, 0], [1, -1], [0, 0]]       # the poles
    return d


@pytest.mark.parametrize("name", ["envlit", "ties"])
def test_env_uv_and_pdf(scenes, name):
    js, ps = scenes[name]
    d = _dirs(31)
    ju, jv, js_t = jem._env_dir_to_uv(js, tuple(jnp.asarray(c) for c in d))
    pu, pv, ps_t = pem._env_dir_to_uv(ps, tuple(t(c) for c in d))
    _close((ju, jv, js_t), (pu, pv, ps_t))
    jd, jst = jem._env_uv_to_dir(js, ju, jv)
    pdir, pst = pem._env_uv_to_dir(ps, pu, pv)
    _close(tuple(jd) + (jst,), tuple(pdir) + (pst,))
    np.testing.assert_allclose(np.stack([n(c) for c in pdir]), d, atol=2e-5)
    _close((jem._env_pdf_sa(js, ju, jv, js_t),), (pem._env_pdf_sa(ps, pu, pv, ps_t),),
           rtol=1e-5, atol=0)
    # the bilinear fetch at the same (u, v): the paged kernel's page order
    want = np.stack(jem._env_bilinear_rgb(js, ju, jv))
    got = n(torch.stack(pem._env_bilinear_rgb(ps, t(np.asarray(ju)), t(np.asarray(jv)))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * np.abs(want).max())
    # radiance along d: where the libraries' atan2 / acos agree to the bit
    # (an ulp of u moves a bilinear weight by W ulps, which the 0-to-40
    # texel edges of the ties map turn into 1e-4 relative)
    same = (np.asarray(ju) == n(pu)) & (np.asarray(jv) == n(pv))
    assert same.mean() > 0.5
    lam = np.random.default_rng(32).uniform(360, 830, (4, d.shape[1])).astype(np.float32)
    want = np.asarray(jem._env_radiance_spec(js, tuple(jnp.asarray(c) for c in d),
                                             jnp.asarray(lam)))
    got = n(pem._env_radiance_spec(ps, tuple(t(c) for c in d), t(lam)))
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=1e-5, atol=1e-6)


def _u2_with_entries(ps, seed, count=8192):
    """Uniform samples, plus samples exactly on CDF entries (marginal and
    conditional, including tied runs)."""
    rs = np.random.default_rng(seed)
    u2 = rs.uniform(0, 1, (2, count)).astype(np.float32)
    marg = n(ps.emitters.env_marg_cdf)
    cond = n(ps.emitters.env_cond_cdf)
    k = count // 4
    u2[1, :k] = marg[rs.integers(0, len(marg) - 1, k)]
    u2[0, k: 2 * k] = cond[rs.integers(0, cond.shape[0], k), rs.integers(0, cond.shape[1] - 1, k)]
    return u2


@pytest.mark.parametrize("name", ["envlit", "ties"])
def test_env_sample_dir(scenes, name):
    js, ps = scenes[name]
    if name == "ties":
        marg = n(ps.emitters.env_marg_cdf)
        cond = n(ps.emitters.env_cond_cdf)
        assert (np.diff(marg) == 0).any() and (np.diff(cond, axis=1) == 0).any()
    u2 = _u2_with_entries(ps, 41)
    jd, jpdf, ju, jv = jem._env_sample_dir(js, tuple(jnp.asarray(c) for c in u2))
    pd, ppdf, pu, pv = pem._env_sample_dir(ps, tuple(t(c) for c in u2))
    Hs, Ws = ps.emitters.env_pmf.shape
    rows_equal = np.floor(np.asarray(jv) * Hs) == np.floor(n(pv) * Hs)
    cols_equal = np.floor(np.asarray(ju) * Ws) == np.floor(n(pu) * Ws)
    assert rows_equal.mean() >= 0.999 and cols_equal.mean() >= 0.999
    same = rows_equal & cols_equal
    for a, b in zip(jd, pd):
        np.testing.assert_allclose(n(b)[same], np.asarray(a)[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(ppdf)[same], np.asarray(jpdf)[same], rtol=1e-4, atol=0)
    # the sampler's pdf is the pdf it reports for the direction it sampled,
    # on the uniform samples (a sample on a CDF entry lies on a texel edge,
    # which the round trip through the trigonometry may cross)
    pu2, pv2, pst = pem._env_dir_to_uv(ps, pd)
    back = n(pem._env_pdf_sa(ps, pu2, pv2, pst))[len(u2[0]) // 2:]
    fwd = n(ppdf)[len(u2[0]) // 2:]
    ok = fwd > 0
    assert np.isclose(back[ok], fwd[ok], rtol=2e-3).mean() > 0.99


def test_sample_emitter_direct_envmap(scenes):
    js, ps = scenes["envlit"]
    rs = np.random.default_rng(51)
    u2 = rs.uniform(0, 1, (2, L)).astype(np.float32)
    p = rs.normal(size=(3, L)).astype(np.float32)
    lam = rs.uniform(360, 830, (4, L)).astype(np.float32)
    jr = jem.sample_emitter_direct(js, tuple(jnp.asarray(c) for c in p), jnp.asarray(lam),
                                   tuple(jnp.asarray(c) for c in u2))
    pr = pem.sample_emitter_direct(ps, tuple(t(c) for c in p), t(lam), tuple(t(c) for c in u2))
    for k in ("d", "dist", "pdf", "spec"):
        want, got = jr[k], pr[k]
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        _close(want, got, rtol=1e-4, atol=1e-5)
    ids = np.zeros(L, np.int32)
    _close((jem.pdf_emitter_direct(js, jnp.asarray(ids), jr["d"], jr["dist"], jr["d"]),),
           (pem.pdf_emitter_direct(ps, t(ids), pr["d"], pr["dist"], pr["d"]),),
           rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# (e) the slice as a whole
# ---------------------------------------------------------------------------

def test_envlit_render_matches_misaki_tpu(scenes):
    """The port's compile and render of the envlit scene on the CPU against
    misaki_tpu's, same XML, seed and depth, under the golden criteria."""
    js, ps = scenes["envlit"]
    want = np.asarray(jdriver.render(js, seed=7, depth_cap=3)["rgb"])
    got = n(pdriver.render(ps, seed=7, depth_cap=3)["rgb"])
    assert got.shape == want.shape == (24, 32, 3)
    assert np.isfinite(got).all() and got.mean() > 0.05
    frac_off, mean_err = golden_criteria(got, want)
    assert frac_off < 0.02, frac_off
    assert mean_err < 1e-3, mean_err


def test_fetches_per_chunk(scenes, monkeypatch):
    """Every lane is fetched and masked, so a chunk makes a fixed number of
    texel fetches: the primary escape, then per bounce the floor's bitmap,
    NEE's envmap sample and the bounce ray's escape."""
    _, ps = scenes["envlit"]
    calls = []

    def counting(table, idx4, w4):
        calls.append(idx4.shape[1])
        return tf.fetch4_plain(table, idx4, w4)

    monkeypatch.setattr(ptex, "fetch4", counting)
    monkeypatch.setattr(pem, "fetch4", counting)
    chunk = 32 * 24 * 4 // 2
    pdriver.render(ps, seed=1, chunk_size=chunk, depth_cap=4)
    n_iters = pinteg.n_bounce_iters(ps, 4)
    assert len(calls) == 2 * (1 + 3 * n_iters)
    assert set(calls) == {chunk}
