"""Scene compile parity: the port's host compiler against
misaki_tpu.scene.compiler on the in-repo scenes, the cluster build against
misaki_tpu.accel.cluster.build_clusters, and from_compiled."""

import subprocess
import sys

import jax
import numpy as np
import misaki_tpu
import pytest
import torch

from torch_helpers import CBOX_XML, FURNACE_XML, REPO, n

from misaki_tpu.accel import cluster as jcluster
from misaki_tpu.scene.compiler import compile_scene as jcompile
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu.scene.loader import load_string as jload_string
import misaki_tpu_torch
from misaki_tpu_torch.accel import cluster as pcluster
from misaki_tpu_torch.render.driver import render
from misaki_tpu_torch.scene import from_compiled, procedural
from misaki_tpu_torch.scene.compiler import compile_scene
from misaki_tpu_torch.scene.compiler import load_and_compile as pload
from misaki_tpu_torch.scene.loader import load_string

SCENES = {"cbox": (CBOX_XML, dict(spp=4, width=32, height=24)),
          "furnace": (FURNACE_XML, dict(spp=16))}
EXACT = [("geometry", "p0"), ("geometry", "e1"), ("geometry", "e2"),
         ("geometry", "face_tab"), ("emitters", "kind"), ("emitters", "shape"),
         ("emitters", "face_global"), ("emitters", "face_cdf"), ("emitters", "face_pack"),
         ("emitters", "area"), ("emitters", "position"), ("emitters", "bsphere_center"),
         ("emitters", "bsphere_radius"), ("camera", "to_world"),
         ("camera", "sample_to_camera"), ("camera", "near"), ("camera", "far"),
         (None, "shape_bsdf"), (None, "shape_emitter")]
FITTED = [("materials", "params"), ("emitters", "rad_coeff"), ("emitters", "rad_curve")]
STATIC = ["film_width", "film_height", "spp", "max_depth", "rr_depth", "hide_emitters",
          "integrator", "filter_type", "filter_stddev", "film_format", "n_faces",
          "n_shapes", "n_emitters", "has_environment", "environment_idx",
          "emitter_kinds", "bsdf_kinds", "crop_x", "crop_y"]


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    path, kw = SCENES[request.param]
    js = jax.tree_util.tree_map(np.asarray, jload(str(path), **kw))
    return js, pload(str(path), device="cpu", **kw)


def _get(obj, group, name):
    return getattr(obj if group is None else getattr(obj, group), name)


@pytest.mark.parametrize("group,name", EXACT)
def test_tables_exact(pair, group, name):
    js, ps = pair
    want, got = np.asarray(_get(js, group, name)), n(_get(ps, group, name))
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("group,name", FITTED)
def test_fitted_spectra(pair, group, name):
    js, ps = pair
    np.testing.assert_allclose(n(_get(ps, group, name)), np.asarray(_get(js, group, name)),
                               rtol=1e-6, atol=0)


def test_static_config(pair):
    js, ps = pair
    for name in STATIC:
        assert getattr(ps, name) == getattr(js, name), name


def test_from_compiled_reproduces_compile(pair):
    js, ps = pair
    fc = from_compiled(js, device="cpu")
    for group, name in EXACT + FITTED:
        np.testing.assert_array_equal(n(_get(fc, group, name)), n(_get(ps, group, name)))
    for name in ("bounds", "tri", "tab"):
        np.testing.assert_array_equal(n(getattr(fc.cluster, name)), n(getattr(ps.cluster, name)))
    assert fc.cluster.n_clusters == ps.cluster.n_clusters
    for name in STATIC:
        assert getattr(fc, name) == getattr(ps, name), name


def _rows(mesh):
    pos = mesh["positions"].astype(np.float64)
    return (pos[:, 0].astype(np.float32), (pos[:, 1] - pos[:, 0]).astype(np.float32),
            (pos[:, 2] - pos[:, 0]).astype(np.float32))


@pytest.mark.parametrize("case", ["bunny", "soup", "cbox"])
def test_build_clusters_matches(case):
    if case == "bunny":
        p0, e1, e2 = _rows(procedural.bunny_standin())
    elif case == "cbox":
        g = pload(str(CBOX_XML), spp=1, width=8, height=8, device="cpu").geometry
        p0, e1, e2 = (n(x)[:, :32].T for x in (g.p0, g.e1, g.e2))
    else:
        rs = np.random.default_rng(7)
        p0 = rs.uniform(-1, 1, (1500, 3)).astype(np.float32)
        e1 = rs.uniform(-0.1, 0.1, (1500, 3)).astype(np.float32)
        e2 = rs.uniform(-0.1, 0.1, (1500, 3)).astype(np.float32)
    tab = np.random.default_rng(1).normal(size=(5, len(p0))).astype(np.float32)
    want = jcluster.build_clusters(p0, e1, e2, face_tab=tab)
    got = pcluster.build_clusters(p0, e1, e2, face_tab=tab)
    assert got.n_clusters == want.n_clusters
    for name in ("bounds", "tri", "tab"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))


def test_every_scene_gets_clusters():
    ps = pload(str(CBOX_XML), spp=1, width=8, height=8, device="cpu")
    assert ps.cluster.n_clusters == 1 and ps.n_faces == 32
    assert int((n(ps.cluster.tri)[0, :, 9] >= 0).sum()) == 32


@pytest.mark.parametrize("plugin,xml", [
    ("homogeneous", '<medium type="homogeneous" name="interior"/>'),
    ("volpath", None),
    ("sppm", None),
    ("photonmapper", None),
])
def test_unported_plugins_raise(plugin, xml):
    """Plugins that raised before the port carried them compile like
    misaki_tpu's and render: a medium and the `volpath` integrator (with
    media), the `sppm` and `photonmapper` integrators (with photon
    mapping; 2048 photons, one iteration). The name dates from when they
    raised."""
    text = open(FURNACE_XML).read()
    if xml is None:
        text = text.replace('<integrator type="path"/>', f'<integrator type="{plugin}"/>')
        scene = compile_scene(load_string(text), spp=1, width=4, height=4, device="cpu")
        assert scene.integrator == plugin
        if plugin != "volpath":
            scene = scene.replace(ppm_photons=2048, ppm_iterations=1)
        out = render(scene, seed=0, depth_cap=2)
        assert torch.isfinite(out["rgb"]).all() and float(out["rgb"].mean()) > 0.1
    else:
        text = text.replace('<float name="radius" value="1.0"/>',
                            '<float name="radius" value="1.0"/>' + xml)
        ps = compile_scene(load_string(text), device="cpu")
        js = jcompile(jload_string(text))
        assert ps.media.kind.shape[0] == 1 and ps.aov_nested == js.aov_nested == "volpath"
        np.testing.assert_array_equal(n(ps.geometry.face_tab), np.asarray(js.geometry.face_tab))
        for f in ("kind", "sigma_s_coeff", "sigma_a_coeff", "scale", "density_vol"):
            np.testing.assert_array_equal(n(getattr(ps.media, f)), np.asarray(getattr(js.media, f)))


@pytest.mark.parametrize("plugin", ["roughconductor", "point"])
def test_ported_plugins_compile(plugin):
    """A rough conductor and a point light, which raised before the port
    carried every BSDF and the point emitter, compile like misaki_tpu's."""
    text = open(FURNACE_XML).read()
    if plugin == "point":
        text = text.replace('<emitter type="constant">',
                            '<emitter type="point"><point name="position" x="0" y="3" z="0"/>'
                            '</emitter>\n    <emitter type="constant">')
    else:
        text = text.replace('<bsdf type="diffuse">\n            <spectrum name="reflectance" '
                            'value="1.0"/>\n        </bsdf>', '<bsdf type="roughconductor"/>')
    assert plugin in text
    ps = compile_scene(load_string(text), device="cpu")
    js = jcompile(jload_string(text))
    assert ps.bsdf_kinds == tuple(js.bsdf_kinds)
    assert ps.emitter_kinds == tuple(js.emitter_kinds)
    np.testing.assert_array_equal(n(ps.emitters.position), np.asarray(js.emitters.position))
    np.testing.assert_allclose(n(ps.materials.params), np.asarray(js.materials.params),
                               rtol=1e-6)


def test_load_and_compile_defaults_to_the_card(pair):
    """Without `device=` the scene compiles onto the card (from an XML file,
    a description or a misaki_tpu scene), and where no CUDA device exists
    that raises instead of falling back to the CPU."""
    js, _ = pair
    if torch.cuda.is_available():
        assert pload(str(CBOX_XML), spp=1, width=8, height=8).device.type == "cuda"
        assert from_compiled(js).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pload(str(CBOX_XML), spp=1, width=8, height=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compile_scene(load_string(open(FURNACE_XML).read()))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            from_compiled(js)
    assert pload(str(CBOX_XML), spp=1, width=8, height=8, device="cpu").device.type == "cpu"
    assert from_compiled(js, device="cpu").device.type == "cpu"


def test_port_never_imports_jax():
    """The port and every slice module import without pulling in jax."""
    code = (
        "import sys, importlib\n"
        "mods = ['misaki_tpu_torch', 'misaki_tpu_torch.cli', 'misaki_tpu_torch.scene',\n"
        "  'misaki_tpu_torch.scene.compiler', 'misaki_tpu_torch.scene.loader',\n"
        "  'misaki_tpu_torch.scene.types', 'misaki_tpu_torch.scene.procedural',\n"
        "  'misaki_tpu_torch.scene.obj_loader', 'misaki_tpu_torch.utils.fresolver',\n"
        "  'misaki_tpu_torch.core.rng', 'misaki_tpu_torch.core.vec',\n"
        "  'misaki_tpu_torch.core.math', 'misaki_tpu_torch.core.frame',\n"
        "  'misaki_tpu_torch.core.warp', 'misaki_tpu_torch.core.cie_data',\n"
        "  'misaki_tpu_torch.core.table', 'misaki_tpu_torch.core.spectrum',\n"
        "  'misaki_tpu_torch.core.srgb_upsample', 'misaki_tpu_torch.core.transform',\n"
        "  'misaki_tpu_torch.accel.cluster', 'misaki_tpu_torch.accel.traverse',\n"
        "  'misaki_tpu_torch.render.camera', 'misaki_tpu_torch.render.interaction',\n"
        "  'misaki_tpu_torch.render.textures', 'misaki_tpu_torch.render.integrator',\n"
        "  'misaki_tpu_torch.render.film', 'misaki_tpu_torch.render.driver',\n"
        "  'misaki_tpu_torch.bsdf.kernels', 'misaki_tpu_torch.emitter.kernels',\n"
        "  'misaki_tpu_torch.render.aov', 'misaki_tpu_torch.utils.logging',\n"
        "  'misaki_tpu_torch.tools.bench', 'misaki_tpu_torch.parallel.sharding',\n"
        "  'misaki_tpu_torch.graft_entry']\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'misaki_tpu' or m.startswith('misaki_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def _same_desc(a, b):
    """Two scene descriptions (nested dicts, lists and arrays) equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_desc(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_desc(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_top_level_loaders():
    """misaki_tpu_torch.load_file and load_string (lazy, as
    misaki_tpu/__init__.py:31-41) give misaki_tpu.load_file's description
    of the in-repo cbox."""
    want = misaki_tpu.load_file(str(CBOX_XML))
    assert _same_desc(misaki_tpu_torch.load_file(str(CBOX_XML)), want)
    text = CBOX_XML.read_text()
    assert _same_desc(misaki_tpu_torch.load_string(text, base_dir=CBOX_XML.parent),
                      misaki_tpu.load_string(text, base_dir=CBOX_XML.parent))
    assert _same_desc(misaki_tpu_torch.load_string(text, base_dir=CBOX_XML.parent), want)
    with pytest.raises(AttributeError):
        misaki_tpu_torch.__getattr__("render")
