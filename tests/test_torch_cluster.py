"""The cluster walk's plain twins (misaki_tpu_torch.accel.cluster) against
the Pallas kernels of misaki_tpu.accel.cluster in interpret mode and the
brute-force oracles of misaki_tpu.accel.traverse, with the JAX suite's own
bounds (tests/test_cluster.py): t to rtol 1e-4, prim equal on >= 99% of
rays (exact ties may pick another winner), face rows exact, misses t = inf,
occlusion exact. The schedule (cull_order) must match exactly."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML, n, t

from misaki_tpu.accel import cluster as jcl
from misaki_tpu.accel import traverse as jtr
from misaki_tpu.scene.types import Geometry
from misaki_tpu_torch.accel import cluster as pcl
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.scene.compiler import load_and_compile as pload
from misaki_tpu_torch.tools.tie_case import merge_clusters


def _case(p0, e1, e2, tab, o, d, mint, maxt_hit, maxt_occ):
    F = len(p0)
    Fpad = -(-F // 128) * 128
    pad = lambda a: np.pad(a, ((0, Fpad - F), (0, 0)))  # noqa: E731
    geom = Geometry(p0=jnp.asarray(pad(p0).T), e1=jnp.asarray(pad(e1).T),
                    e2=jnp.asarray(pad(e2).T), face_tab=jnp.asarray(np.pad(tab, ((0, 0), (0, Fpad - F)))))
    return dict(
        jacc=jcl.build_clusters(p0, e1, e2, face_tab=tab),
        pacc=pcl.build_clusters(p0, e1, e2, face_tab=tab).to("cpu"),
        geom=geom, F=F, tab=tab,
        o=o.astype(np.float32), d=d.astype(np.float32), mint=mint.astype(np.float32),
        maxt_hit=maxt_hit.astype(np.float32), maxt_occ=maxt_occ.astype(np.float32))


def _soup():
    rs = np.random.default_rng(7)
    F = 1500
    p0 = rs.uniform(-1, 1, (F, 3)).astype(np.float32)
    e1 = rs.uniform(-0.1, 0.1, (F, 3)).astype(np.float32)
    e2 = rs.uniform(-0.1, 0.1, (F, 3)).astype(np.float32)
    L = 600
    o = rs.uniform(-2, 2, (3, L)).astype(np.float32)
    dn = rs.normal(size=(L, 3)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=1, keepdims=True)
    tab = np.random.default_rng(11).normal(size=(5, F)).astype(np.float32)
    tab[0] = np.arange(F)
    return _case(p0, e1, e2, tab, o, dn.T, np.full(L, 1e-4), np.full(L, np.inf),
                 np.full(L, 1.5))


def _cbox():
    scene = pload(str(CBOX_XML), spp=64, width=64, height=64, device="cpu")
    g = scene.geometry
    F = scene.n_faces
    p0, e1, e2 = (n(x)[:, :F].T.copy() for x in (g.p0, g.e1, g.e2))
    tab = n(g.face_tab)[:, :F]
    # 2048 camera rays of the frame's middle rows (8 tiles of 4 pixels x 64 spp)
    lane = torch.arange(2048, dtype=torch.int64) + 30 * 64 * 64
    ray, _, _ = pdriver.primary_rays(scene, lane, 3)
    o = np.stack([n(c) for c in ray["o"]])
    d = np.stack([n(c) for c in ray["d"]])
    return _case(p0, e1, e2, tab, o, d, n(ray["mint"]), n(ray["maxt"]),
                 0.5 * np.minimum(n(ray["maxt"]), 2000.0))


@pytest.fixture(scope="module", params=["soup", "cbox"])
def case(request):
    return _soup() if request.param == "soup" else _cbox()


def _jax_rays(c, maxt):
    return (tuple(jnp.asarray(r) for r in c["o"]), tuple(jnp.asarray(r) for r in c["d"]),
            jnp.asarray(c["mint"]), jnp.asarray(maxt))


def _torch_rays(c, maxt):
    return (tuple(t(r) for r in c["o"]), tuple(t(r) for r in c["d"]), t(c["mint"]), t(maxt))


def test_cull_order_exact(case):
    rays = pcl.pack_rays(*_torch_rays(case, case["maxt_hit"]))
    order, keys, count = pcl.cull_order(rays, case["pacc"].bounds, case["pacc"].n_clusters)
    jo, jk, jc, _ = jcl._cull_order(jnp.asarray(n(rays)), jnp.asarray(case["jacc"].bounds),
                                    case["jacc"].n_clusters, with_bounds=False,
                                    r_tile=pcl.R_TILE)
    np.testing.assert_array_equal(n(count), np.asarray(jc)[:, 0, 0])
    np.testing.assert_array_equal(n(keys), np.asarray(jk)[:, 0, :])
    np.testing.assert_array_equal(n(order), np.asarray(jo)[:, 0, :])


def _check_closest(got, want, min_hits):
    gp, wp = n(got["prim"]), np.asarray(want["prim"])
    assert ((gp >= 0) == (wp >= 0)).all()
    both = wp >= 0
    assert both.sum() > min_hits
    np.testing.assert_allclose(n(got["t"])[both], np.asarray(want["t"])[both],
                               rtol=1e-4, atol=1e-5)
    assert (gp[both] == wp[both]).mean() > 0.99
    assert np.isinf(n(got["t"])[~both]).all()
    return gp, wp


def test_closest_plain_matches_pallas(case):
    got = pcl.intersect_clusters(case["pacc"], *_torch_rays(case, case["maxt_hit"]))
    want = jcl.intersect_clusters(case["jacc"], *_jax_rays(case, case["maxt_hit"]),
                                  interpret=True)
    gp, wp = _check_closest(got, want, 30)
    same = gp == wp
    np.testing.assert_array_equal(n(got["fd"])[:, same], np.asarray(want["fd"])[:, same])


def test_closest_plain_matches_brute(case):
    got = pcl.intersect_clusters(case["pacc"], *_torch_rays(case, case["maxt_hit"]))
    want = jtr.intersect_brute(case["geom"], *_jax_rays(case, case["maxt_hit"]), case["F"],
                               face_tab=case["geom"].face_tab)
    want["t"] = jnp.where(want["prim"] >= 0, want["t"], jnp.inf)
    gp, wp = _check_closest(got, want, 30)
    hit = gp >= 0
    np.testing.assert_array_equal(n(got["fd"])[:, hit], case["tab"][:, gp[hit]])
    assert (n(got["fd"])[:, ~hit] == 0).all()


def test_anyhit_plain_matches_pallas_and_brute(case):
    got = n(pcl.ray_test_clusters(case["pacc"], *_torch_rays(case, case["maxt_occ"])))
    want = np.asarray(jcl.ray_test_clusters(case["jacc"], *_jax_rays(case, case["maxt_occ"]),
                                            interpret=True))
    brute = np.asarray(jtr.ray_test_brute(case["geom"], *_jax_rays(case, case["maxt_occ"]),
                                          case["F"]))
    assert got.any() and not got.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, brute)


def test_full_scan_fallback(monkeypatch):
    """A visit cap below the tiles' cluster counts forces the full scan
    (negative count); results must not change."""
    c = _soup()
    monkeypatch.setattr(pcl, "MAX_VISITS", 2)
    rays = pcl.pack_rays(*_torch_rays(c, c["maxt_hit"]))
    _, _, count = pcl.cull_order(rays, c["pacc"].bounds, c["pacc"].n_clusters)
    assert (n(count) == -c["pacc"].n_clusters).all()
    got = pcl.intersect_clusters(c["pacc"], *_torch_rays(c, c["maxt_hit"]))
    want = jtr.intersect_brute(c["geom"], *_jax_rays(c, c["maxt_hit"]), c["F"])
    want["t"] = jnp.where(want["prim"] >= 0, want["t"], jnp.inf)
    _check_closest(got, want, 30)
    occ = n(pcl.ray_test_clusters(c["pacc"], *_torch_rays(c, c["maxt_occ"])))
    np.testing.assert_array_equal(
        occ, np.asarray(jtr.ray_test_brute(c["geom"], *_jax_rays(c, c["maxt_occ"]), c["F"])))


def test_finite_maxt_clips():
    c = _soup()
    L = c["o"].shape[1]
    far = pcl.intersect_clusters(c["pacc"], *_torch_rays(c, np.full(L, np.inf)))
    near = pcl.intersect_clusters(c["pacc"], *_torch_rays(c, np.full(L, 0.8)))
    t_far, t_near = n(far["t"]), n(near["t"])
    keep = t_far <= 0.8
    np.testing.assert_allclose(t_near[keep], t_far[keep], rtol=1e-5)
    assert np.isinf(t_near[~keep]).all()


def test_wrapper_rejects_bad_inputs():
    c = _soup()
    acc = c["pacc"]
    rays = pcl.pack_rays(*_torch_rays(c, c["maxt_hit"]))
    with pytest.raises(ValueError):
        pcl.closest_hit(rays[:, :100].contiguous(), acc)
    with pytest.raises(ValueError):
        pcl.any_hit(rays, replace(acc, tri=acc.tri.double()))
    with pytest.raises(ValueError):
        pcl.any_hit(rays, replace(acc, nodes=acc.nodes[:, :12].contiguous()))
    with pytest.raises(ValueError):
        pcl.closest_hit(rays, replace(acc, leaf_tri=acc.leaf_tri.T))
    with pytest.raises(ValueError):
        pcl.closest_hit(rays, replace(acc, tab=acc.tab[:, :, :7]))
    with pytest.raises(ValueError):   # per-ray counts come from the kernels only
        pcl.closest_hit(rays, acc, counts=torch.zeros((2, rays.shape[1]), dtype=torch.int32))


def test_prim_differs_from_pallas_only_on_exact_ties(case):
    """Where the twin's face differs from misaki_tpu's (whose walk lets the
    first cluster visited win a tie), misaki_tpu's face is hit at the very
    same t in the port's arithmetic and the twin's face has the larger id.
    Checked on the case's accel and on the accel with every face duplicated
    into a second set of clusters, where every hit is such a tie. (t itself
    agrees to an ulp: XLA's CPU arithmetic may round differently.)"""
    o, d, mint, maxt = _torch_rays(case, case["maxt_hit"])
    F = case["F"]
    dup = merge_clusters(case["pacc"], case["pacc"])
    jdup = jcl.ClusterAccel(bounds=jnp.asarray(dup.bounds), tri=jnp.asarray(dup.tri),
                            tab=jnp.asarray(dup.tab), n_clusters=dup.n_clusters)
    for pacc, jacc in ((case["pacc"], case["jacc"]), (dup.to("cpu"), jdup)):
        got = pcl.intersect_clusters(pacc, o, d, mint, maxt)
        want = jcl.intersect_clusters(jacc, *_jax_rays(case, case["maxt_hit"]), interpret=True)
        gp, wp = n(got["prim"]), np.asarray(want["prim"])
        np.testing.assert_allclose(n(got["t"]), np.asarray(want["t"]), rtol=1e-6, atol=0)
        diff = np.nonzero(gp != wp)[0]
        assert (gp[diff] > wp[diff]).all() and (wp[diff] >= 0).all()
        if len(diff) == 0:
            continue
        g = case["geom"]
        f = wp[diff] % F
        blk = np.concatenate([np.asarray(x)[:, f].T for x in (g.p0, g.e1, g.e2)], 1)
        r = torch.stack([*(x[diff] for x in o), *(x[diff] for x in d), mint[diff], maxt[diff]])
        t_j, _, _, hit = pcl._mt(r[:, :, None], t(np.pad(blk, ((0, 0), (0, 1))))[:, None, :],
                                 maxt[diff][:, None])
        assert hit.all()
        np.testing.assert_array_equal(n(t_j)[:, 0, 0], n(got["t"])[diff])
    hits = wp >= 0
    assert hits.sum() > 30 and (gp[hits] == wp[hits] + F).all()
