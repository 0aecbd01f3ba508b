"""The CUDA kernels (cluster closest hit and any hit, texel fetch) against
their plain PyTorch twins, on the card.

Marked `cuda`: every test skips where no CUDA device is present (a CUDA
kernel has no CPU mode). Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(`--noconftest`: the suite's conftest sets up JAX, which a GPU machine for
the port need not have; this file imports no JAX.)

Bounds: face id equal on >= 99.9% of rays, t to rtol 1e-5 and the face row
exact where the face ids agree, occlusion equal on >= 99.99% of rays. The
kernels are built without fused multiply-add, so in practice they agree
bit for bit. The texel fetch adds the same rounded products in the same
order as its twin: equal to the bit.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML

from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.emitter import kernels as em
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import texel_fetch as tf
from misaki_tpu_torch.render import textures as tex
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.scenes.envlit import assets
from misaki_tpu_torch.scenes.materials import assets as materials_assets
from misaki_tpu_torch.tools import profile_cluster_frame, profile_texel_fetch_levers
from misaki_tpu_torch.tools.tie_case import merge_clusters

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def _soup_acc(F, seed):
    rs = np.random.default_rng(seed)
    p0 = rs.uniform(-1, 1, (F, 3)).astype(np.float32)
    e1 = rs.uniform(-0.1, 0.1, (F, 3)).astype(np.float32)
    e2 = rs.uniform(-0.1, 0.1, (F, 3)).astype(np.float32)
    tab = rs.normal(size=(36, F)).astype(np.float32)
    return cl.build_clusters(p0, e1, e2, face_tab=tab).to("cuda")


def _rays(L, seed, spread):
    g = torch.Generator(device="cuda").manual_seed(seed)
    o = spread * (2 * torch.rand((3, L), device="cuda", generator=g) - 1)
    d = torch.randn((3, L), device="cuda", generator=g)
    return o, d / d.norm(dim=0, keepdim=True)


def _compare(acc, o, d, maxt_occ, expect_hits=True):
    """Both kernels against their twins on one ray set. Returns the kernel's
    closest-hit output."""
    L = o.shape[1]
    mint = torch.full((L,), 1e-4, device="cuda")
    rays = cl.pack_rays(tuple(o), tuple(d), mint, torch.full((L,), float("inf"), device="cuda"))
    before = cl.closest_launches
    out_k, fd_k = cl.closest_hit(rays, acc)
    assert cl.closest_launches == before + 1
    out_p, fd_p = cl.closest_hit_plain(rays, acc)
    same = out_k[3] == out_p[3]
    assert same.float().mean().item() >= 0.999
    hit = same & (out_p[3] >= 0)
    assert bool(hit.any()) == expect_hits
    torch.testing.assert_close(out_k[0][hit], out_p[0][hit], rtol=1e-5, atol=0)
    assert torch.equal(fd_k[:, same], fd_p[:, same])
    assert torch.equal(out_k[0][out_p[3] < 0], out_p[0][out_p[3] < 0])

    srays = cl.pack_rays(tuple(o), tuple(d), mint, maxt_occ)
    before = cl.anyhit_launches
    occ_k = cl.any_hit(srays, acc)
    assert cl.anyhit_launches == before + 1
    occ_p = cl.any_hit_plain(srays, acc)
    assert (occ_k == occ_p).float().mean().item() >= 0.9999
    return out_k


@pytest.mark.parametrize("F,L", [(1500, 600), (20000, 1 << 16), (128, 4096)])
def test_soup_kernels_match_plain(F, L):
    acc = _soup_acc(F, F)
    o, d = _rays(L, F, 1.5)
    _compare(acc, o, d, 1.5 * torch.ones(L, device="cuda"))


def _bunny_acc():
    pos = procedural.bunny_standin()["positions"].astype(np.float64)
    tab = np.random.default_rng(4).normal(size=(36, len(pos))).astype(np.float32)
    return cl.build_clusters(pos[:, 0].astype(np.float32),
                             (pos[:, 1] - pos[:, 0]).astype(np.float32),
                             (pos[:, 2] - pos[:, 0]).astype(np.float32), face_tab=tab)


@pytest.mark.parametrize("spread", [0.15, 0.05])
def test_bunny_kernels_match_plain(spread):
    """Random origins around the stand-in and random directions: incoherent
    rays, each walking its own path (spread 0.05: origins packed around the
    mesh's base, many inside its box)."""
    o, d = _rays(1 << 16, 1, spread)
    _compare(_bunny_acc().to("cuda"), o, d, 0.1 * torch.ones(1 << 16, device="cuda"))


def test_duplicated_faces_tie_to_the_larger_id():
    """Every bunny face twice, in two sets of clusters: each hit is an exact
    tie across clusters, which the copy (the larger face id) wins in kernel
    and twin alike."""
    host = _bunny_acc()
    F = host.leaf_tri.shape[0]
    dup = merge_clusters(host, host).to("cuda")
    o, d = _rays(1 << 16, 2, 0.15)
    out = _compare(dup, o, d, 0.1 * torch.ones(1 << 16, device="cuda"))
    once = _compare(host.to("cuda"), o, d, 0.1 * torch.ones(1 << 16, device="cuda"))
    hit = once[3] >= 0
    assert hit.sum() > 1000
    assert torch.equal(out[3][hit], once[3][hit] + F) and torch.equal(out[0], once[0])


def test_empty_accel_misses():
    acc = profile_cluster_frame.empty_tree(36)
    o, d = _rays(4096, 3, 1.0)
    out = _compare(acc, o, d, torch.ones(4096, device="cuda"), expect_hits=False)
    assert (out[3] == -1).all() and (out[0] == 3e38).all()


def test_traversal_counts():
    """The optional counts output: nodes visited and faces tested per ray;
    the empty tree visits only its root."""
    o, d = _rays(1 << 12, 5, 0.15)
    rays = cl.pack_rays(tuple(o), tuple(d), torch.full((1 << 12,), 1e-4, device="cuda"),
                        torch.full((1 << 12,), float("inf"), device="cuda"))
    counts = torch.full((2, rays.shape[1]), -1, dtype=torch.int32, device="cuda")
    out, _ = cl.closest_hit(rays, _bunny_acc().to("cuda"), counts)
    assert (counts[0] >= 1).all() and (counts[1] >= 0).all()
    assert (counts[1][out[3] >= 0] >= 1).all()
    cl.any_hit(rays, profile_cluster_frame.empty_tree(36), counts)
    assert (counts[0] == 1).all() and (counts[1] == 0).all()


def test_cbox_kernels_match_plain():
    scene = load_and_compile(str(CBOX_XML), spp=64, width=64, height=64)
    lane = torch.arange(1 << 16, dtype=torch.int64, device="cuda") + 32 * 64 * 64
    ray, _, _ = driver.primary_rays(scene, lane, 0)
    _compare(scene.cluster, torch.stack(ray["o"]), torch.stack(ray["d"]),
             0.5 * ray["maxt"].clamp(max=2000.0))


def test_wrapper_raises_off_cuda_and_cpu():
    acc = _soup_acc(256, 0)
    o, d = _rays(256, 0, 1.0)
    rays = cl.pack_rays(tuple(o), tuple(d), torch.zeros(256, device="cuda"),
                        torch.ones(256, device="cuda"))
    with pytest.raises(ValueError):
        cl.any_hit(rays, replace(acc, nodes=acc.nodes.cpu()))
    with pytest.raises(ValueError):
        cl.closest_hit(rays.cpu(), acc)


def test_launchers_refuse_a_deeper_stack(monkeypatch):
    """The kernels' stack is fixed at build time; a tree that may need more
    entries is refused at launch, not walked past the stack's end."""
    acc = _soup_acc(256, 0)
    o, d = _rays(256, 0, 1.0)
    rays = cl.pack_rays(tuple(o), tuple(d), torch.zeros(256, device="cuda"),
                        torch.ones(256, device="cuda"))
    monkeypatch.setattr(cl, "STACK_DEPTH", cl.STACK_DEPTH + 1)
    with pytest.raises(RuntimeError, match="closest-hit kernel launch failed"):
        cl.closest_hit(rays, acc)
    with pytest.raises(RuntimeError, match="any-hit kernel launch failed"):
        cl.any_hit(rays, acc)


def test_cuda_render_matches_cpu():
    scene = load_and_compile(str(CBOX_XML), spp=4, width=32, height=24, device="cpu")
    a = driver.render(scene.to("cuda"), seed=3, depth_cap=3)["rgb"].cpu().numpy()
    b = driver.render(scene, seed=3, depth_cap=3)["rgb"].numpy()
    # the splat adds in atomic order on the card
    assert abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean())
    assert np.abs(a - b).mean() <= 2e-2 * np.abs(b).mean()


def _fetch_case(N, L, seed):
    """An RGB table, taps with a fifth of them dead (w = 0, ids out of range)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    table = 4.0 * torch.rand((N, 3), device="cuda", generator=g) - 1.0
    idx = torch.randint(0, N, (4, L), device="cuda", generator=g, dtype=torch.int32)
    w = torch.rand((4, L), device="cuda", generator=g)
    dead = torch.rand((4, L), device="cuda", generator=g) < 0.2
    far = torch.where(torch.rand((4, L), device="cuda", generator=g) < 0.5, -5, N + 7)
    idx = torch.where(dead, far.to(torch.int32), idx)
    return table, idx.contiguous(), torch.where(dead, 0.0, w).contiguous()


@pytest.mark.parametrize("N,L", [(5000, 1 << 20), (5000, 257), (1, 1000), (1 << 23, 4096)])
def test_fetch4_matches_plain(N, L):
    table, idx, w = _fetch_case(N, L, L)
    before = tf.fetch_launches
    got = tf.fetch4(table, idx, w)
    assert tf.fetch_launches == before + 1
    assert torch.equal(got, tf.fetch4_plain(table, idx, w))


def test_fetch4_envlit_taps(tmp_path):
    """Bilinear envmap taps and mip-levelled bitmap taps of a small envlit
    scene, on the card, equal to the twin."""
    scene = load_and_compile(str(assets.write_assets(tmp_path, (64, 128), 64)))
    g = torch.Generator(device="cuda").manual_seed(2)
    u, v = (torch.rand(1 << 16, device="cuda", generator=g) for _ in range(2))
    taps = em.env_taps(scene, u, v)
    env = scene.emitters.env_rgb.reshape(-1, 3)
    assert torch.equal(tf.fetch4(env, *taps), tf.fetch4_plain(env, *taps))
    fp = 0.3 * torch.rand(1 << 16, device="cuda", generator=g)
    zero = torch.zeros_like(fp)
    taps = tex.bitmap_taps(scene, 0, 3 * u - 1, 3 * v - 1, ((fp, zero), (zero, fp)))
    assert torch.equal(tf.fetch4(scene.bitmaps, *taps), tf.fetch4_plain(scene.bitmaps, *taps))


def test_fetch4_raises_on_mixed_devices():
    table, idx, w = _fetch_case(100, 64, 0)
    with pytest.raises(ValueError):
        tf.fetch4(table.cpu(), idx, w)


@pytest.fixture(scope="module")
def small_envlit(tmp_path_factory):
    """The envlit scene with a 64x128 sky and a 64x64 floor, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    xml = assets.write_assets(tmp_path_factory.mktemp("envlit"), (64, 128), 64)
    return load_and_compile(str(xml))


def _launch_equals_twin(table, idx, w):
    """One launch of the kernel, equal to the twin to the bit."""
    before = tf.fetch_launches
    got = tf.fetch4(table, idx, w)
    assert tf.fetch_launches == before + 1
    assert torch.equal(got, tf.fetch4_plain(table, idx, w))


def _span_case(case, scene, g):
    """(table, idx4, w4) of one kind of tap set (see test_fetch4_span_cases)."""
    L = 1 << 14
    env = scene.emitters.env_rgb.reshape(-1, 3)
    We = scene.emitters.env_rgb.shape[1]
    r = torch.rand(L, device="cuda", generator=g)
    if case == "env_wrap_column":
        # u within half a texel of the seam: taps 1 and 3 wrap to column 0
        u = torch.remainder((r - 0.5) / We, 1.0)
        return (env, *em.env_taps(scene, u, torch.rand(L, device="cuda", generator=g)))
    if case == "bitmap_wrap_edge":
        W0 = scene.bitmap_meta[0][0]
        u = (r - 0.5) * 2.0 / W0 + torch.randint(-2, 3, (L,), device="cuda", generator=g)
        v = torch.where(r < 0.5, 1.0 - 0.7 / W0 * r, 0.7 / W0 * r)
        fp = torch.exp2(6.0 * torch.rand(L, device="cuda", generator=g)) / W0
        zero = torch.zeros_like(fp)
        return (scene.bitmaps, *tex.bitmap_taps(scene, 0, u, v, ((fp, zero), (zero, fp))))
    if case == "mixed_warp":
        # quads, with every third lane's taps random and every fifth lane's
        # second row dead
        idx, w = em.env_taps(scene, r, torch.rand(L, device="cuda", generator=g))
        odd = torch.arange(L, device="cuda") % 3 == 0
        rnd = torch.randint(0, env.shape[0], (4, L), device="cuda", generator=g,
                            dtype=torch.int32)
        idx = torch.where(odd[None], rnd, idx)
        w = w.clone()
        w[2:, torch.arange(L, device="cuda") % 5 == 0] = 0.0
        return env, idx.contiguous(), w.contiguous()
    if case == "all_dead_out_of_range":
        idx = torch.where(r < 0.5, -5, env.shape[0] + 7).to(torch.int32).expand(4, L)
        w = torch.where(torch.rand((4, L), device="cuda", generator=g) < 0.5, 0.0, 1.5)
        return env, idx.contiguous(), w.contiguous()
    if case == "env_nee":
        u2 = tuple(torch.rand(L, device="cuda", generator=g) for _ in range(2))
        _, _, u, v = em._env_sample_dir(scene, u2)
        return (env, *em.env_taps(scene, u, v))
    raise ValueError(case)


@pytest.mark.parametrize("case", ["env_wrap_column", "bitmap_wrap_edge", "mixed_warp",
                                  "all_dead_out_of_range", "env_nee"])
def test_fetch4_span_cases(small_envlit, case):
    """Tap sets that take the kernel's span loads, its per-tap loads, or both
    in one warp: quads at the envmap's wrap column and a bitmap's wrap edge,
    lanes mixing quads with random and dead taps, every tap dead with ids out
    of range, and the envmap's NEE taps."""
    g = torch.Generator(device="cuda").manual_seed(7)
    table, idx, w = _span_case(case, small_envlit, g)
    if case == "all_dead_out_of_range":
        assert not (tf.fetch4(table, idx, w) != 0).any()
    _launch_equals_twin(table, idx, w)


@pytest.mark.parametrize("N", [1, 2, 3, 5, 6, 7, 4097])
def test_fetch4_table_ends(N):
    """Tables of N texels, N no multiple of any padding: quads at the first
    and the last texel, whose 16-byte windows would pass the table's end."""
    g = torch.Generator(device="cuda").manual_seed(N)
    table = 4.0 * torch.rand((N, 3), device="cuda", generator=g) - 1.0
    L = 4096
    a = torch.where(torch.arange(L, device="cuda") % 2 == 0,
                    torch.randint(0, min(N, 4), (L,), device="cuda", generator=g),
                    torch.randint(max(N - 4, 0), N, (L,), device="cuda", generator=g))
    a = a.to(torch.int32)
    idx = torch.stack([a, a + 1, a - 1, a]).contiguous()
    w = torch.rand((4, L), device="cuda", generator=g)
    _launch_equals_twin(table, idx, w)


@pytest.mark.parametrize("head", [1, 2, 3])
def test_fetch4_raises_on_misaligned_table(head):
    """A table that starts `head` floats past a 16-byte boundary is refused:
    the kernel reads bilinear rows as 16-byte spans."""
    table, idx, w = _fetch_case(100, 64, head)
    buf = torch.empty(3 * 100 + 4, device="cuda")
    moved = buf[head: head + 300].view(100, 3)
    moved.copy_(table)
    before = tf.fetch_launches
    with pytest.raises(ValueError, match="16-byte"):
        tf.fetch4(moved, idx, w)
    assert tf.fetch_launches == before


def test_lever_profile_variants_match_plain(small_envlit, tmp_path):
    """Every variant of the lever profile, the port's fetch4 and a compared
    source (the port's own) equal the twin on every cell of the small
    envlit scene (the profile raises otherwise), each timed twice."""
    res = profile_texel_fetch_levers.profile([tf.SRC], reps=2, out=tmp_path / "l.md",
                                             scene=small_envlit)
    assert len(res["ms"]) == len(profile_texel_fetch_levers.VARIANTS) + 2
    for per in res["ms"].values():
        assert set(per) == set(profile_texel_fetch_levers.CELLS)
        assert all(len(t) == 2 and min(t) > 0 for t in per.values())
    assert "(N, 4) EF" in (tmp_path / "l.md").read_text()


def test_envlit_cuda_render_matches_cpu(tmp_path):
    xml = assets.write_assets(tmp_path, (64, 128), 64)
    scene = load_and_compile(str(xml), spp=4, width=32, height=24, device="cpu")
    a = driver.render(scene.to("cuda"), seed=3, depth_cap=3)["rgb"].cpu().numpy()
    b = driver.render(scene, seed=3, depth_cap=3)["rgb"].numpy()
    assert abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean())
    assert np.abs(a - b).mean() <= 2e-2 * np.abs(b).mean()


def test_gallery_cuda_render_matches_cpu(tmp_path):
    """Every BSDF kind, the bitmap roughness and the point light: the
    material gallery rendered on the card against the CPU."""
    xml = materials_assets.write_assets(tmp_path, res=32)
    scene = load_and_compile(str(xml), spp=2, width=32, height=24, device="cpu")
    a = driver.render(scene.to("cuda"), seed=3)["rgb"].cpu().numpy()
    b = driver.render(scene, seed=3)["rgb"].numpy()
    assert np.isfinite(a).all() and a.min() >= 0.0
    assert abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean())
    assert np.abs(a - b).mean() <= 2e-2 * np.abs(b).mean()


def test_stage_profile(tmp_path):
    res = profile_cluster_frame.profile(reps=2, out=tmp_path / "p.md")
    assert res["prim_equal"] >= 0.999 and res["prim_equal_empty"] == 1.0
    assert res["prim_equal_random"] >= 0.999
    assert res["launches"] == 4 * 3
    assert all(t > 0 for t in res["ms"].values())
    assert res["traversal"]["empty"]["nodes"]["max"] == 1
    assert "empty tree" in (tmp_path / "p.md").read_text()
