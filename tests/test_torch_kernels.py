"""The CUDA kernels (cluster closest hit and any hit, texel fetch, photon
density) against their plain PyTorch twins, on the card.

Marked `cuda`: every test skips where no CUDA device is present (a CUDA
kernel has no CPU mode). Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(`--noconftest`: the suite's conftest sets up JAX, which a GPU machine for
the port need not have; this file imports no JAX.)

Bounds: face id equal on >= 99.9% of rays, t to rtol 1e-5 and the face row
exact where the face ids agree, occlusion equal on >= 99.99% of rays. The
kernels are built without fused multiply-add, so in practice they agree
bit for bit. The texel fetch adds the same rounded products in the same
order as its twin: equal to the bit. The texel fetch's backward adds with
atomics in an order that varies from run to run: held to its twin with
allclose(rtol 1e-5, atol 1e-6 of the twin's largest magnitude). The
photon density kernel's counts equal the twin's and its flux sums are held
to the same allclose (a grid's cell order against the twin's matmuls), and
two calls on the same inputs give the same bits.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML, SCENES

from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.core import math as pmath
from misaki_tpu_torch.emitter import kernels as em
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import texel_fetch as tf
from misaki_tpu_torch.render import textures as tex
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.scenes.envlit import assets
from misaki_tpu_torch.scenes.materials import assets as materials_assets
from misaki_tpu_torch.tools import profile_cluster_frame, profile_ppm_density
from misaki_tpu_torch.tools.tie_case import merge_clusters
from misaki_tpu_torch.utils import tracing

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
    before = tracing.launches["closest"]
    out_k, fd_k = cl.closest_hit(rays, acc)
    assert tracing.launches["closest"] == before + 1
    out_p, fd_p = cl.closest_hit_plain(rays, acc)
    same = out_k[3] == out_p[3]
    assert same.float().mean().item() >= 0.999
    hit = same & (out_p[3] >= 0)
    assert bool(hit.any()) == expect_hits
    torch.testing.assert_close(out_k[0][hit], out_p[0][hit], rtol=1e-5, atol=0)
    assert torch.equal(fd_k[:, same], fd_p[:, same])
    assert torch.equal(out_k[0][out_p[3] < 0], out_p[0][out_p[3] < 0])

    srays = cl.pack_rays(tuple(o), tuple(d), mint, maxt_occ)
    before = tracing.launches["anyhit"]
    occ_k = cl.any_hit(srays, acc)
    assert tracing.launches["anyhit"] == before + 1
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
    before = tracing.launches["fetch"]
    got = tf.fetch4(table, idx, w)
    assert tracing.launches["fetch"] == before + 1
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
    before = tracing.launches["fetch"]
    got = tf.fetch4(table, idx, w)
    assert tracing.launches["fetch"] == before + 1
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
    before = tracing.launches["fetch"]
    with pytest.raises(ValueError, match="16-byte"):
        tf.fetch4(moved, idx, w)
    assert tracing.launches["fetch"] == before


def _backward_case(case, L=1 << 20, N=1 << 20):
    """(idx4, w4, grad_out, N) of one backward contention case: random taps
    into N texels (a fifth dead), camera-coherent bilinear quads (a few
    lanes per texel), or every live tap on one texel (the worst
    contention), or taps on five texels with a tenth of the ids out of
    range, over 2^20 + 13 lanes (every pattern of groups in a warp, dead
    taps among them, a last warp cut short). The one-texel case sums 3.4 M
    terms into one address, where two float32 summation orders differ by
    about sqrt(n) ulps of the partial sums (~1e-4 relative); in it and in
    the five-texel case the weights and gradients are halves, so every
    product and every partial sum is exact in float32 (below 2^22 in
    quarters) and any order of the adds gives the same bits."""
    g = torch.Generator(device="cuda").manual_seed(len(case))
    if case == "warp_groups":
        L += 13
    _, idx, w = _fetch_case(N, L, 7)
    if case == "coherent":
        side = 1 << 9
        lane = torch.arange(L, device="cuda")
        x = (lane % 2048).float() / 2048 * side
        y = (lane // 2048).float() / (L // 2048) * side
        j, i = x.floor().to(torch.int32), y.floor().to(torch.int32)
        a = i * side + j
        idx = torch.stack([a, a + 1, a + side, a + side + 1]).contiguous()
        w = torch.rand((4, L), device="cuda", generator=g)
    grad_out = torch.randn((3, L), device="cuda", generator=g)
    if case == "warp_groups":
        idx = torch.randint(0, 5, (4, L), device="cuda", generator=g, dtype=torch.int32)
        out = torch.rand((4, L), device="cuda", generator=g) < 0.1
        idx = torch.where(out, -1, idx).contiguous()
    if case in ("one_texel", "warp_groups"):
        if case == "one_texel":
            idx = torch.where(w != 0.0, 3, idx).contiguous()
        w = torch.where(w != 0.0, 0.5 + 0.5 * (w > 0.5).float(), 0.0).contiguous()
        grad_out = 0.5 * torch.randint(-1, 2, (3, L), device="cuda", generator=g).float()
    return idx, w, grad_out, N


REPEATS = 10    # calls of the backward kernel held to the twin per case


def _backward_matches(idx, w, grad_out, N, exact):
    """REPEATS calls of the backward kernel, each one launch, each allclose
    to the twin (rtol 1e-5, atol 1e-6 of its largest magnitude) and, on
    exact data, equal to it. Returns the last gradient."""
    want = tf.fetch4_backward_plain(idx, w, grad_out, N)
    atol = 1e-6 * want.abs().max().item()
    for _ in range(REPEATS):
        before = tracing.launches["fetch_bwd"]
        got = tf.fetch4_backward(idx, w, grad_out, N)
        torch.cuda.synchronize()
        assert tracing.launches["fetch_bwd"] == before + 1
        assert got.shape == (N, 3) and got.dtype == torch.float32 and got.is_contiguous()
        assert torch.allclose(got, want, rtol=1e-5, atol=atol)
        if exact:
            # every update landed, in whatever order
            assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("case", ["random", "coherent", "one_texel", "warp_groups"])
def test_fetch4_backward_matches_plain(case):
    """The backward kernel against its index_add_ twin at 2^20 lanes, in
    each of REPEATS calls: equal to rounding (atomics add in another order
    from run to run), to the bit on exact data."""
    idx, w, grad_out, N = _backward_case(case)
    got = _backward_matches(idx, w, grad_out, N, case in ("one_texel", "warp_groups"))
    if case == "one_texel":
        assert (got[3] != 0).all() and (got[:3] == 0).all() and (got[4:] == 0).all()
    if case == "warp_groups":
        assert (got[:5] != 0).any(dim=1).all() and (got[5:] == 0).all()


def _halves(w, g, L):
    """Exact data: live weights 0.5 or 1 and output gradients in {-0.5, 0,
    0.5}, so every product and partial sum is exact in float32."""
    w = torch.where(w != 0.0, 0.5 + 0.5 * (w > 0.5).float(), 0.0).contiguous()
    return w, 0.5 * torch.randint(-1, 2, (3, L), device="cuda", generator=g).float()


def test_fetch4_backward_table_overflow():
    """More distinct ids per block than its shared table can place: every
    id hashes (the kernel's multiplicative hash into 2^10 slots) into the
    same four slots, so past the first few the warp groups find no slot
    within their probes and go straight to device memory; the ids repeat,
    so they pass the seen-once filter and the table also merges (a lone
    product and a merged partial take the two device-memory paths). Exact
    data: equal to the twin."""
    N, L = 1 << 22, 1 << 20
    g = torch.Generator(device="cuda").manual_seed(21)
    ids = torch.arange(N, device="cuda", dtype=torch.int64)
    slot = (ids * 2654435761 % (1 << 32)) >> 22
    colliding = ids[slot < 4][:4096].to(torch.int32)
    assert colliding.numel() == 4096
    pick = torch.randint(0, colliding.numel(), (4, L), device="cuda", generator=g)
    idx = colliding[pick].contiguous()
    w, grad_out = _halves(torch.rand((4, L), device="cuda", generator=g), g, L)
    _backward_matches(idx, w, grad_out, N, exact=True)


@pytest.mark.parametrize("N", [1, 2, 1001])
def test_fetch4_backward_last_row(N):
    """Taps on the table's last texels, so that a 16-byte row of the scratch
    ends the buffer, mixed with dead taps past the end. Exact data."""
    L = 5000
    g = torch.Generator(device="cuda").manual_seed(N)
    idx = N - 1 - torch.randint(0, min(N, 3), (4, L), device="cuda", generator=g,
                                dtype=torch.int32)
    idx = torch.where(torch.rand((4, L), device="cuda", generator=g) < 0.1, N, idx)
    w, grad_out = _halves(torch.rand((4, L), device="cuda", generator=g), g, L)
    got = _backward_matches(idx.contiguous(), w, grad_out, N, exact=True)
    assert (got[N - 1] != 0).any()


def test_fetch4_backward_every_tap_dead():
    """Weights 0 or ids out of range on every tap: exact zeros."""
    N, L = 5000, (1 << 16) + 5
    g = torch.Generator(device="cuda").manual_seed(5)
    _, idx, w = _fetch_case(N, L, 5)
    out = torch.rand((4, L), device="cuda", generator=g) < 0.5
    idx = torch.where(out, torch.where(idx < 0, -1, N + 1), idx).to(torch.int32).contiguous()
    w = torch.where(out, w, 0.0).contiguous()
    grad_out = torch.randn((3, L), device="cuda", generator=g)
    got = _backward_matches(idx, w, grad_out, N, exact=True)
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("L", [1, 31, 257, 1000003])
def test_fetch4_backward_ragged_lanes(L):
    """L not a multiple of a warp, a tile or a block's range: random and
    coherent taps (a tenth of the lanes on one of 64 texels) into 2^16
    texels."""
    N = 1 << 16
    _, idx, w = _fetch_case(N, L, L)
    g = torch.Generator(device="cuda").manual_seed(L)
    hot = torch.rand((4, L), device="cuda", generator=g) < 0.1
    hot_ids = torch.randint(0, 64, (4, L), device="cuda", generator=g, dtype=torch.int32)
    idx = torch.where(hot & (w != 0), hot_ids, idx).contiguous()
    grad_out = torch.randn((3, L), device="cuda", generator=g)
    _backward_matches(idx, w, grad_out, N, exact=False)


def test_fetch4_backward_two_tables_in_one_pass():
    """Two fetches from tables of different sizes, interleaved in one
    autograd pass (a bitmap and an envmap in one frame): each table's
    gradient is its own fetch's, one backward launch each."""
    ta, ia, wa = _fetch_case(5000, 1 << 16, 8)
    tb, ib, wb = _fetch_case(70001, 1 << 16, 9)
    ta, tb = ta.requires_grad_(), tb.requires_grad_()
    b0 = tracing.launches["fetch_bwd"]
    loss = ((tf.fetch4(ta, ia, wa) * tf.fetch4(tb, ib, wb)).sum()
            + tf.fetch4(ta, ib % 5000, wb).sum())
    loss.backward()
    torch.cuda.synchronize()
    assert tracing.launches["fetch_bwd"] == b0 + 3
    a2, b2 = ta.detach().clone().requires_grad_(), tb.detach().clone().requires_grad_()
    ((tf.fetch4_plain(a2, ia, wa) * tf.fetch4_plain(b2, ib, wb)).sum()
     + tf.fetch4_plain(a2, ib % 5000, wb).sum()).backward()
    for got, want in ((ta.grad, a2.grad), (tb.grad, b2.grad)):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


def test_fetch4_autograd_on_the_card():
    """Fetch4 on CUDA tensors: the forward launches the forward kernel and
    equals the twin to the bit; backward launches the backward kernel once
    and gives the twin's gradients (the weights' in plain PyTorch)."""
    table, idx, w = _fetch_case(5000, 1 << 16, 3)
    table = table.requires_grad_()
    w = w.requires_grad_()
    f0, b0 = tracing.launches["fetch"], tracing.launches["fetch_bwd"]
    out = tf.fetch4(table, idx, w)
    assert tracing.launches["fetch"] == f0 + 1
    assert torch.equal(out.detach(), tf.fetch4_plain(table.detach(), idx, w.detach()))
    g_out = torch.randn_like(out)
    out.backward(g_out)
    assert tracing.launches["fetch_bwd"] == b0 + 1
    t2, w2 = table.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    tf.fetch4_plain(t2, idx, w2).backward(g_out)
    assert torch.allclose(table.grad, t2.grad, rtol=1e-5, atol=1e-6 * t2.grad.abs().max().item())
    assert torch.allclose(w.grad, w2.grad, rtol=1e-5, atol=1e-6)


def test_no_backward_launch_in_an_inference_frame(small_envlit):
    """A frame under render()'s inference_mode launches the forward fetch
    and never the backward, even with leaves that require grad."""
    from misaki_tpu_torch.diff import get_leaves, replace_leaves

    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in get_leaves(small_envlit, ("bitmaps", "env_rgb")).items()}
    scene = replace_leaves(small_envlit, leaves).replace(spp=1)
    f0, b0 = tracing.launches["fetch"], tracing.launches["fetch_bwd"]
    driver.render(scene, depth_cap=2, progress=lambda d, t: None)
    torch.cuda.synchronize()
    assert tracing.launches["fetch"] > f0
    assert tracing.launches["fetch_bwd"] == b0


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


def test_cuda_sqrt_correctly_rounded():
    """On the card the port's sqrt is torch.sqrt, which must be correctly
    rounded as the CPU's float64 route is: equal to the float64 root rounded
    once, on 2^20 random float32 inputs and on 0, inf and a subnormal."""
    rs = np.random.default_rng(17)
    x = np.exp2(rs.uniform(-40, 40, 1 << 20)).astype(np.float32)
    x[:4] = [0.0, np.inf, 1e-40, 1.0]
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = pmath.sqrt(torch.from_numpy(x).cuda()).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["bunny_debug", "direct", "aov"])
def test_new_integrators_on_the_card(name, tmp_path):
    """debug, direct and aov on the card: each chunk launches the kernels its
    structure implies (debug one closest hit; direct one plus one per BSDF
    sample and an any hit per emitter sample; aov its own cast beside the
    nested path's), and the images agree with the CPU's."""
    if name == "aov":
        xml = assets.write_assets(tmp_path, sky_shape=(32, 64), floor_res=32).with_name(
            "aov.xml")
    else:
        xml = SCENES / ("bunny_debug.xml" if name == "bunny_debug" else "cbox/direct.xml")
    scene = load_and_compile(str(xml), spp=2, width=32, height=24, device="cpu")
    iters = 4 if name == "aov" else 0
    want = {"bunny_debug": (1, 0), "direct": (3, 2), "aov": (2 + iters, iters)}[name]
    tracing.reset_launches()
    a = driver.render(scene.to("cuda"), seed=3)
    assert (tracing.launches["closest"], tracing.launches["anyhit"]) == want
    b = driver.render(scene, seed=3)
    for key in ["rgb", *b.get("aovs", {})]:
        x, y = ((o["rgb"] if key == "rgb" else o["aovs"][key]).cpu().numpy() for o in (a, b))
        assert np.isfinite(x).all(), key
        assert abs(x.mean() - y.mean()) <= 5e-3 * max(np.abs(y).mean(), 1e-12), key
        assert np.abs(x - y).mean() <= 2e-2 * max(np.abs(y).mean(), 1e-12), key


def test_resume_bit_identical_on_the_card(tmp_path):
    """A render stopped after its second chunk and resumed from the snapshot
    equals the uninterrupted film to the bit on the card: the splat's adds
    run in a fixed order."""
    scene = load_and_compile(str(CBOX_XML), spp=4, width=32, height=24)
    chunk, ck = 32 * 4 * 6, str(tmp_path / "film.npz")
    ref = driver.render(scene, seed=3, chunk_size=chunk, depth_cap=3)

    def stop(done, total):
        if done == 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        driver.render(scene, seed=3, chunk_size=chunk, depth_cap=3, checkpoint_path=ck,
                      checkpoint_every=1, progress=stop)
    out = driver.render(scene, seed=3, chunk_size=chunk, depth_cap=3, checkpoint_path=ck,
                        checkpoint_every=1)
    assert out["film"].device.type == "cuda"
    assert torch.equal(out["film"], ref["film"])


@pytest.mark.parametrize("sppm_mode", [True, False])
def test_density_kernel_matches_twin(sppm_mode):
    """The density kernel against its plain twin on the card, on 3000
    visible points and 5000 photons around them (neither a multiple of the
    block): the counts equal (the same float32 pair tests, no fused
    multiply-add), phi allclose(rtol 1e-5, atol 1e-6 of the twin's largest
    magnitude): the kernel sums the flux in cell order, the twin by
    matmuls; a second estimate gives phi equal to the bit. One estimate
    (over a grid of the unit cube, cells of the largest radius), counted
    once; without a grid the estimate raises."""
    from misaki_tpu_torch.render import ppm

    rs = np.random.default_rng(4)
    L, P = 3000, 5000

    def unit(k):
        v = rs.normal(size=(3, k))
        return tuple(torch.tensor(c, dtype=torch.float32, device="cuda")
                     for c in v / np.linalg.norm(v, axis=0))

    def cuda(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device="cuda")

    vp_p = rs.uniform(0.0, 1.0, (3, L))
    vp = {"p": tuple(cuda(c) for c in vp_p), "wi": unit(L), "n": unit(L),
          "valid": cuda(rs.uniform(size=L) < 0.9, torch.bool),
          "glossy": cuda(rs.uniform(size=L) < 0.1, torch.bool)}
    r2 = cuda(rs.uniform(0.03, 0.08, L) ** 2)
    near = rs.integers(0, L, P)
    ph_p = tuple(cuda(c) for c in vp_p[:, near] + rs.normal(0.0, 0.04, (3, P)))
    args = (vp, r2, ph_p, unit(P), unit(P), cuda(rs.uniform(0.0, 2.0, (4, P))),
            cuda(rs.uniform(size=P) < 0.8, torch.bool), sppm_mode)
    grid = ppm.density_grid((0.5, 0.5, 0.5), 0.5, 0.08)
    before = tracing.launches["density"]
    phi, count = ppm.density_estimate(*args, grid=grid)
    torch.cuda.synchronize()
    assert tracing.launches["density"] == before + 1
    phi_t, count_t = ppm.density_plain(*args)
    assert torch.equal(count, count_t) and float(count.sum()) > 1000
    scale = float(phi_t.abs().max())
    torch.testing.assert_close(phi, phi_t, rtol=1e-5, atol=1e-6 * scale)
    assert torch.equal(ppm.density_estimate(*args, grid=grid)[0], phi)
    with pytest.raises(ValueError, match="grid"):
        ppm.density_estimate(*args)


@pytest.mark.parametrize("sppm_mode", [True, False])
@pytest.mark.parametrize("case", profile_ppm_density.CASES + ("mixed",))
def test_density_kernel_adversarial(case, sppm_mode):
    """The grid kernel against the dense twin on the adversarial cases of
    tools/profile_ppm_density.py (photons at the largest float32 distance
    that passes, on cell boundaries, in one cell, outside the grid, at inf
    and NaN; radii varying 100x, one beyond a cell; no photons): counts
    equal, phi allclose, and two calls equal to the bit; the pairs tested
    are those of `density_binned_plain`."""
    from misaki_tpu_torch.render import ppm

    pd = profile_ppm_density
    data = pd.mixed() if case == "mixed" else pd.adversarial(case)
    args = pd.to_args(*data, sppm_mode, "cuda")
    grid = pd.adversarial_grid()
    ph, vps = ppm.pack_inputs(*args[:-1])
    stats, plain_stats = {}, {}
    lib = ppm.build()
    res = pd.check(lambda: ppm.density_launch(lib, ph, vps, sppm_mode, grid, stats=stats,
                                              pair_tests=True),
                   ppm.density_plain(*args), calls=2)
    assert res["ok"], res
    ppm.density_binned_plain(*args, grid, stats=plain_stats)
    assert int(stats["pair_tests"].item()) == plain_stats["pair_tests"]


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_ppm_on_the_card(integrator):
    """A small cbox photon-mapping render on the card: per iteration D
    camera and D photon closest-hit casts, D shadow casts in sppm, D - 1
    density launches in sppm and D in the photonmapper, each 11 CUDA
    kernels; the image agrees with the CPU's (means within 0.5%, relative
    L1 < 2%)."""
    from misaki_tpu_torch.render import ppm

    scene = load_and_compile(str(SCENES / "cbox" / f"{integrator}.xml"), width=32, height=24,
                             device="cpu").replace(ppm_photons=4096, ppm_iterations=2)
    D, sppm = ppm.depth_budget(scene, 16), integrator == "sppm"
    tracing.reset_launches()
    a = driver.render(scene.to("cuda"), seed=3)["rgb"].cpu().numpy()
    n = tracing.launches
    assert (n["closest"], n["anyhit"], n["density"]) == (
        2 * 2 * D, 2 * D if sppm else 0, 2 * (D - 1 if sppm else D))
    # the frame's grid has 81^3 cells: three sort passes, 11 CUDA kernels
    assert n["density_cuda"] == 11 * n["density"]
    b = driver.render(scene, seed=3)["rgb"].cpu().numpy()
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) <= 5e-3 * b.mean()
    assert np.abs(a - b).mean() <= 2e-2 * b.mean()


# ---------------------------------------------------------------------------
# PCG32 (csrc/pcg32.cu) against its twins in core/rng.py
# ---------------------------------------------------------------------------

PCG32_SEEDS = [0, 1, 7, 2654435761, 0xFFFFFFFF]   # test_torch_rng.py's SEEDS


def _pcg32_lanes():
    """2^20 lanes: the first 2^19, then runs up to 2^31 and 2^32 - 1."""
    half = 1 << 19
    return torch.cat([torch.arange(half), torch.arange(2 ** 31 - half // 2, 2 ** 31 + half // 4),
                      torch.arange(2 ** 32 - half // 4, 2 ** 32)]).to(torch.int64)


def _assert_limbs_equal(got, want):
    from misaki_tpu_torch.core import rng

    for name in rng.LIMBS:
        assert torch.equal(got[name].cpu(), want[name].expand_as(got[name])), name


@pytest.mark.parametrize("words", ["ints", "tensors"])
@pytest.mark.parametrize("seed", PCG32_SEEDS)
def test_pcg32_seed_matches_twin(seed, words):
    """The seeding kernel's limbs equal the twin's to the bit over 2^20
    lanes, for driver.make_rng's streams, ppm's (a lane offset), and a
    generic seed (the photon frames' wavelength stream), with the words
    given as Python ints and as (1,) int64 device tensors; one launch each."""
    from misaki_tpu_torch.core import rng
    from misaki_tpu_torch.render import ppm

    lanes = _pcg32_lanes()
    assert lanes.numel() == 1 << 20
    w = driver.seed_words(seed)
    pw = ppm.iteration_words(3, seed)

    def dev(x):
        return torch.tensor([x], dtype=torch.int64, device="cuda") if words == "tensors" else x

    before = tracing.launches["pcg32"]
    got = driver.make_rng(lanes.cuda(), tuple(dev(x) for x in w))
    _assert_limbs_equal(got, driver.make_rng(lanes, w))
    got = ppm._lane_rng(lanes.cuda(), dev(0x400000), dev(pw.photon_state),
                        dev(pw.photon_mix), dev(pw.seq))
    _assert_limbs_equal(got, ppm._lane_rng(lanes, 0x400000, pw.photon_state, pw.photon_mix,
                                           pw.seq))
    it = torch.tensor([3], dtype=torch.int64)
    got = rng.seed((0xA511E9B3, it.cuda()), (dev(seed & 0xFFFFFFFF), 7))
    _assert_limbs_equal(got, rng.seed((0xA511E9B3, it), (seed & 0xFFFFFFFF, 7)))
    assert tracing.launches["pcg32"] == before + 3


@pytest.mark.parametrize("k", [1, 2, 3, 5, 6, 9])
def test_pcg32_next_floats_matches_twin(k):
    """k draws in one launch equal k twin draws, floats and state, to the
    bit, over 2^20 lanes of two seeds; the state passed in is unchanged, and
    a second launch from it gives the same bits."""
    from misaki_tpu_torch.core import rng

    lanes = _pcg32_lanes()
    for seed in (PCG32_SEEDS[1], PCG32_SEEDS[-1]):
        cpu = driver.make_rng(lanes, seed)
        gpu = driver.make_rng(lanes.cuda(), seed)
        kept = {name: v.clone() for name, v in gpu.items()}
        before = tracing.launches["pcg32"]
        got, got_state = rng.next_floats(gpu, k)
        assert tracing.launches["pcg32"] == before + 1
        want, want_state = rng.next_floats_plain(cpu, k)
        for g, wv in zip(got, want, strict=True):
            assert torch.equal(g.cpu().view(torch.int32), wv.view(torch.int32))
        _assert_limbs_equal(got_state, want_state)
        _assert_limbs_equal(gpu, {name: v.cpu() for name, v in kept.items()})
        again, _ = rng.next_floats(gpu, k)
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("case", ["cpu_limb", "int32_limb", "short_limb", "cpu_word",
                                  "int32_word"])
def test_pcg32_wrappers_raise(case):
    """A state or seeding with a limb or word on another device, of another
    type than int64, or of another length than the lanes' is refused, and
    nothing is launched."""
    from misaki_tpu_torch.core import rng

    lanes = torch.arange(4096, dtype=torch.int64, device="cuda")
    state = driver.make_rng(lanes, 5)
    before = tracing.launches["pcg32"]
    with pytest.raises(ValueError):
        if case == "cpu_limb":
            rng.next_floats({**state, "inc_hi": state["inc_hi"].cpu()}, 3)
        elif case == "int32_limb":
            rng.next_floats({**state, "lo": state["lo"].to(torch.int32)}, 3)
        elif case == "short_limb":
            rng.next_floats({**state, "inc_lo": state["inc_lo"][:100]}, 3)
        elif case == "cpu_word":
            rng.seed_lanes(lanes, torch.ones(1, dtype=torch.int64), 0, 1)
        else:
            rng.seed_lanes(lanes, 1, torch.ones(1, dtype=torch.int32, device="cuda"), 1)
    assert tracing.launches["pcg32"] == before
