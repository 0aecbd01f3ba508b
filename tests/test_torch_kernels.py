"""The CUDA cluster kernels against their plain PyTorch twins, on the card.

Marked `cuda`: every test skips where no CUDA device is present (a CUDA
kernel has no CPU mode). Run them on a GPU machine with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(`--noconftest`: the suite's conftest sets up JAX, which a GPU machine for
the port need not have; this file imports no JAX.)

Bounds: face id equal on >= 99.9% of rays, t to rtol 1e-5 and the face row
exact where the face ids agree, occlusion equal on >= 99.99% of rays. The
kernels are built without fused multiply-add, so in practice they agree
bit for bit.
"""

import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML

from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene import procedural
from misaki_tpu_torch.scene.compiler import load_and_compile

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cluster kernels have no CPU mode")


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


def _compare(acc, o, d, maxt_occ):
    L = o.shape[1]
    mint = torch.full((L,), 1e-4, device="cuda")
    rays = cl.pack_rays(tuple(o), tuple(d), mint, torch.full((L,), float("inf"), device="cuda"))
    sched = cl.cull_order(rays, acc.bounds, acc.n_clusters)
    before = cl.closest_launches
    out_k, fd_k = cl.closest_hit(rays, acc.tri, acc.tab, *sched)
    assert cl.closest_launches == before + 1
    out_p, fd_p = cl.closest_hit_plain(rays, acc.tri, acc.tab, *sched)
    same = out_k[3] == out_p[3]
    assert same.float().mean().item() >= 0.999
    hit = same & (out_p[3] >= 0)
    assert hit.any()
    torch.testing.assert_close(out_k[0][hit], out_p[0][hit], rtol=1e-5, atol=0)
    assert torch.equal(fd_k[:, same], fd_p[:, same])

    srays = cl.pack_rays(tuple(o), tuple(d), mint, maxt_occ)
    ssched = cl.cull_order(srays, acc.bounds, acc.n_clusters)
    before = cl.anyhit_launches
    occ_k = cl.any_hit(srays, acc.tri, *ssched)
    assert cl.anyhit_launches == before + 1
    occ_p = cl.any_hit_plain(srays, acc.tri, *ssched)
    assert (occ_k == occ_p).float().mean().item() >= 0.9999


@pytest.mark.parametrize("F,L", [(1500, 600), (20000, 1 << 16), (128, 4096)])
def test_soup_kernels_match_plain(F, L):
    acc = _soup_acc(F, F)
    o, d = _rays(L, F, 1.5)
    _compare(acc, o, d, 1.5 * torch.ones(L, device="cuda"))


def test_bunny_kernels_match_plain():
    pos = procedural.bunny_standin()["positions"].astype(np.float64)
    acc = cl.build_clusters(pos[:, 0].astype(np.float32),
                            (pos[:, 1] - pos[:, 0]).astype(np.float32),
                            (pos[:, 2] - pos[:, 0]).astype(np.float32),
                            face_tab=np.zeros((36, len(pos)), np.float32)).to("cuda")
    o, d = _rays(1 << 16, 1, 0.15)
    _compare(acc, o, d, 0.1 * torch.ones(1 << 16, device="cuda"))


def test_cbox_kernels_match_plain():
    scene = load_and_compile(str(CBOX_XML), spp=64, width=64, height=64).to("cuda")
    lane = torch.arange(1 << 16, dtype=torch.int64, device="cuda") + 32 * 64 * 64
    ray, _, _ = driver.primary_rays(scene, lane, 0)
    _compare(scene.cluster, torch.stack(ray["o"]), torch.stack(ray["d"]),
             0.5 * ray["maxt"].clamp(max=2000.0))


def test_wrapper_raises_off_cuda_and_cpu():
    acc = _soup_acc(256, 0)
    o, d = _rays(256, 0, 1.0)
    rays = cl.pack_rays(tuple(o), tuple(d), torch.zeros(256, device="cuda"),
                        torch.ones(256, device="cuda"))
    order, keys, count = cl.cull_order(rays, acc.bounds, acc.n_clusters)
    with pytest.raises(ValueError):
        cl.any_hit(rays, acc.tri.cpu(), order, keys, count)


def test_cuda_render_matches_cpu():
    scene = load_and_compile(str(CBOX_XML), spp=4, width=32, height=24)
    a = driver.render(scene.to("cuda"), seed=3, depth_cap=3)["rgb"].cpu().numpy()
    b = driver.render(scene, seed=3, depth_cap=3)["rgb"].numpy()
    # the splat adds in atomic order on the card
    assert abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean())
    assert np.abs(a - b).mean() <= 2e-2 * np.abs(b).mean()
