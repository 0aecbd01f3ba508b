"""The port's kernel build helper and its profilers, on the CPU: library
naming and build failures without nvcc, the closest-hit profiler's schedule
statistics on the bunny stand-in's camera rays, the texel-fetch profiles'
cells and bounds."""

import shutil

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (caps torch's threads)

from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.tools import profile_cluster_frame as pcf
from misaki_tpu_torch.tools import profile_texel_fetch as ptf
from misaki_tpu_torch.utils import cuda_build


def test_library_named_by_source_hash(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    first = cuda_build.library_path(src)
    assert first.parent == cuda_build.BUILD_DIR
    assert first.name.startswith("k_") and first.suffix == ".so"
    assert cuda_build.library_path(src) == first
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert cuda_build.library_path(src) != first
    # the port's four libraries are distinct
    srcs = sorted(cuda_build.CSRC.glob("*.cu"))
    assert [s.stem for s in srcs] == ["cluster", "pcg32", "ppm_density", "texel_fetch"]
    assert len({cuda_build.library_path(s).name for s in srcs}) == 4


def test_library_hash_covers_local_includes(tmp_path):
    """A source that includes another by a quoted path is rebuilt when the
    included file changes; a system include is not read."""
    (tmp_path / "inc").mkdir()
    inner = tmp_path / "inc" / "inner.cuh"
    inner.write_text("constexpr int k = 1;\n")
    src = tmp_path / "outer.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/inner.cuh"\nint f() { return k; }\n')
    first = cuda_build.library_path(src)
    inner.write_text("constexpr int k = 2;\n")
    assert cuda_build.library_path(src) != first


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: shutil.which("false"))
    srcs = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for s in srcs:
        s.write_text("// nothing\n")
    with pytest.raises(RuntimeError, match=r"nvcc failed on .*a\.cu[\s\S]*nvcc failed on .*b\.cu"):
        cuda_build.compile_sources(srcs)
    assert list((tmp_path / "build").iterdir()) == []    # no temporary left behind


def test_built_library_is_not_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise AssertionError("nvcc started for a library that exists")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    src = tmp_path / "c.cu"
    src.write_text("// built\n")
    so = cuda_build.library_path(src)
    so.write_bytes(b"")
    assert cuda_build.compile_sources([src]) == [so]


def test_schedule_stats_on_bunny_camera_rays():
    scene = load_and_compile(str(pcf.BUNNY_XML), spp=1, width=64, height=64, device="cpu")
    assert scene.cluster.n_clusters == 160
    lane = torch.arange(64 * 64, dtype=torch.int64)
    ray, _, _ = driver.primary_rays(scene, lane, 0)
    rays = cl.pack_rays(ray["o"], ray["d"], ray["mint"], ray["maxt"])
    _, _, count = cl.cull_order(rays, scene.cluster.bounds, scene.cluster.n_clusters)
    stats = pcf.schedule_stats(count, scene.cluster.n_clusters)
    assert stats["tiles"] == 64 * 64 // cl.R_TILE
    assert 0 < stats["visits_mean"] <= stats["visits_max"] <= 160
    assert stats["visits_p50"] <= stats["visits_p90"] <= stats["visits_max"]
    # camera rays are coherent: most tiles walk a short visit list
    assert stats["full_scan"] < stats["tiles"] // 4
    assert stats["visits_p50"] < 160


def test_cast_bounds_count_bytes():
    """The bound of a cast: each ray read and each result written once, the
    tree and faces read once, the distinct winners' face rows read once;
    bytes over the HBM rate dominate one Moller-Trumbore test per hit."""
    rs = np.random.default_rng(1)
    F, L = 300, 512
    p0, e1, e2 = (rs.uniform(-s, s, (F, 3)).astype(np.float32) for s in (1.0, 0.2, 0.2))
    acc = cl.build_clusters(p0, e1, e2, face_tab=np.ones((36, F), np.float32)).to("cpu")
    o = torch.from_numpy(rs.uniform(-1.5, 1.5, (3, L)).astype(np.float32))
    d = torch.from_numpy(rs.normal(size=(3, L)).astype(np.float32))
    rays = cl.pack_rays(tuple(o), tuple(d / d.norm(dim=0)), torch.zeros(L), torch.full((L,), 2.0))
    out, _ = cl.closest_hit(rays, acc)
    hit = out[3] >= 0
    assert 0 < hit.sum() < L
    tables = (acc.nodes.numel() + acc.leaf_tri.numel()) * 4
    winners = torch.unique(out[3][hit]).numel()
    ms, by = pcf.closest_bound(rays, acc, out)
    assert by == "bytes"
    assert ms == pytest.approx((L * (32 + 16 + 144) + tables + winners * 144) / 3.35e9)
    occ = cl.any_hit(rays, acc)
    ms, by = pcf.any_bound(rays, acc, occ)
    assert by == "bytes" and ms == pytest.approx((L * 36 + tables) / 3.35e9)
    ms, by = pcf.bound_ms(0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_stage_profile_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("runs the profile itself on a CUDA machine (tests/test_torch_kernels.py)")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcf.profile(out=tmp_path / "p.md")


def test_texel_fetch_profile_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the texel-fetch profile runs on a CUDA machine (chip_smoke.py phase 6)")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptf.profile(out=tmp_path / "p.md")


@pytest.mark.parametrize("w99,sectors,texels", [(0.0, 3, 4), (1.0, 4, 5)])
def test_fetch_sector_bytes(w99, sectors, texels):
    """Texels 0, 1, 2 and 8 of the (N, 3) table touch sectors {0, 1, 3}
    (texel 2 straddles sectors 0 and 1); texel 99 adds sector 37 when its
    tap is live, nothing when it is dead; the stream adds 44 B per lane."""
    table = torch.zeros((100, 3))
    idx = torch.tensor([[0, 1], [1, 2], [8, 99], [0, 8]], dtype=torch.int32)
    w = torch.tensor([[1.0, 1.0], [1.0, 1.0], [1.0, w99], [1.0, 1.0]])
    assert ptf.sector_bytes(table, idx, w) == sectors * 32 + 2 * 44
    ms, by, n = ptf.fetch_bound(table, idx, w)
    assert n == texels and by == "bytes"
    assert ms == pytest.approx((2 * 44 + texels * 12) / 3.35e9)


def test_texel_fetch_profile_cells(tmp_path):
    """The profile's cells on a small envlit scene on the CPU: every cell
    has its lanes and a contiguous (N, 3) table, the split launches their
    live taps, the L2 cell its 4 MB table."""
    from misaki_tpu_torch.render import texel_fetch as tf
    from misaki_tpu_torch.scenes.envlit import assets

    scene = load_and_compile(str(assets.write_assets(tmp_path, (64, 128), 64)), device="cpu")
    cells = ptf.make_cells(scene, n=4096)
    assert set(cells) == set(ptf.CELLS)
    for name, (table, idx4, w4) in cells.items():
        assert idx4.shape == w4.shape == (4, 4096) and idx4.dtype == torch.int32
        live = ptf.live_taps(table, idx4, w4).float().mean().item()
        # the raster lands on texel centres at odd levels: a weight of 0
        assert live == 0.0 if name == "split_dead" else live > (
            0.5 if name == "bitmap_camera_mips" else 0.99)
        assert table.shape[1] == 3 and table.is_contiguous()
        assert torch.equal(tf.fetch4(table, idx4, w4), tf.fetch4_plain(table, idx4, w4))
    assert (cells["split_hot"][1] == 0).all()
    assert cells["split_l2"][0].shape[0] == min((4 << 20) // 12, 64 * 128)
    # the NEE taps follow the sky's importance: fewer distinct texels
    assert (torch.unique(cells["env_nee"][1]).numel()
            < torch.unique(cells["env_random"][1]).numel())
