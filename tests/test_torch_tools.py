"""The port's kernel build helper and the closest-hit stage profiler, on the
CPU: library naming and build failures without nvcc, and the profiler's
schedule statistics on the bunny stand-in's camera rays."""

import shutil

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (caps torch's threads)

from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.tools import profile_cluster_frame as pcf
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
    # both libraries of the port are distinct
    assert len({cuda_build.library_path(s).name for s in cuda_build.CSRC.glob("*.cu")}) == 2


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
