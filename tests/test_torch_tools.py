"""The port's kernel build helper and the closest-hit stage profiler, on the
CPU: library naming and build failures without nvcc, and the profiler's
schedule statistics on the bunny stand-in's camera rays."""

import shutil

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
    scene = load_and_compile(str(pcf.BUNNY_XML), spp=1, width=64, height=64)
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


def test_stage_profile_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("runs the profile itself on a CUDA machine (tests/test_torch_kernels.py)")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcf.profile(out=tmp_path / "p.md")
