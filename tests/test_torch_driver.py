"""The port's driver features and CLI on the CPU: checkpoint/resume, the
progress callback and the debug integrator (the port's counterparts of
tests/test_driver_features.py and tests/test_render_e2e.py::
test_debug_integrator_bunny_style, on the in-repo cbox), and the command
line end to end, its EXR files read back by a minimal reader here."""

import logging
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML, FURNACE_XML, REPO, luminance_y, n

from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.scene.compiler import compile_scene, load_and_compile
from misaki_tpu_torch.scene.loader import load_string
from misaki_tpu_torch.scenes.envlit import assets

CHUNK = 32 * 4 * 6   # 6 pixel rows of the 32x24 x 4 spp frame: 4 chunks


@pytest.fixture(scope="module")
def scene():
    return load_and_compile(str(CBOX_XML), spp=4, width=32, height=24, device="cpu")


class Killed(RuntimeError):
    pass


def test_checkpoint_resume_bit_identical(scene, tmp_path):
    """A render killed after its second chunk (an exception from the progress
    callback) resumes from the snapshot to the uninterrupted film, to the
    bit; the completed render deletes the snapshot."""
    ref = driver.render(scene, seed=3, chunk_size=CHUNK, depth_cap=3)
    ck = str(tmp_path / "film.ckpt.npz")

    def killer(done, total):
        if done == 2:
            raise Killed()

    with pytest.raises(Killed):
        driver.render(scene, seed=3, chunk_size=CHUNK, depth_cap=3, checkpoint_path=ck,
                      checkpoint_every=1, progress=killer)
    assert os.path.exists(ck), "the snapshot survives the crash"
    seen = []
    out = driver.render(scene, seed=3, chunk_size=CHUNK, depth_cap=3, checkpoint_path=ck,
                        checkpoint_every=1, progress=lambda d, t: seen.append(d))
    # the callback raised before chunk 2's snapshot: the render resumes there
    assert seen == [2, 3, 4], "the resumed render starts at the snapshot's chunk"
    assert torch.equal(out["film"], ref["film"]) and torch.equal(out["rgb"], ref["rgb"])
    assert not os.path.exists(ck), "a completed render clears the snapshot"


def test_checkpoint_resume_aov_bit_identical(scene, tmp_path):
    """The aov integrator runs the same chunk loop: a render killed after its
    second chunk resumes to the uninterrupted images, to the bit; a snapshot
    of other outputs is refused."""
    sc = scene.replace(integrator="aov", aovs=("dd:depth", "uv"), aov_nested="direct")
    ref = driver.render(sc, seed=3, chunk_size=CHUNK, depth_cap=3)
    ck = str(tmp_path / "aov.ckpt.npz")

    def killer(done, total):
        if done == 2:
            raise Killed()

    with pytest.raises(Killed):
        driver.render(sc, seed=3, chunk_size=CHUNK, depth_cap=3, checkpoint_path=ck,
                      checkpoint_every=1, progress=killer)
    seen = []
    out = driver.render(sc, seed=3, chunk_size=CHUNK, depth_cap=3, checkpoint_path=ck,
                        checkpoint_every=1, progress=lambda d, t: seen.append(d))
    assert seen == [2, 3, 4] and out["film"] is None
    assert sorted(out["aovs"]) == ["dd", "uv"] and out["aovs"]["uv"].shape == (24, 32, 2)
    assert torch.equal(out["rgb"], ref["rgb"]) and torch.equal(out["alpha"], ref["alpha"])
    assert all(torch.equal(out["aovs"][k], ref["aovs"][k]) for k in ref["aovs"])
    assert not os.path.exists(ck)
    chunk = driver.pick_chunk(CHUNK, sc.spp, 32 * 24 * 4)
    assert (driver._scene_fingerprint(sc, 3, 3, chunk)
            != driver._scene_fingerprint(sc.replace(aovs=("dd:depth", "position")), 3, 3, chunk))


@pytest.mark.parametrize("other", ["seed", "chunk"])
def test_checkpoint_rejects_mismatched_render(scene, tmp_path, other, caplog):
    """A snapshot of another seed or chunk size is refused with a warning, and
    the render starts fresh."""
    ck = str(tmp_path / "film.ckpt.npz")
    n_total = scene.film_width * scene.film_height * scene.spp
    chunk = driver.pick_chunk(CHUNK, scene.spp, n_total)
    fp = driver._scene_fingerprint(scene, 3, 3, chunk)
    film = film_mod.new_film_flat(scene.film_height, scene.film_width, 5, scene.filter_type,
                                  scene.filter_stddev)
    driver.save_checkpoint(ck, film + 1.0, 2, fp)
    got = driver.load_checkpoint(ck, fp, scene.device)
    assert got is not None and got[1] == 2 and torch.equal(got[0], film + 1.0)

    seed, chunk_size = (4, CHUNK) if other == "seed" else (3, 2 * CHUNK)
    other_fp = driver._scene_fingerprint(scene, seed, 3, driver.pick_chunk(
        chunk_size, scene.spp, n_total))
    with caplog.at_level(logging.WARNING, logger="misaki_tpu_torch"):
        assert driver.load_checkpoint(ck, other_fp, scene.device) is None
        out = driver.render(scene, seed=seed, chunk_size=chunk_size, depth_cap=3,
                            checkpoint_path=ck)
    assert "does not match this render" in caplog.text
    fresh = driver.render(scene, seed=seed, chunk_size=chunk_size, depth_cap=3)
    assert torch.equal(out["rgb"], fresh["rgb"])


def test_progress_callback_sees_every_chunk(scene, caplog):
    seen = []
    driver.render(scene, seed=0, chunk_size=CHUNK, depth_cap=2,
                  progress=lambda done, total: seen.append((done, total)))
    assert seen == [(c, 4) for c in range(1, 5)]
    # the default reporter logs the chunks as they complete
    with caplog.at_level(logging.INFO, logger="misaki_tpu_torch"):
        driver.render(scene, seed=0, chunk_size=CHUNK, depth_cap=2)
    assert "render progress: 4/4 chunks (100%)" in caplog.text


def test_debug_integrator_bunny_style():
    """The debug integrator renders |shading normal| (integrators/debug.cpp):
    the furnace sphere's normals are visible, the background is black."""
    scene = compile_scene(load_string(open(FURNACE_XML).read()), spp=4,
                          device="cpu").replace(integrator="debug")
    rgb = n(driver.render(scene, seed=0)["rgb"])
    assert np.isfinite(rgb).all()
    assert rgb[14:18, 14:18].mean() > 0.2
    assert np.abs(rgb[:3, :3]).max() < 1e-6
    assert rgb.max() <= 1.0 + 1e-5


# ---------------------------------------------------------------------------
# the command line, and its EXR files
# ---------------------------------------------------------------------------

def read_exr(path):
    """A minimal OpenEXR reader for the files film.write_exr writes: one
    part, scan lines, no compression, FLOAT channels. Returns {channel:
    (H, W) float32}."""
    data = open(path, "rb").read()
    assert data[:4] == bytes.fromhex("762f3101")   # the magic number
    assert struct.unpack_from("<i", data, 4) == (2,)   # version 2, one scan-line part
    pos, attrs = 8, {}
    while data[pos] != 0:
        name_end = data.index(b"\0", pos)
        type_end = data.index(b"\0", name_end + 1)
        (size,) = struct.unpack_from("<i", data, type_end + 1)
        attrs[data[pos:name_end].decode()] = data[type_end + 5: type_end + 5 + size]
        pos = type_end + 5 + size
    pos += 1
    channels, c = [], 0
    raw = attrs["channels"]
    while raw[c] != 0:
        end = raw.index(b"\0", c)
        ptype, _, xs, ys = struct.unpack_from("<iBxxxii", raw, end + 1)
        assert (ptype, xs, ys) == (2, 1, 1)   # FLOAT, full resolution
        channels.append(raw[c:end].decode())
        c = end + 17
    assert channels == sorted(channels)
    assert attrs["compression"] == b"\0"
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    W, H = x1 - x0 + 1, y1 - y0 + 1
    offsets = np.frombuffer(data, "<u8", H, pos)
    planes = np.zeros((len(channels), H, W), np.float32)
    for y, off in enumerate(offsets):
        line_y, size = struct.unpack_from("<ii", data, int(off))
        assert line_y == y and size == len(channels) * W * 4
        planes[:, y] = np.frombuffer(data, "<f4", len(channels) * W, int(off) + 8).reshape(-1, W)
    return dict(zip(channels, planes))


def test_exr_round_trip(tmp_path):
    rs = np.random.default_rng(2)
    rgb = rs.normal(size=(5, 7, 3)).astype(np.float32) * 1e3
    alpha = rs.uniform(size=(5, 7)).astype(np.float32)
    film_mod.write_exr(tmp_path / "a.exr", torch.from_numpy(rgb), torch.from_numpy(alpha))
    got = read_exr(tmp_path / "a.exr")
    assert list(got) == ["A", "B", "G", "R"]
    for i, c in enumerate("RGB"):
        np.testing.assert_array_equal(got[c], rgb[..., i])
    np.testing.assert_array_equal(got["A"], alpha)
    film_mod.write_exr(tmp_path / "y.exr", rgb[..., 0])
    got = read_exr(tmp_path / "y.exr")
    assert list(got) == ["Y"]
    np.testing.assert_array_equal(got["Y"], rgb[..., 0])


def _cli(*args, cwd):
    res = subprocess.run([sys.executable, "-m", "misaki_tpu_torch.cli", *map(str, args)],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    return res.stderr


def test_cli_end_to_end(tmp_path):
    """-D, -I, --seed, --chunk-log2 and --checkpoint on the CPU; a PNG and an
    EXR whose pixels are the render's, and the default output name."""
    inc = tmp_path / "inc"
    inc.mkdir()
    text = open(FURNACE_XML).read()
    sky = text[text.index("    <emitter"): text.index("</scene>")]
    (inc / "sky.xml").write_text(f"<scene>\n{sky}</scene>\n")
    text = text.replace(sky, '    <include filename="sky.xml"/>\n')
    text = text.replace("<scene>", '<scene>\n    <default name="albedo" value="1.0"/>')
    text = text.replace('<spectrum name="reflectance" value="1.0"/>',
                        '<spectrum name="reflectance" value="$albedo"/>')
    xml = tmp_path / "furnace.xml"
    xml.write_text(text)
    flags = ["--device", "cpu", "--spp", 4, "-D", "albedo=0.5", "-I", inc, "--seed", 2,
             "--chunk-log2", 10, "--checkpoint", tmp_path / "ck.npz", "--checkpoint-every", 1]
    log = _cli(xml, "-o", tmp_path / "f.exr", *flags, cwd=tmp_path)
    assert "render progress: 4/4 chunks" in log and not (tmp_path / "ck.npz").exists()
    _cli(xml, "-o", tmp_path / "f.png", *flags, cwd=tmp_path)
    _cli(xml, *flags, cwd=tmp_path)   # hdrfilm: furnace.exr beside the XML
    assert (tmp_path / "f.png").stat().st_size > 0
    got = read_exr(tmp_path / "f.exr")
    np.testing.assert_array_equal(read_exr(tmp_path / "furnace.exr")["R"], got["R"])

    from misaki_tpu_torch.utils.fresolver import get_file_resolver

    get_file_resolver().append(inc)
    try:
        scene = load_and_compile(str(xml), {"albedo": "0.5"}, spp=4, device="cpu")
    finally:
        get_file_resolver().paths.remove(inc)
    want = driver.render(scene, seed=2, chunk_size=1 << 10)
    for i, c in enumerate("RGB"):
        np.testing.assert_array_equal(got[c], n(want["rgb"])[..., i])
    np.testing.assert_array_equal(got["A"], n(want["alpha"]))
    y = luminance_y(n(want["rgb"]))
    assert abs(float(y[14:18, 14:18].mean()) - 0.5) < 0.05   # albedo 0.5 came through -D


def test_cli_writes_one_exr_per_aov(tmp_path):
    xml = assets.write_assets(tmp_path, sky_shape=(16, 32), floor_res=16).with_name("aov.xml")
    _cli(xml, "-o", tmp_path / "a.exr", "--device", "cpu", "--spp", 1, "--width", 16,
         "--height", 12, cwd=tmp_path)
    scene = load_and_compile(str(xml), spp=1, width=16, height=12, device="cpu")
    want = driver.render(scene, seed=0)
    main = read_exr(tmp_path / "a.exr")
    np.testing.assert_array_equal(main["G"], n(want["rgb"])[..., 1])
    for name, img in want["aovs"].items():
        got = read_exr(tmp_path / f"a_{name}.exr")
        img = n(img)
        if img.shape[-1] == 1:
            assert list(got) == ["Y"]
            np.testing.assert_array_equal(got["Y"], img[..., 0])
        else:
            assert list(got) == ["B", "G", "R"]
            np.testing.assert_array_equal(got["G"], img[..., 1])
            if img.shape[-1] == 2:   # uv, padded with a zero channel
                assert not got["B"].any()
            else:
                np.testing.assert_array_equal(got["B"], img[..., 2])


def test_bench_prints_headline_first(capsys, monkeypatch):
    """The port's bench on the CPU at a tiny size: its first line is the
    headline JSON object; rays per sample count each integrator's casts; the
    extras keep their pinned depth cap whatever `--depth` says."""
    import json

    from misaki_tpu_torch.tools import bench

    assert bench.main(["--device", "cpu", "--spp", "1", "--width", "16", "--height", "16",
                       "--reps", "1", "--no-extra"]) == 0
    first = json.loads(capsys.readouterr().out.splitlines()[0])
    assert first["metric"] == "cbox_4bounce_rays_per_s" and first["value"] > 0
    assert first["device"] == "cpu"
    debug = load_and_compile(str(REPO / "misaki_tpu_torch/scenes/bunny_debug.xml"), spp=1,
                             width=8, height=8, device="cpu")
    direct = load_and_compile(str(REPO / "misaki_tpu_torch/scenes/cbox/direct.xml"), spp=1,
                              width=8, height=8, device="cpu")
    assert bench.rays_per_sample(debug, 4) == 1
    assert bench.rays_per_sample(direct, 4) == 5
    assert bench.rays_per_sample(direct.replace(integrator="path", max_depth=5), 4) == 9

    # the extras' frames stood in by one second each: what is timed, at which cap
    caps = []

    def one_second_frames(scene, reps, chunk, depth_cap):
        caps.append(depth_cap)
        n_samples = scene.film_width * scene.film_height * scene.spp
        return 1.0, n_samples * bench.rays_per_sample(scene, depth_cap)

    monkeypatch.setattr(bench, "time_frames", one_second_frames)
    extras = {}
    for depth in (2, 4):
        caps.clear()
        assert bench.main(["--device", "cpu", "--spp", "1", "--width", "16", "--height", "16",
                           "--depth", str(depth)]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert json.loads(lines[0])["metric"] == "cbox_4bounce_rays_per_s"
        extras[depth] = json.loads(lines[1])["extra"]
        assert caps == [depth, 4, 4]
    assert extras[2] == extras[4]
    assert extras[2]["figure2_roughconductor_rays_per_s"] == 320 * 180 * 16 * 9
