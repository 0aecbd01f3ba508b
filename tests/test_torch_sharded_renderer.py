"""The port's standing rank group (misaki_tpu_torch/parallel/sharding.py
`ShardedRenderer`) on the CPU: ranks 1..n-1 are processes of their own
joined to this test's process over gloo. Frames of one group against the
one-process `driver.render()` frame and against the benchmark's plain
reference under cbox-path's limits, a planted fault, ranks that raise or
die, the modules a rank loads, and the CLI's `--ranks`. The scene is the
benchmark's cbox at 32x24 x 4 spp, chunks of 2^9 lanes: two chunks a rank at
4 ranks."""

import contextlib
import json
import multiprocessing
import os
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_driver import _cli, read_exr
from torch_helpers import REPO, n

from benchmark import common
from benchmark.reference import path as ref_path
from benchmark.reference import scene as ref_scene
from misaki_tpu_torch.parallel import sharding as sh
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene.compiler import load_and_compile

XML = REPO / "benchmark" / "configs" / "scenes" / "cbox" / "scene.xml"
W, H, SPP, MAX_DEPTH = 32, 24, 4, 5
# cbox-path's traffic: depth cap 4; chunks cut to 2^9 lanes so that each of
# 4 ranks' 768-lane blocks takes a whole and a short chunk
KW = {"chunk_size": 1 << 9, "depth_cap": 4}
SEEDS = (0, 1, 2)
RTOL = 1e-5                 # float32 adds of 4 films in another order
LIMITS = json.loads((REPO / "benchmark" / "limits" / "cbox-path.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "misaki_tpu"}
# a failed group must raise well inside this (SPAWN_TIMEOUT is 10 minutes)
FAIL_S = 60.0


def assert_film_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def scene():
    return load_and_compile(str(XML), spp=SPP, width=W, height=H, max_depth=MAX_DEPTH,
                            device="cpu")


def _children():
    """The pids of this process's child processes, ended or not."""
    kids = set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == os.getpid():
            kids.add(int(pid))
    return kids


@contextlib.contextmanager
def _stderr_to(path):
    """fd 2 of this process, and of the processes it starts meanwhile (for
    their whole life), into the file `path`."""
    saved = os.dup(2)
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        os.dup2(saved, 2)
        os.close(saved)


def _imported(log):
    """The top-level names of the modules that PYTHONPROFILEIMPORTTIME
    logged in `log` ("import time: self | cumulative | name" lines)."""
    names = set()
    for line in log.read_text(errors="replace").splitlines():
        if line.startswith("import time:") and "imported package" not in line:
            names.add(line.rsplit("|", 1)[1].strip().split(".")[0])
    return names


def _no_lanes_for_rank_2(real):
    def blocks(*a):
        out = real(*a)
        out[2] = (out[2][0], out[2][0])
        return out
    return blocks


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """One group of 4 ranks, started with its ranks logging their imports:
    the frames of SEEDS in a row, then a frame of seed 0 with rank 2's block
    emptied (a planted fault) -> {"frames": {seed: film, rgb}, "fault": rgb,
    "ranks": the ranks' pids, "imported": top-level names the ranks
    imported, "left": child processes the closed group left}."""
    out = {"frames": {}}
    log = tmp_path_factory.mktemp("ranks") / "stderr.log"
    before = _children()
    with pytest.MonkeyPatch.context() as mp, _stderr_to(log):
        mp.setenv("PYTHONPROFILEIMPORTTIME", "1")
        group = sh.ShardedRenderer(scene, 4, device="cpu")
    with group:
        out["ranks"] = [p.pid for p in group._ctx.processes]
        for seed in SEEDS:
            f = group.render(seed=seed, **KW)
            out["frames"][seed] = (n(f["film"]), f["rgb"].clone())
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sh, "lane_blocks", _no_lanes_for_rank_2(sh.lane_blocks))
            out["fault"] = group.render(seed=0, **KW)["rgb"].clone()
    out["left"] = _children() - before
    out["imported"] = _imported(log)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_of_one_group_match_render(scene, runs, seed):
    """Frame after frame of one standing group equals the one-process
    frame, up to the order of float adds."""
    want = driver.render(scene, seed=seed, progress=lambda *a: None, **KW)
    got, _ = runs["frames"][seed]
    assert got.shape == (H, W, 5)
    assert_film_close(got, n(want["film"]))


def _reference_numbers(rgb, seed):
    ref = ref_path.render_rows(ref_scene.load(str(XML), spp=SPP, width=W, height=H,
                                              device="cpu", max_depth=MAX_DEPTH), seed, 0, H)
    return common.image_numbers([(rgb, ref)])


@pytest.mark.parametrize("case", ["sound", "rank_without_lanes"])
def test_frame_against_the_reference(runs, case):
    """The group's frame is within cbox-path's limits of the plain
    reference; with one rank rendering no lanes it is not."""
    rgb = runs["frames"][0][1] if case == "sound" else runs["fault"]
    numbers = _reference_numbers(rgb, 0)
    within = all(numbers[k] <= LIMITS[k] for k in LIMITS)
    assert within == (case == "sound"), numbers


def test_ranks_load_no_jax_and_leave_no_process(runs):
    """Ranks 1-3 are processes of their own that import the port and no
    JAX; the closed group leaves no process behind, neither a rank nor
    multiprocessing's resource tracker."""
    assert len(set(runs["ranks"]) | {os.getpid()}) == 4
    assert "misaki_tpu_torch" in runs["imported"]
    assert not FORBIDDEN & runs["imported"]
    assert not runs["left"]


def _misaligned_rank_1(real):
    def blocks(*a):
        out = real(*a)
        out[1] = (out[1][0] + 1, out[1][1])
        return out
    return blocks


def _alive(pid):
    return os.path.exists(f"/proc/{pid}")


@pytest.mark.parametrize("fault", ["raises", "killed", "film_left_out"])
def test_a_failed_rank_makes_rank_0_raise(scene, monkeypatch, fault):
    """A rank that raises (its block does not start on a pixel) or is
    killed makes rank 0's render raise soon, with that rank's error; a sum
    that leaves out a film (rank 0's, here) is refused. No process is left,
    and close() then does nothing."""
    before = _children()
    group = sh.ShardedRenderer(scene, 3, device="cpu")
    pids = [p.pid for p in group._ctx.processes]
    if fault == "raises":
        monkeypatch.setattr(sh, "lane_blocks", _misaligned_rank_1(sh.lane_blocks))
        want = "-- rank 1:\nTraceback"
    elif fault == "killed":
        os.kill(pids[0], signal.SIGKILL)
        want = "-- rank 1: ended with exit code -9"
    else:
        monkeypatch.setattr(sh, "mesh_sum", lambda x, mesh: x)
        want = "the film's sum holds 1 of 3 ranks' films"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        group.render(seed=0, **KW)
    assert time.monotonic() - t0 < FAIL_S
    assert want in f"{err.value}\n{err.value.__cause__}"
    if fault == "raises":
        assert "ValueError" in str(err.value)
    assert not any(_alive(p) for p in pids)
    assert not _children() - before
    assert not torch.distributed.is_initialized()
    group.close()
    with pytest.raises(RuntimeError, match="closed"):
        group.render(seed=0, **KW)


def test_cli_over_two_ranks_writes_the_one_process_image(tmp_path):
    flags = ["--device", "cpu", "--spp", SPP, "--width", W, "--height", H, "--depth", 4,
             "--seed", 3, "--chunk-log2", 9]
    _cli(XML, "-o", tmp_path / "one.exr", *flags, cwd=tmp_path)
    _cli(XML, "-o", tmp_path / "two.exr", *flags, "--ranks", 2, cwd=tmp_path)
    one, two = read_exr(tmp_path / "one.exr"), read_exr(tmp_path / "two.exr")
    assert list(two) == list(one) == ["A", "B", "G", "R"]
    for c in one:
        assert_film_close(two[c], one[c])


@pytest.mark.parametrize("poll_s", [0.0, 0.01])
def test_wait_for_watches_the_rank_processes(poll_s):
    """Rank 0's wait, looking at the rank processes between every two calls
    of `ready` (a frame's wait) or every `poll_s` (the ranks' start),
    returns once `ready` holds and raises once a rank process ends."""
    proc = multiprocessing.get_context("spawn").Process(target=time.sleep, args=(3.0,))
    proc.start()
    group = SimpleNamespace(_ctx=SimpleNamespace(processes=[proc]))
    calls = []
    sh.ShardedRenderer._wait_for(group, lambda: calls.append(1) or len(calls) > 3, poll_s)
    assert len(calls) == 4 and proc.is_alive()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a rank process ended"):
        sh.ShardedRenderer._wait_for(group, lambda: False, poll_s)
    assert time.monotonic() - t0 < FAIL_S
    proc.join()
