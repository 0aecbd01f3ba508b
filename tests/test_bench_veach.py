"""The veach-mis-path cell on the CPU: the cell loads; its job through the
harness at a test's size (24x16 x 1 spp, the whole frame compared), traced
and not, and its refusal of a scene of another face count; the readers of
`nee_lane_share.frame` and `bsdf_kind_lane_share.frame` on synthetic
counters; and the four counters they read, counted by an eager frame and by
the replay of a recorded call."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import torch_helpers  # noqa: F401  (caps the threads)

from benchmark import harness
from benchmark import program_spans as ps
from benchmark import tracing as bench_tracing
from benchmark.test_bench_harness import BENCH, REPO
from misaki_tpu_torch.bsdf import kernels as bsdf
from misaki_tpu_torch.emitter import kernels as emitter
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.utils import tracing

CELL = "veach-mis-path"
XML = BENCH / "configs" / "scenes" / "veach-mis" / "scene.xml"
READERS = ("nee_lane_share.frame", "bsdf_kind_lane_share.frame")
COUNTERS = (tracing.NEE_LANES, tracing.NEE_SAMPLER_LANES, tracing.BSDF_LANES,
            tracing.BSDF_KIND_LANES)


def tiny_root(tmp_path, faces=None, spp=1):
    """The benchmark's data and readers in `tmp_path`, veach-mis cut to 24x16
    x `spp` (its 2 whole frames compared), and its face count set to
    `faces` where given."""
    root = tmp_path / "root"
    for d in ("configs", "traffic", "limits", "jobs", "metrics", "end_to_end"):
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = root / "benchmark" / "configs" / "veach-mis.json"
    c = json.loads(cfg.read_text())
    c.update(width=24, height=16, spp=spp)
    if faces is not None:
        c["faces"] = faces
    cfg.write_text(json.dumps(c))
    return root


@pytest.fixture(autouse=True)
def _threads():
    k = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(k)


def test_the_cell_loads_as_declared():
    cell = harness.load_cell(REPO, CELL, 1)
    cfg = cell.config
    assert (cfg["width"], cfg["height"], cfg["spp"], cfg["max_depth"]) == (768, 512, 16, 5)
    assert cfg["width"] * cfg["height"] * cfg["spp"] == 6 << 20     # 6 chunks of 2^20
    assert cfg["faces"] == 4 * 5120 + 4 * 2 + 2 * 2 and cfg["reduced"] == []
    assert cell.traffic["kind"] == "veach_path_frames" and cell.workload["chips"] == 1
    assert set(cell.limits) <= {"rgb_rel_l1", "rgb_max_rel"} and "rgb_rel_l1" in cell.limits
    names = {m["name"] for m in cell.metrics("per_layer")}
    assert {"nee_lane_share.frame", "bsdf_kind_lane_share.frame", "material_col_share.frame",
            "graph_replay_share.frame", "cast_roofline.frame", "device_idle.frame",
            "launches_per_frame", "bvh_nodes_per_ray.frame"} <= names
    assert {m["name"] for m in cell.metrics("end_to_end")} == {"frame_s", "peak_mem_gib",
                                                                "setup_s"}
    for w in ("cbox-path", "cbox-sierpinski-path"):
        assert not set(READERS) & {m["name"] for m in
                                   harness.load_cell(REPO, w, 1).metrics("per_layer")}


# the run in a process of its own: this one has loaded JAX, which the
# harness refuses in a run
RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark import harness
cell = harness.load_cell({root!r}, {cell!r}, 2 ** 31 + 77, device="cpu")
res = harness.run_cell(cell, 0.3, trace={trace!r}, err=lambda line: None)
print("RESULT " + json.dumps(res))
"""


def run_cell(root, trace=False):
    code = RUN.format(repo=str(REPO), root=str(root), cell=CELL, trace=trace)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("trace", [False, True])
def test_the_job_runs_its_set_up_step_and_check(tmp_path, trace):
    proc = run_cell(tiny_root(tmp_path), trace=trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    res = json.loads(line[len("RESULT "):])
    assert res["correct"] and res["attempted"] >= 1, res["checks"]
    assert set(res["checks"]) == set(json.loads(
        (BENCH / "limits" / f"{CELL}.json").read_text()))
    if trace:
        got = {k: v["value"] for k, v in res["metrics"].items()}
        assert got["nee_lane_share.frame"] == 0.25 and got["bsdf_kind_lane_share.frame"] == 0.5
        assert got["material_col_share.frame"] == 57 / 165


def test_the_job_refuses_another_face_count(tmp_path):
    proc = run_cell(tiny_root(tmp_path, faces=20491))
    assert proc.returncode != 0 and "RESULT" not in proc.stdout
    assert "faces" in proc.stderr


@pytest.mark.parametrize("fault", ["selection_pdf_1", "half_samples"])
def test_a_fault_planted_in_the_program_fails_the_check(tmp_path, fault):
    """The control's program-side faults, at 24x16 x 2 spp: next-event
    estimation without the 1/4 of its light's pick, and 1 of each pixel's 2
    samples; each fails the cell's limits, and the program is whole again
    after."""
    cell = harness.load_cell(tiny_root(tmp_path, spp=2), CELL, 2 ** 31 + 77, device="cpu")
    job = harness.job_module(cell)
    real = emitter.sample_emitter_direct
    got = job.control(cell, n_frames=2, fault=fault)
    correct, _ = harness.check_numbers(cell, got)
    assert not correct, got
    assert emitter.sample_emitter_direct is real
    with pytest.raises(ValueError, match="unknown fault"):
        job.control(cell, n_frames=2, fault="none_such")


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

class Run:
    trace, jobs_traced = None, 0


@pytest.mark.parametrize("counts,nee,kinds", [
    ({"nee.lanes": 1000, "nee.sampler_lanes": 4000, "bsdf.lanes": 300,
      "bsdf.kind_lanes": 600}, 0.25, 0.5),
    ({"nee.lanes": 7, "nee.sampler_lanes": 7, "bsdf.lanes": 5, "bsdf.kind_lanes": 5}, 1.0, 1.0),
    ({"nee.lanes": 0, "nee.sampler_lanes": 0, "bsdf.lanes": 0, "bsdf.kind_lanes": 0},
     None, None),
    ({"cast.closest.live": 640, "bsdf.cols.packed": 1000}, None, None),
    ({}, None, None),
    (None, None, None),
])
def test_the_readers(monkeypatch, counts, nee, kinds):
    monkeypatch.setattr(ps, "counts", lambda: counts)
    got = [harness.load_module(BENCH / "metrics" / f"{r}.py", f"t_{r}").read(Run)
           for r in READERS]
    assert got == [nee, kinds]


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def veach():
    return load_and_compile(str(XML), width=8, height=6, spp=1, device="cpu")


def test_an_eager_frame_counts_each_call(veach, tmp_path):
    """An 8x6 x 1 spp frame, depth cap 4, under the profiler: each of the 4
    bounces makes one NEE call over its 48 lanes, running 4 samplers, and
    3 BSDF calls, each computing 2 kinds."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with bench_tracing.span(bench_tracing.WINDOW):
            driver.render(veach, seed=3, chunk_size=64, depth_cap=4, progress=lambda *a: None)
    c = tracing.read()
    lanes = 8 * 6
    assert [c[k] for k in COUNTERS] == [4 * lanes, 4 * 4 * lanes, 3 * 4 * lanes,
                                        2 * 3 * 4 * lanes]


def test_a_replay_counts_the_recorded_calls(veach, tmp_path):
    """The calls recorded once (as a CUDA graph's capture records its
    Python) count again at each traced replay, and not untraced."""
    L = 100
    g = torch.Generator().manual_seed(4)
    p = tuple(torch.rand(L, generator=g) * 4.0 - 2.0 for _ in range(3))
    lam = 400.0 + 300.0 * torch.rand((4, L), generator=g)
    u = (torch.rand(L, generator=g), torch.rand(L, generator=g))
    ids = torch.arange(L, dtype=torch.int32) % 6
    slots = torch.zeros(len(tracing.DEVICE_COUNTERS), dtype=torch.int64)
    with tracing.recording(slots) as rec:
        emitter.sample_emitter_direct(veach, p, lam, u)
        mp = bsdf.material_params(veach, ids, (u[0], u[1]), lam)
        wi = (torch.zeros(L), torch.zeros(L), torch.ones(L))
        bsdf.eval_bsdf(mp, wi, wi)
        bsdf.pdf_bsdf(mp, wi, wi)
        bsdf.sample_bsdf(mp, wi, u[0], u)
    assert [rec.host[k] for k in COUNTERS] == [L, 4 * L, 3 * L, 6 * L]
    before = tracing.read()
    tracing.replayed(rec)
    assert tracing.read() == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.replayed(rec)
        tracing.replayed(rec)
    c = tracing.read()
    assert [c[k] for k in COUNTERS] == [2 * L, 8 * L, 6 * L, 12 * L]


def test_one_kind_and_one_emitter_count_share_one(tmp_path):
    """The Cornell box, one diffuse kind under one light: both shares 1."""
    from torch_helpers import CBOX_XML

    scene = load_and_compile(str(CBOX_XML), width=8, height=6, spp=1, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        driver.render(scene, seed=3, chunk_size=64, depth_cap=4, progress=lambda *a: None)
    c = tracing.read()
    assert c[tracing.NEE_LANES] == c[tracing.NEE_SAMPLER_LANES] > 0
    assert c[tracing.BSDF_LANES] == c[tracing.BSDF_KIND_LANES] > 0
