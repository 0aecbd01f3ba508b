"""The reader of `film_sum_ms.frame` (benchmark/metrics/) on a synthetic
trace, and the `cbox-path-4card` cell on the CPU: its ranks are gloo
processes and its configuration is cut as benchmark/test_bench_harness.py
cuts cbox (16x12 x 4 spp)."""

import json
import subprocess
import sys

import pytest

from benchmark import harness, tracing
from benchmark.test_bench_harness import BENCH, REPO, tiny_root

CELL = "cbox-path-4card"


@pytest.fixture
def reader():
    return harness.load_module(BENCH / "metrics" / "film_sum_ms.frame.py", "t_film_sum_frame")


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _trace(with_spans=True):
    """Two frames in a 1000 us window, each with a `misaki.film_sum` span
    on the window's thread that launches one all-reduce kernel (40 and 60
    us); a kernel launched outside the spans, and one launched on another
    thread inside a span's time, count for nothing."""
    spans = [_ev("misaki.film_sum", "user_annotation", 100, 50),
             _ev("misaki.film_sum", "user_annotation", 600, 50)] if with_spans else []
    return tracing.Trace(spans + [
        _ev(tracing.WINDOW, "user_annotation", 0, 1000),
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            "kernel", 120, 40, tid=7, correlation=1),
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            "kernel", 620, 60, tid=7, correlation=2),
        _ev("closest_hit_kernel(float const*, long long)", "kernel", 300, 200, tid=7,
            correlation=3),
        _ev("void at::native::vectorized_elementwise_kernel<4>", "kernel", 700, 10, tid=7,
            correlation=4),
        _ev("cuLaunchKernelEx", "cuda_driver", 110, 5, tid=1, correlation=1),
        _ev("cuLaunchKernelEx", "cuda_driver", 610, 5, tid=1, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 290, 5, tid=1, correlation=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 615, 5, tid=2, correlation=4),
    ])


@pytest.mark.parametrize("trace,jobs,want", [
    ("spans", 2, 0.05), ("spans", 1, 0.1), ("no_spans", 2, None), ("none", 0, None)])
def test_film_sum_ms_reads_the_kernels_launched_in_its_spans(reader, trace, jobs, want):
    t = {"spans": _trace(), "no_spans": _trace(with_spans=False), "none": None}[trace]
    got = reader.read(harness.Run(cell=None, trace=t, jobs_traced=jobs))
    assert got == (None if want is None else pytest.approx(want))


@pytest.fixture
def root(tmp_path):
    r = tiny_root(tmp_path)
    cfg = r / "benchmark" / "configs" / "cbox-4card.json"
    c = json.loads(cfg.read_text())
    c.update(width=16, height=12, spp=4)
    cfg.write_text(json.dumps(c))
    return r


# the run in a process of its own: this one has loaded JAX, which the
# harness refuses in a run
RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark import harness
from misaki_tpu_torch.parallel import sharding as sh
if {fault!r}:
    real = sh.lane_blocks
    def blocks(*a):
        out = real(*a)
        out[-1] = (out[-1][0], out[-1][0])
        return out
    sh.lane_blocks = blocks
cell = harness.load_cell({root!r}, {cell!r}, 2 ** 31 + 77, device="cpu")
res = harness.run_cell(cell, 0.3, trace={trace!r}, err=lambda line: None)
print("RESULT " + json.dumps(res))
"""


def run_cell(root, trace=False, fault=False):
    code = RUN.format(repo=str(REPO), root=str(root), cell=CELL, trace=trace, fault=fault)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_over_gloo_ranks(root, trace):
    res = run_cell(root, trace=trace)
    assert res["correct"], res["checks"]
    want = ({"entry_host_ms.frame", "bounce_host_ms.frame", "cast_host_ms.frame",
             "live_lane_share.frame", "graph_replay_share.frame", "rng_kernel_share.frame",
             "material_col_share.frame"}
            if trace else
            {"frame_s", "peak_mem_gib", "setup_s"})
    assert set(res["metrics"]) == want


def test_a_rank_that_renders_no_lanes_is_not_correct(root):
    res = run_cell(root, fault=True)
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_check_at_a_tiny_size(root):
    cell = harness.load_cell(root, CELL, 2 ** 31 + 5, device="cpu")
    correct, rows = harness.check_numbers(cell, harness.job_module(cell).control(cell))
    assert not correct, rows
