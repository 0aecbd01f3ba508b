"""CPU tests of the readers of the program's spans and counters
(`program_spans.py` and the metrics that use it) on synthetic traces: self
time of nested spans, the frame split, the forward's kernels, the counters'
ratios, and None where the trace or the program has nothing to read.

    python -m pytest benchmark/ -q
"""

import sys
import types

import pytest

from benchmark import harness, peaks, program_spans, tracing
from benchmark.test_bench_harness import BENCH, REPO, _ev, _run_with


def load(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


FRAME_READERS = ("entry_host_ms.frame", "bounce_host_ms.frame", "cast_host_ms.frame",
                 "density_host_ms.sppm")
NEW = FRAME_READERS + ("live_lane_share.frame", "density_roofline.sppm", "forward_ms.step")


def span(name, ts, dur, tid=1):
    return _ev(name, "user_annotation", ts, dur, tid=tid)


def frame_trace():
    """A 1000 us window, two jobs, on thread 1:
      frame [10, 410): chunk [20, 400) holding a camera cast [30, 50) and
        bounces [60, 200) and [200, 390); the first bounce a cast [70, 90)
        and an estimate [100, 150) holding a cast-free glossy estimate
        [110, 140) (nested, counted once); the second a cast [210, 260);
      frame [500, 990) with one bounce [520, 980) and a cast [600, 700)
        that runs past nothing;
    a cast on another thread and an aten op inside a bounce, neither a
    span of the window's thread."""
    return tracing.Trace([
        _ev(tracing.WINDOW, "user_annotation", 0, 1000),
        _ev(tracing.JOB, "user_annotation", 0, 450),
        _ev(tracing.JOB, "user_annotation", 450, 550),
        span("misaki.frame", 10, 400), span("misaki.chunk", 20, 380),
        span("misaki.cast", 30, 20),
        span("misaki.bounce", 60, 140), span("misaki.cast", 70, 20),
        span("misaki.density", 100, 50), span("misaki.density", 110, 30),
        span("misaki.bounce", 200, 190), span("misaki.cast", 210, 50),
        span("misaki.frame", 500, 490), span("misaki.bounce", 520, 460),
        span("misaki.cast", 600, 100),
        span("misaki.cast", 100, 800, tid=2),
        _ev("aten::add", "cpu_op", 300, 10),
    ])


def test_merged_and_minus():
    assert program_spans.merged([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3), (5, 10)]
    a = [(0, 10), (20, 30)]
    assert program_spans.minus(a, []) == 20
    assert program_spans.minus(a, [(2, 4), (8, 22), (25, 26), (29, 40)]) == 2 + 4 + 3 + 3
    assert program_spans.minus(a, [(-5, 50)]) == 0


def test_nested_self_time_and_the_frame_split():
    t = frame_trace()
    run = _run_with(t, 2)
    entry, bounce, cast, density = (load(n).read(run) for n in FRAME_READERS)
    # frames 400 + 490 us; bounces 140 + 190 + 460; casts 20 + 20 + 50 + 100;
    # estimates 50 (the nested one inside it)
    assert cast == pytest.approx((20 + 20 + 50 + 100) * 1e-3 / 2)
    assert density == pytest.approx(50e-3 / 2)
    assert bounce == pytest.approx((140 - 20 - 50 + 190 - 50 + 460 - 100) * 1e-3 / 2)
    assert entry == pytest.approx((400 - 20 - 140 - 190 + 490 - 460) * 1e-3 / 2)
    assert entry + bounce + cast + density == pytest.approx((400 + 490) * 1e-3 / 2)


def test_spans_are_clipped_to_the_window():
    t = tracing.Trace([_ev(tracing.WINDOW, "user_annotation", 100, 100),
                       span("misaki.cast", 50, 100), span("misaki.cast", 150, 100)])
    assert load("cast_host_ms.frame").read(_run_with(t, 1)) == pytest.approx(0.1)


def test_forward_reads_the_kernels_launched_inside_chunks():
    t = tracing.Trace([
        _ev(tracing.WINDOW, "user_annotation", 0, 1000),
        span("misaki.chunk", 100, 300),
        _ev("fwd_kernel", "kernel", 150, 40, tid=7, correlation=1),
        _ev("bwd_kernel", "kernel", 500, 70, tid=7, correlation=2),
        _ev("late_kernel", "kernel", 600, 5, tid=7, correlation=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 120, 5, tid=1, correlation=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 200, 5, tid=2, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 450, 5, tid=1, correlation=3),
    ])
    assert load("forward_ms.step").read(_run_with(t, 2)) == pytest.approx(0.040 / 2)


@pytest.fixture
def counters(monkeypatch):
    """The program's counters as `program_spans.counts` finds them."""
    values = {}
    fake = types.ModuleType("misaki_tpu_torch.utils.tracing")
    fake.read = lambda: dict(values)
    monkeypatch.setitem(sys.modules, "misaki_tpu_torch.utils.tracing", fake)
    import misaki_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "tracing", fake, raising=False)
    return values


def test_live_lane_share_and_density_roofline_from_the_counters(counters):
    counters.update({"cast.closest.rays": 1000, "cast.closest.live": 640,
                     "density.photons": 262144, "density.visible_points": 65536,
                     "density.alive": 131027, "density.contributing": 131027,
                     "density.live": 36983})
    assert load("live_lane_share.frame").read(_run_with(None, 0)) == pytest.approx(0.64)
    t = tracing.Trace([
        _ev(tracing.WINDOW, "user_annotation", 0, 1000),
        _ev("void density_gather_kernel<8>(float4 const*)", "kernel", 100, 100, tid=7),
        _ev("density_scan_kernel(int*, int)", "kernel", 300, 22, tid=7),
        _ev("closest_hit_kernel(float const*)", "kernel", 400, 50, tid=7),
    ])
    reader = load("density_roofline.sppm")
    # cbox sppm's first depth (PERF.md section 6, row 6): 10.47 MB
    need = reader.least_bytes(counters)
    assert need == 4 * (262144 + 6 * 131027 + 7 * 131027 + 65536 + 7 * 36983 + 5 * 65536)
    assert need == pytest.approx(10.47e6, rel=1e-3)
    got = reader.read(_run_with(t, 1))
    assert got == pytest.approx(100 * need / peaks.HBM_BYTES_PER_S / 122e-6)


def test_a_program_without_counters_gives_none(monkeypatch):
    import misaki_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "misaki_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing", raising=False)
    assert program_spans.counts() is None
    t = tracing.Trace([_ev(tracing.WINDOW, "user_annotation", 0, 10),
                       _ev("density_scan_kernel(int*)", "kernel", 1, 2, tid=7)])
    assert load("live_lane_share.frame").read(_run_with(t, 1)) is None
    assert load("density_roofline.sppm").read(_run_with(t, 1)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_gives_none_on_an_empty_trace(name, counters):
    counters.update(dict.fromkeys(("cast.closest.rays", "cast.closest.live", "density.photons",
                                   "density.visible_points", "density.alive",
                                   "density.contributing", "density.live"), 0))
    empty = tracing.Trace([_ev(tracing.WINDOW, "user_annotation", 0, 10)])
    assert load(name).read(_run_with(empty, 1)) is None


def test_every_new_metric_is_declared_for_the_cells_it_reads():
    cells = {w: harness.load_cell(REPO, w, 1) for w in ("cbox-path", "cbox-sppm", "cbox-train")}
    for w, cell in cells.items():
        names = {m["name"] for m in cell.metrics("per_layer")}
        want = {"cbox-path": set(NEW[:3]) | {"live_lane_share.frame"},
                "cbox-sppm": set(NEW[:6]),
                "cbox-train": {"forward_ms.step"}}[w]
        assert want <= names, w
