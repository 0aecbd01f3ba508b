"""The photon-mapping iteration as a CUDA graph (misaki_tpu_torch/render/ppm.py
`_capture`, render/graphs.py), held to the eager iteration on the card: cbox sppm and
photonmapper frames through the graph equal `ppm_iteration` in a loop to the
bit, for a frame that captures and for one of another seed that only
replays; a replaced scene table captures again; a frame resumed from a
snapshot is the uninterrupted one; and under a profiler a graph frame counts
what the eager frame counts, and its kernels show in the trace.

Marked `cuda`: every test skips where no CUDA device is present (a CUDA
graph has no CPU mode). This file imports no JAX; on a card:

    python -m pytest tests/test_torch_ppm_graph.py -q --noconftest
"""

import json

import pytest
import torch

from torch_helpers import SCENES

from benchmark import tracing as bench_tracing
from misaki_tpu_torch.render import ppm
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

W, H, PHOTONS, ITERS = 64, 48, 1 << 14, 4
BIG_SEED = (1 << 31) + 7


def _scene(integrator):
    """cbox under `integrator` at 64x48, 16,384 photons x 4 iterations, on
    the card; a new scene each call, so each holds its own graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    scene = load_and_compile(str(SCENES / "cbox" / f"{integrator}.xml"), width=W, height=H,
                             device="cpu")
    return scene.replace(ppm_photons=PHOTONS, ppm_iterations=ITERS).to("cuda")


def eager_frame(scene, seed, depth_cap=16):
    """The frame as `ppm_iteration` in a loop makes it, with no graph."""
    sppm_mode = scene.integrator == "sppm"
    budget = ppm.depth_budget(scene, depth_cap)
    r0 = ppm.initial_radius(scene)
    grid = ppm.scene_grid(scene, r0)
    with torch.inference_mode():
        st = ppm._initial_state(W * H, r0, scene.device)
        for it in range(scene.ppm_iterations):
            st = ppm.ppm_iteration(scene, st, it, seed, budget, sppm_mode, grid)
        return ppm._develop(scene, st, scene.ppm_iterations)


def _equal(got, want):
    assert torch.equal(got["rgb"], want["rgb"]) and torch.equal(got["alpha"], want["alpha"])


def _graph(scene):
    return scene.__dict__.get("_ppm_graph")


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_graph_frames_equal_eager_frames(integrator):
    """The frame that captures (its first iteration eager, the rest
    replays) and a frame of another seed that replays every iteration each
    equal their eager frame to the bit: a graph that baked its seed or its
    iteration fails the second."""
    scene = _scene(integrator)
    assert ppm.graph_eligible(scene.device, scene.bsdf_kinds, integrator == "sppm")
    first = ppm.render_ppm(scene, seed=3)
    graph = _graph(scene)
    assert graph is not None
    _equal(first, eager_frame(scene, 3))
    second = ppm.render_ppm(scene, seed=BIG_SEED)
    assert _graph(scene) is graph
    _equal(second, eager_frame(scene, BIG_SEED))
    assert not torch.equal(first["rgb"], second["rgb"])
    assert float(first["rgb"].mean()) > 0.01 and bool(torch.isfinite(first["rgb"]).all())


def test_a_replaced_table_captures_again():
    """A table replaced in the scene (the light's spectrum at half its
    radiance) drops the graph; the next frame captures anew and equals the
    eager frame of the new table."""
    scene = _scene("sppm")
    before = ppm.render_ppm(scene, seed=3)
    graph = _graph(scene)
    ppm.render_ppm(scene, seed=4)
    assert _graph(scene) is graph
    object.__setattr__(scene.emitters, "rad_curve", scene.emitters.rad_curve * 0.5)
    after = ppm.render_ppm(scene, seed=3)
    assert _graph(scene) is not graph
    _equal(after, eager_frame(scene, 3))
    ratio = float(after["rgb"].mean() / before["rgb"].mean())
    assert 0.3 < ratio < 0.7


def test_a_resumed_graph_frame_is_the_uninterrupted_one(tmp_path):
    """A frame stopped after its third iteration and resumed from the
    snapshot of its second, on the scene that holds the graph and on a new
    scene that captures at the resumed iteration, equals the uninterrupted
    frame to the bit; progress sees the resumed iterations."""
    scene = _scene("sppm")
    ref = ppm.render_ppm(scene, seed=4)
    ck = str(tmp_path / "ppm.npz")

    def stop(done, total):
        if done == 3:
            raise KeyboardInterrupt

    for resumed in (scene, _scene("sppm")):
        with pytest.raises(KeyboardInterrupt):
            ppm.render_ppm(scene, seed=4, checkpoint_path=ck, checkpoint_every=1,
                           progress=stop)
        seen = []
        out = ppm.render_ppm(resumed, seed=4, checkpoint_path=ck, checkpoint_every=1,
                             progress=lambda done, total: seen.append(done))
        assert seen == [3, 4]
        _equal(out, ref)
        assert _graph(resumed) is not None
    assert not (tmp_path / "ppm.npz").exists()


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_a_graph_frame_counts_what_the_eager_frame_counts(integrator, tmp_path):
    """Under a profiler (CPU and CUDA activities, as the benchmark's traced
    window), a frame of replays gives every counter of `tracing.read()` and
    every launch count the eager frame gives, and `ppm.graph.replays` one an
    iteration; the trace holds the same density kernels, one by one."""
    scene = _scene(integrator)
    ppm.render_ppm(scene, seed=5)     # the capture, outside the sessions

    def session(fn, name):
        torch.cuda.synchronize()      # no kernel of an earlier frame runs into the trace
        launched = dict(tracing.launches)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with bench_tracing.span(bench_tracing.WINDOW):
                fn()
                torch.cuda.synchronize()
        counts = tracing.read()
        path = tmp_path / f"{name}.json"
        prof.export_chrome_trace(str(path))
        trace = bench_tracing.Trace(json.loads(path.read_text())["traceEvents"])
        density = [k["name"] for k in trace.kernels if "density_" in k["name"]]
        return counts, {k: tracing.launches[k] - launched[k] for k in launched}, density

    graph, graph_launched, graph_density = session(
        lambda: ppm.render_ppm(scene, seed=6), "graph")
    eager, eager_launched, eager_density = session(lambda: eager_frame(scene, 6), "eager")
    assert graph[tracing.PPM_REPLAYS] == ITERS and eager[tracing.PPM_REPLAYS] == 0
    assert graph[tracing.PPM_ITERATIONS] == eager[tracing.PPM_ITERATIONS] == ITERS
    assert {k: v for k, v in graph.items() if k != tracing.PPM_REPLAYS} == {
        k: v for k, v in eager.items() if k != tracing.PPM_REPLAYS}
    assert eager[tracing.DENSITY_ALIVE] > 0 and eager[tracing.CAST_LIVE] > 0
    assert graph_launched == eager_launched
    assert sorted(graph_density) == sorted(eager_density)
    assert len(eager_density) == eager_launched["density_cuda"] > 0
