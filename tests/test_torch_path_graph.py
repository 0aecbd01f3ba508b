"""The path chunk as a CUDA graph (misaki_tpu_torch/render/driver.py
`_graph_chunk`, render/graphs.py), held to the eager chunk on the card:
cbox frames under path, direct, volpath and debug through the graph equal
`_render_chunk` in a loop to the bit, for a frame that captures and for one
of another seed that only replays; a frame with a tail chunk; a replaced
scene table captures again; a frame resumed from a snapshot is the
uninterrupted one; a returned film is not changed by the next frame; under
a profiler a graph frame counts what the eager frame counts; the other
scenes of the repository capture and replay to the bit; and, on four
cards, a `ShardedRenderer` frame that replays equals the frame that
captured.

Marked `cuda`: every test skips where no CUDA device is present (a CUDA
graph has no CPU mode), the four-rank test where fewer than four are. This
file imports no JAX; on a card:

    python -m pytest tests/test_torch_path_graph.py -q --noconftest
"""

import json

import pytest
import torch

from torch_helpers import SCENES

from benchmark import tracing as bench_tracing
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

W, H, SPP, DEPTH = 64, 48, 4, 4
N_TOTAL = W * H * SPP
CHUNK = N_TOTAL // 3          # three full chunks
BIG_SEED = (1 << 31) + 7


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")


def _scene(integrator=None, xml=SCENES / "cbox" / "scene.xml", w=W, h=H):
    """The scene of `xml` at w x h x SPP on the card, under `integrator`
    where given; a new scene each call, so each holds its own graph."""
    _cuda()
    scene = load_and_compile(str(xml), spp=SPP, width=w, height=h, device="cpu")
    if integrator not in (None, scene.integrator):
        scene = scene.replace(integrator=integrator)
    return scene.to("cuda")


def eager_frame(scene, seed, chunk=CHUNK, depth_cap=DEPTH):
    """The frame as `_render_chunk` in a loop makes it, with no graph."""
    w, h = scene.film_width, scene.film_height
    n_total = w * h * scene.spp
    with torch.inference_mode():
        flat = film_mod.new_film_flat(h, w, 5, scene.filter_type, scene.filter_stddev,
                                      device=scene.device)
        for c0 in range(0, n_total, chunk):
            driver._render_chunk(scene, flat, c0, n_total, seed, chunk, depth_cap)
        film = film_mod.film_from_flat(flat, h, w, scene.filter_type, scene.filter_stddev)
        rgb, alpha = film_mod.develop(film)
    return {"film": film, "rgb": rgb, "alpha": alpha}


def _render(scene, seed, chunk=CHUNK, **kw):
    return driver.render(scene, seed=seed, chunk_size=chunk, depth_cap=DEPTH,
                         progress=kw.pop("progress", lambda done, total: None), **kw)


def _equal(got, want):
    assert all(torch.equal(got[k], want[k]) for k in ("film", "rgb", "alpha"))


def _graph(scene):
    return scene.__dict__.get("_path_graph")


@pytest.mark.parametrize("integrator", ["path", "direct", "volpath", "debug"])
def test_graph_frames_equal_eager_frames(integrator):
    """The frame that captures (its first chunk eager, the rest replays)
    and a frame of another seed that replays every chunk each equal their
    eager frame to the bit: a graph that baked its seed or its first lane
    fails the second. The first frame's film, RGB and alpha are not changed
    by the second frame."""
    xml = SCENES / "cbox" / ("direct.xml" if integrator == "direct" else "scene.xml")
    scene = _scene(integrator, xml)
    first = _render(scene, 3)
    graph = _graph(scene)
    assert graph is not None
    kept = {k: v.clone() for k, v in first.items()}
    _equal(first, eager_frame(scene, 3))
    second = _render(scene, BIG_SEED)
    assert _graph(scene) is graph
    _equal(second, eager_frame(scene, BIG_SEED))
    _equal(first, kept)
    assert all(v.data_ptr() != graph.out.data_ptr() for v in second.values())
    assert not torch.equal(first["rgb"], second["rgb"])
    assert float(first["rgb"].mean()) > 0.01 and bool(torch.isfinite(first["rgb"]).all())


def test_a_frame_with_a_tail_chunk():
    """Chunks of 5,000 lanes: the first eager and captured, the second a
    replay, the third, past the frame, eager with its splat's mask; the
    frame and the next one, whose first two replay, equal the eager
    frames."""
    scene = _scene()
    for seed in (5, 6):
        _equal(_render(scene, seed, chunk=5000), eager_frame(scene, seed, chunk=5000))
    assert _graph(scene).key[2] == 5000


def test_a_replaced_table_captures_again():
    """A table replaced in the scene (the light's spectrum at half its
    radiance) drops the graph; the next frame captures anew and equals the
    eager frame of the new table."""
    scene = _scene()
    before = _render(scene, 3)
    graph = _graph(scene)
    _render(scene, 4)
    assert _graph(scene) is graph
    object.__setattr__(scene.emitters, "rad_curve", scene.emitters.rad_curve * 0.5)
    after = _render(scene, 3)
    assert _graph(scene) is not graph
    _equal(after, eager_frame(scene, 3))
    ratio = float(after["rgb"].mean() / before["rgb"].mean())
    assert 0.3 < ratio < 0.7


def test_a_resumed_graph_frame_is_the_uninterrupted_one(tmp_path):
    """A frame stopped after its second chunk and resumed from the snapshot
    of its first, on the scene that holds the graph and on a new scene that
    captures at the resumed chunk, equals the uninterrupted frame to the
    bit; progress sees the resumed chunks."""
    scene = _scene()
    ref = _render(scene, 4)
    ck = str(tmp_path / "film.npz")

    def stop(done, total):
        if done == 2:
            raise KeyboardInterrupt

    for resumed in (scene, _scene()):
        with pytest.raises(KeyboardInterrupt):
            _render(scene, 4, checkpoint_path=ck, checkpoint_every=1, progress=stop)
        seen = []
        out = _render(resumed, 4, checkpoint_path=ck, checkpoint_every=1,
                      progress=lambda done, total: seen.append(done))
        assert seen == [2, 3]
        _equal(out, ref)
        assert _graph(resumed) is not None
    assert not (tmp_path / "film.npz").exists()


def test_a_graph_frame_counts_what_the_eager_frame_counts(tmp_path):
    """Under a profiler (CPU and CUDA activities, as the benchmark's traced
    window), a frame of replays gives every counter of `tracing.read()` and
    every launch count the eager frame gives, `path.chunks` one a chunk and
    `path.graph.replays` one a replay; the trace holds the same cast
    kernels, one by one."""
    scene = _scene()
    _render(scene, 5)     # the capture, outside the sessions

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
        casts = [k["name"] for k in trace.kernels if "_hit_kernel" in k["name"]]
        return counts, {k: tracing.launches[k] - launched[k] for k in launched}, casts

    graph, graph_launched, graph_casts = session(lambda: _render(scene, 6), "graph")
    eager, eager_launched, eager_casts = session(lambda: eager_frame(scene, 6), "eager")
    assert graph[tracing.PATH_REPLAYS] == 3 and eager[tracing.PATH_REPLAYS] == 0
    assert graph[tracing.PATH_CHUNKS] == eager[tracing.PATH_CHUNKS] == 3
    assert {k: v for k, v in graph.items() if k != tracing.PATH_REPLAYS} == {
        k: v for k, v in eager.items() if k != tracing.PATH_REPLAYS}
    assert eager[tracing.CAST_LIVE] > 0 and eager[tracing.CAST_RAYS] > 0
    assert graph_launched == eager_launched
    assert sorted(graph_casts) == sorted(eager_casts)
    assert len(eager_casts) == eager_launched["closest"] + eager_launched["anyhit"] > 0


def _other_scene(name, tmp_path):
    """The repository's other path-family scenes at 32x24 x 4 spp on the
    card, their assets written small into tmp_path."""
    _cuda()
    if name == "gallery":
        from misaki_tpu_torch.scenes.materials import assets
        xml = assets.write_assets(tmp_path, res=32)
    elif name == "envlit":
        from misaki_tpu_torch.scenes.envlit import assets
        xml = assets.write_assets(tmp_path, sky_shape=(64, 128), floor_res=64)
    elif name == "volume":
        from misaki_tpu_torch.scenes.volume import assets
        xml = assets.write_assets(tmp_path, res=16)
    else:
        xml = {"figure2": SCENES / "testball" / "roughconductor.xml",
               "figure3": SCENES / "testball" / "roughdielectric.xml",
               "teapot": SCENES / "teapot" / "scene.xml",
               "bunny_debug": SCENES / "bunny_debug.xml"}[name]
    return _scene(xml=xml, w=32, h=24)


@pytest.mark.parametrize("name", ["gallery", "envlit", "volume", "figure2", "figure3",
                                  "teapot", "bunny_debug"])
def test_other_scenes_capture_and_replay_to_the_bit(name, tmp_path):
    """Every BSDF kind, bitmaps and an envmap (the texel fetch), media and a
    grid volume (volpath), and the debug integrator capture: two frames,
    the first capturing, equal their eager frames to the bit."""
    scene = _other_scene(name, tmp_path)
    chunk = 32 * 24 * 4 // 3
    for seed in (1, 2):
        _equal(_render(scene, seed, chunk=chunk), eager_frame(scene, seed, chunk=chunk))
    assert _graph(scene) is not None


@pytest.mark.parametrize("chunk", [N_TOTAL // 4, N_TOTAL // 12])
def test_a_four_rank_frame_that_replays_equals_the_one_that_captured(chunk):
    """A `ShardedRenderer` frame over four cards, each rank's block one
    chunk or three: the group's first frame runs each rank's first chunk
    eagerly and captures, the same seed's second frame replays them; the
    two are equal to the bit, and within float adds of the one-card frame."""
    _cuda()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    from misaki_tpu_torch.parallel.sharding import ShardedRenderer

    scene = _scene()
    kw = {"chunk_size": chunk, "depth_cap": DEPTH}
    with ShardedRenderer(scene.to("cpu"), 4, device="cuda") as group:
        first = group.render(seed=7, **kw)
        first = {k: v.clone() for k, v in first.items()}
        second = group.render(seed=7, **kw)
        other = group.render(seed=8, **kw)
    _equal(second, first)
    one = eager_frame(scene, 7)
    torch.testing.assert_close(first["film"], one["film"], rtol=1e-5,
                               atol=1e-6 * float(one["film"].abs().max()))
    assert not torch.equal(other["rgb"], first["rgb"])
