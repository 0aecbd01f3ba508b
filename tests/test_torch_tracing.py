"""The port's tracing (misaki_tpu_torch/utils/tracing.py): spans and counters
while a torch.profiler session runs, nothing while none does.

On the CPU: the shared no-op span; a tiny cbox path frame and a tiny sppm
frame under the profiler, their spans counted and nested, the layers' host
times summed to the frame's, the counters held to independent counts of the
same inputs, and two sessions in one process each counting their own. The
case marked `cuda` holds the kernels' counters to the CPU twins' on the same
inputs and skips where no card is present; on a card:

    python -m pytest tests/test_torch_tracing.py -q --noconftest -m cuda
"""

import json

import pytest
import torch

from torch_helpers import CBOX_XML, SCENES

from benchmark import program_spans as ps
from benchmark import tracing as bench_tracing
from misaki_tpu_torch.accel import cluster as cl
from misaki_tpu_torch.accel import traverse
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import integrator as integ
from misaki_tpu_torch.render import ppm
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.tools import profile_ppm_density as pd
from misaki_tpu_torch.utils import tracing

NAMES = (tracing.FRAME, tracing.CHUNK, tracing.BOUNCE, tracing.CAST, tracing.DENSITY)
W, H, SPP, CHUNK, CAP = 16, 12, 4, 256, 4


def _quiet(done, total):
    """A progress callback that reports nothing."""


@pytest.fixture(scope="module")
def cbox():
    return load_and_compile(str(CBOX_XML), spp=SPP, width=W, height=H, device="cpu")


@pytest.fixture(scope="module")
def cbox_sppm():
    return load_and_compile(str(SCENES / "cbox" / "sppm.xml"), width=W, height=H,
                            device="cpu").replace(ppm_photons=2048, ppm_iterations=2)


def path_frame(scene, seed=1):
    return driver.render(scene, seed=seed, chunk_size=CHUNK, depth_cap=CAP, progress=_quiet)


def traced(fn, tmp_path):
    """Run fn under torch.profiler (CPU) inside the benchmark's window span;
    -> (its result, the window's trace, the session's counts)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with bench_tracing.span(bench_tracing.WINDOW):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return (out, bench_tracing.Trace(json.loads(path.read_text())["traceEvents"]),
            tracing.read())


def spans(t, name):
    """(start, end) of each span `name` on the window's thread, one a span."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in t.host
                  if e["name"] == name and e.get("cat") == "user_annotation"
                  and e.get("tid") == t.host_tid)


def inside(inner, outer):
    return any(s <= a and b <= e for s, e in outer for a, b in [inner])


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_span_without_a_profiler_is_the_shared_no_op(name):
    assert not torch.autograd._profiler_enabled()
    assert tracing.span(name) is tracing.span(tracing.FRAME)
    with tracing.span(name) as s:
        assert s is None
    assert tracing.device_counter(torch.device("cpu"), tracing.CAST_LIVE) is None


def test_an_untraced_frame_records_no_span_and_no_count(cbox, monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    before = tracing.read()
    path_frame(cbox)
    assert made == []
    assert tracing.read() == before


# ---------------------------------------------------------------------------
# on: a path frame
# ---------------------------------------------------------------------------

def test_a_traced_path_frame_spans_nest_and_split_the_frame(cbox, tmp_path):
    _, t, _ = traced(lambda: path_frame(cbox), tmp_path)
    n_chunks = -(-W * H * SPP // CHUNK)
    iters = integ.n_bounce_iters(cbox, CAP)
    frames, chunks, bounces, casts = (spans(t, n) for n in NAMES[:4])
    assert (len(frames), len(chunks), len(bounces)) == (1, n_chunks, n_chunks * iters)
    # the camera's cast, and a shadow and a closest-hit cast a bounce
    assert len(casts) == n_chunks * (1 + 2 * iters)
    assert spans(t, tracing.DENSITY) == []
    assert all(inside(c, frames) for c in chunks)
    assert all(inside(b, chunks) for b in bounces)
    assert all(inside(c, chunks) for c in casts)
    assert sum(inside(c, bounces) for c in casts) == n_chunks * 2 * iters

    class Run:
        trace, jobs_traced = t, 1

    frame_ms = (frames[0][1] - frames[0][0]) * 1e-3
    parts = [ps.host_ms(Run, ps.FRAME, (ps.BOUNCE, ps.CAST, ps.DENSITY)),
             ps.host_ms(Run, ps.BOUNCE, (ps.CAST, ps.DENSITY)), ps.host_ms(Run, ps.CAST)]
    assert all(p > 0 for p in parts)
    assert sum(parts) == pytest.approx(frame_ms, rel=1e-9)


def test_cast_counters_equal_an_independent_count(cbox, tmp_path, monkeypatch):
    """cast.closest.rays: the rays of every closest-hit cast; live: those
    with maxt >= mint, counted here from the casts' own arguments."""
    seen = {"rays": 0, "live": 0}
    real = traverse.intersect

    def counting(scene, o, d, mint, maxt, **kw):
        seen["rays"] += mint.shape[0]
        seen["live"] += int((maxt >= mint).sum())
        return real(scene, o, d, mint, maxt, **kw)

    monkeypatch.setattr(traverse, "intersect", counting)
    _, _, c = traced(lambda: path_frame(cbox), tmp_path)
    assert c[tracing.CAST_RAYS] == seen["rays"] == W * H * SPP * (1 + integ.n_bounce_iters(
        cbox, CAP))
    assert c[tracing.CAST_LIVE] == seen["live"]
    assert 0 < seen["live"] < seen["rays"]
    assert c[tracing.DENSITY_PHOTONS] == 0


def test_two_sessions_each_count_their_own(cbox, tmp_path):
    _, _, one = traced(lambda: path_frame(cbox), tmp_path)
    _, _, again = traced(lambda: path_frame(cbox), tmp_path)
    assert again == one
    _, _, two = traced(lambda: (path_frame(cbox), path_frame(cbox, seed=1)), tmp_path)
    assert two == {k: 2 * v for k, v in one.items()}
    assert tracing.read() == two


# ---------------------------------------------------------------------------
# on: a photon frame
# ---------------------------------------------------------------------------

def test_a_traced_sppm_frame_counts_each_estimates_inputs(cbox_sppm, tmp_path, monkeypatch):
    """The density counters, estimate by estimate, equal
    tools/profile_ppm_density.py `bounds`' counts of the same inputs; the
    estimates lie in the photon pass's bounce spans."""
    rows = []
    real = ppm.density_estimate

    def recording(*args, **kw):
        before = tracing.read()
        out = real(*args, **kw)
        after = tracing.read()
        rows.append(({k: after[k] - before[k] for k in after},
                     pd.bounds(args, (out[0], out[1]))))
        return out

    monkeypatch.setattr(ppm, "density_estimate", recording)
    _, t, c = traced(lambda: ppm.render_ppm(cbox_sppm, seed=2, depth_cap=CAP), tmp_path)
    budget = ppm.depth_budget(cbox_sppm, CAP)
    assert len(rows) == cbox_sppm.ppm_iterations * (budget - 1)
    for got, want in rows:
        assert got[tracing.DENSITY_PHOTONS] == want["photons"]
        assert got[tracing.DENSITY_VPS] == want["visible_points"]
        assert got[tracing.DENSITY_ALIVE] == want["alive_photons"]
        assert got[tracing.DENSITY_CONTRIBUTING] == want["contributing_photons"]
        assert got[tracing.DENSITY_LIVE] == want["live_visible_points"]
    assert c[tracing.DENSITY_ALIVE] == sum(w["alive_photons"] for _, w in rows) > 0
    frames, bounces, estimates = (spans(t, n) for n in (tracing.FRAME, tracing.BOUNCE,
                                                            tracing.DENSITY))
    assert len(frames) == 1 and len(estimates) == len(rows)
    assert len(bounces) == 2 * budget * cbox_sppm.ppm_iterations
    assert all(inside(e, bounces) for e in estimates)


def test_the_benchmark_reads_the_spans_it_names():
    """The span names the benchmark's readers copy are the program's."""
    assert (ps.FRAME, ps.CHUNK, ps.BOUNCE, ps.CAST, ps.DENSITY) == NAMES


# ---------------------------------------------------------------------------
# recording a CUDA graph's Python, and its replays
# ---------------------------------------------------------------------------

def test_a_recording_takes_the_counts_and_launches_of_its_capture():
    """Under `recording(slots)`: host counts and launches go to the
    recording, not to the session or `launches`, and the kernels get the
    slots' addresses, traced or not; one recording at a time."""
    slots = torch.zeros(len(tracing.DEVICE_COUNTERS), dtype=torch.int64)
    launched, before = dict(tracing.launches), tracing.read()
    with tracing.recording(slots) as rec:
        tracing.add(tracing.CAST_RAYS, 100)
        tracing.add(tracing.PPM_ITERATIONS, 1)
        tracing.launches["closest"] += 3
        tracing.launches["density"] += 1
        addr = {name: tracing.device_counter(torch.device("cpu"), name)
                for name in tracing.DEVICE_COUNTERS}
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording(slots):
                pass
    assert tracing.launches == launched and tracing.read() == before
    assert addr == {name: slots.data_ptr() + 8 * i
                    for i, name in enumerate(tracing.DEVICE_COUNTERS)}
    assert {k: v for k, v in rec.host.items() if v} == {tracing.CAST_RAYS: 100,
                                                       tracing.PPM_ITERATIONS: 1}
    assert {k: v for k, v in rec.launches.items() if v} == {"closest": 3, "density": 1}
    assert tracing.device_counter(torch.device("cpu"), tracing.CAST_LIVE) is None


def test_a_replay_counts_what_its_capture_recorded(monkeypatch, tmp_path):
    """`replayed`: untraced, the recorded launches alone, after one look at
    the profiler; traced, the recorded host counts and the graph's device
    counters besides, each replay."""
    slots = torch.zeros(len(tracing.DEVICE_COUNTERS), dtype=torch.int64)
    with tracing.recording(slots) as rec:
        tracing.add(tracing.DENSITY_PHOTONS, 2048)
        tracing.add(tracing.PPM_REPLAYS, 1)
        tracing.launches["density"] += 4
    slots[:] = torch.tensor([5, 6, 7, 8, 9, 10])
    launched, before = dict(tracing.launches), tracing.read()
    looks = []
    real = tracing._profiler_enabled
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: looks.append(1) or real())
    tracing.replayed(rec)
    assert len(looks) == 1
    assert tracing.launches == {**launched, "density": launched["density"] + 4}
    assert tracing.read() == before
    monkeypatch.setattr(tracing, "_profiler_enabled", real)
    _, _, c = traced(lambda: (tracing.replayed(rec), tracing.replayed(rec)), tmp_path)
    assert {k: v for k, v in c.items() if v} == {
        tracing.DENSITY_PHOTONS: 4096, tracing.PPM_REPLAYS: 2, tracing.CAST_LIVE: 10,
        tracing.DENSITY_ALIVE: 12, tracing.DENSITY_CONTRIBUTING: 14, tracing.DENSITY_LIVE: 16,
        tracing.CAST_NODES: 18, tracing.CAST_FACES: 20}
    assert tracing.launches["density"] == launched["density"] + 12
    tracing.launches.update(launched)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_the_kernels_count_as_the_twins_do():
    """On the same inputs: the closest-hit kernel's `cast.closest.live`
    equals the twin's count, and the density kernels' `density.alive`,
    `density.contributing` and `density.live` the twin's; an estimate still
    makes 11 CUDA launches and the counting adds none but the buffer's
    allocation. The kernel alone counts the BVH2 walk (`cast.closest.nodes`,
    `cast.closest.faces`; tests/test_torch_sierpinski.py holds them to a
    plain walk): the twin's tile walk leaves them 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    scene = load_and_compile(str(CBOX_XML), spp=2, width=32, height=24, device="cpu")
    L = 3000
    g = torch.Generator().manual_seed(5)
    o = tuple(0.5 * torch.rand(L, generator=g) for _ in range(3))
    d = torch.nn.functional.normalize(torch.randn(3, L, generator=g), dim=0)
    mint = torch.where(torch.rand(L, generator=g) < 0.3, 0.0, 1e-4)
    maxt = torch.where(mint == 0.0, -1.0, torch.inf)

    def counts(device, acc):
        args = pd.to_args(*pd.mixed(), True, device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            cl.intersect_clusters(acc, tuple(c.to(device) for c in o),
                                  tuple(c.to(device) for c in d), mint.to(device),
                                  maxt.to(device))
            before = dict(tracing.launches)
            # 128 cells an axis, as cbox's grid: three sort passes
            ppm.density_estimate(*args, grid=ppm.density_grid((0.5, 0.5, 0.5), 0.5, 1e-3))
            launched = {k: tracing.launches[k] - before[k] for k in before}
        return tracing.read(), launched

    cpu, _ = counts("cpu", scene.cluster)
    gpu, launched = counts("cuda", scene.to("cuda").cluster)
    walk = (tracing.CAST_NODES, tracing.CAST_FACES)
    assert {k: v for k, v in gpu.items() if k not in walk} == {
        k: v for k, v in cpu.items() if k not in walk}
    assert all(cpu[k] == 0 < gpu[k] for k in walk)
    assert cpu[tracing.CAST_LIVE] == int((maxt >= mint).sum()) > 0
    assert launched["density"] == 1 and launched["density_cuda"] == 11
