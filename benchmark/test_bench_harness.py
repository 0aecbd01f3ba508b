"""CPU tests of the benchmark's harness: discovery by name, the per-layer
arithmetic on a synthetic trace, the import rules, and the check, which
passes the port's own tiny output and fails it when the timed path is
broken underneath.

    python -m pytest benchmark/ -q

Runs are tiny (cbox at 16x12, a few samples), on the CPU, through
`harness.run_cell`, which skips run.py's look for a card. The test marked
`cuda` runs a cell on the card and skips here.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import common, harness, peaks, tracing

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
DATA = ("configs", "traffic", "limits", "jobs", "metrics", "end_to_end")


def tiny_root(tmp_path):
    """A checkout of the benchmark's data and readers in `tmp_path`, with the
    configuration cut to a CPU size (cbox 16x12 x 4 spp, sppm 4,096 photons
    x 2 iterations)."""
    root = tmp_path / "root"
    for d in DATA:
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg_dir = root / "benchmark" / "configs"
    cbox = json.loads((cfg_dir / "cbox.json").read_text())
    cbox.update(width=16, height=12, spp=4, photons=4096, iterations=2)
    cbox["scenes"]["sppm"] = "benchmark/configs/scenes/cbox/sppm_tiny.xml"
    (cfg_dir / "cbox.json").write_text(json.dumps(cbox))
    xml = (cfg_dir / "scenes" / "cbox" / "sppm.xml").read_text()
    xml = xml.replace('value="262144"', 'value="4096"').replace(
        '"iterations" value="8"', '"iterations" value="2"')
    (cfg_dir / "scenes" / "cbox" / "sppm_tiny.xml").write_text(xml)
    return root


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(root, workload, trace=False, seconds=0.3, seed=2 ** 31 + 77):
    cell = harness.load_cell(root, workload, seed, device="cpu")
    return harness.run_cell(cell, seconds, trace=trace, err=lambda line: None)


# ---------------------------------------------------------------------------
# discovery by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.load_cell(REPO, workload, 1)
    job = harness.job_module(cell)
    for fn in ("setup", "step", "check", "control"):
        assert callable(getattr(job, fn))
    assert "rgb_rel_l1" in cell.limits or set(cell.limits) >= {
        "loss_rel", "grad_rel", "change_rel"}
    for section in ("end_to_end", "per_layer"):
        names = [m["name"] for m in cell.metrics(section)]
        assert names, (workload, section)
        for n in names:
            assert callable(harness.reader(cell, section, n).read)
    assert "setup_s" in [m["name"] for m in cell.metrics("end_to_end")]
    for rel in cell.config["scenes"].values():
        assert (REPO / rel).is_file()


def test_every_metric_names_a_reported_end_to_end_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A configuration, a traffic mix, a limit file and a per-layer metric,
    added as new files and BENCHMARK.json entries in a copy, run without an
    edit to any file that was there."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "cbox.json").read_text())
    cfg.update(name="cbox_wide", width=20, height=8, spp=2)
    (b / "configs" / "cbox_wide.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "path_frames.json").read_text())
    tr.update(chunk_log2=6, trace_jobs=1)
    (b / "traffic" / "path_frames_small_chunks.json").write_text(json.dumps(tr))
    (b / "limits" / "cbox_wide-path.json").write_text(
        (b / "limits" / "cbox-path.json").read_text())
    (b / "metrics" / "jobs_traced.frame.py").write_text(
        "def read(run):\n    return float(run.jobs_traced)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cbox_wide", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/cbox_wide.json", "why": "a test"})
    spec["workloads"].append({"name": "cbox_wide-path", "config": "cbox_wide",
                              "traffic": "path_frames_small_chunks", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "frame_s":
            m["workloads"].append("cbox_wide-path")
    spec["per_layer"].append({"name": "jobs_traced.frame", "unit": "frames", "better": "higher",
                              "source": "device_trace", "layer": "Entry", "moves": "frame_s",
                              "workloads": ["cbox_wide-path"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run_tiny(root, "cbox_wide-path")
    assert res["correct"] and set(res["metrics"]) == {"frame_s", "peak_mem_gib", "setup_s"}
    res = run_tiny(root, "cbox_wide-path", trace=True)
    assert res["correct"] and res["metrics"]["jobs_traced.frame"]["value"] == 1.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


# ---------------------------------------------------------------------------
# the per-layer arithmetic on a synthetic trace
# ---------------------------------------------------------------------------

def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def synthetic_trace():
    """A 1000 us window: kernels at [100, 300) and [250, 400) (overlapping),
    a memcpy [600, 650), a kernel cut by the window's end [950, 1100); the
    second kernel launched inside an autograd range on thread 2; two
    density kernels and a cast kernel among them."""
    return tracing.Trace([
        _ev(tracing.WINDOW, "user_annotation", 0, 1000),
        _ev(tracing.JOB, "user_annotation", 0, 500),
        _ev(tracing.JOB, "user_annotation", 500, 500),
        _ev("aten::add", "cpu_op", 420, 150),
        _ev("void density_gather_kernel<8>(float4 const*)", "kernel", 100, 200, tid=7,
            correlation=1),
        _ev("closest_hit_kernel(float const*, long long)", "kernel", 250, 150, tid=7,
            correlation=2),
        _ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 50, tid=7, correlation=3),
        _ev("density_scan_kernel(int*, int)", "kernel", 950, 150, tid=7, correlation=4),
        _ev("autograd::engine::evaluate_function: MulBackward0", "cpu_op", 240, 20, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 90, 5, tid=1, correlation=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 245, 5, tid=2, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 940, 5, tid=1, correlation=4),
    ])


def _run_with(trace, jobs, cell=None):
    return harness.Run(cell=cell, trace=trace, jobs_traced=jobs)


def test_trace_busy_idle_and_gaps():
    t = synthetic_trace()
    assert t.window_s == pytest.approx(1e-3)
    # union: [100, 400) + [600, 650) + [950, 1000) = 300 + 50 + 50
    assert t.busy_s == pytest.approx(400e-6)
    gaps = t.idle_gaps()
    assert [(round(a), round(b)) for a, b in gaps] == [(650, 950), (400, 600), (0, 100)]
    br = t.breakdown()
    assert br["idle_gaps"][1] == ["aten::add", pytest.approx(200e-6)]
    assert br["device_ops"][0][0].startswith("void density_gather_kernel")
    reader = harness.load_module(BENCH / "metrics" / "device_idle.frame.py", "t_idle")
    assert reader.read(_run_with(t, 2)) == pytest.approx(0.6)


def test_trace_launches_backward_density_and_cast_roofline():
    t = synthetic_trace()
    load = lambda n: harness.load_module(BENCH / "metrics" / f"{n}.py", f"t_{n}")  # noqa: E731
    assert load("launches_per_frame").read(_run_with(t, 2)) == 1.5
    # only the cast kernel was launched inside the autograd range
    assert load("backward_ms.step").read(_run_with(t, 2)) == pytest.approx(0.150 / 2)
    # density kernels 200 + 150 us, over two frames
    assert load("density_ms.sppm").read(_run_with(t, 2)) == pytest.approx(0.175)
    cell = harness.load_cell(REPO, "cbox-path", 1)
    need = peaks.cast_bytes_per_frame(cell.config, cell.traffic)
    # 256x256x64 samples, 4 iterations: 5 closest and 4 shadow rays each; 4
    # chunks x 9 launches x 32 faces x 48 B
    assert need == 256 * 256 * 64 * (5 * 192 + 4 * 36) + 4 * 9 * 32 * 48
    got = load("cast_roofline.frame").read(_run_with(t, 2, cell))
    assert got == pytest.approx(100 * 2 * need / 3.35e12 / 150e-6)
    empty = tracing.Trace([_ev(tracing.WINDOW, "user_annotation", 0, 10)])
    for n in ("launches_per_frame", "backward_ms.step", "density_ms.sppm", "device_idle.step"):
        assert load(n).read(_run_with(empty, 1, cell)) is None


# ---------------------------------------------------------------------------
# the import rules
# ---------------------------------------------------------------------------

def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["misaki_tpu_torch", "misaki_tpu_torch.render", "jaxtyping", "flaxen", "benchmark"]
    assert harness.forbidden_loaded(mods) == []
    assert harness.forbidden_loaded(mods + ["misaki_tpu.render", "jax", "jaxlib.xla",
                                            "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla", "misaki_tpu.render"]


def _imported_top_names(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_and_the_reference_none_of_the_port():
    for path in BENCH.rglob("*.py"):
        tops = _imported_top_names(path)
        assert not tops & {"jax", "jaxlib", "flax", "misaki_tpu"}, path
        if "reference" in path.relative_to(BENCH).parts:
            assert "misaki_tpu_torch" not in tops, path


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys, torch; torch.set_num_threads(1)\n"
            "from benchmark.reference import path, scene, sppm\n"
            "s = scene.load('benchmark/configs/scenes/cbox/scene.xml', spp=1, width=8,"
            " height=8, device='cpu', max_depth=3)\n"
            "path.render_rows(s, 3, 0, 8)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not tops & {"misaki_tpu_torch", "misaki_tpu", "jax", "jaxlib", "flax"}


def test_run_refuses_without_a_card_and_prints_no_result():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cbox-path",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_a_run_without_the_program_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program to run."""
    root = tmp_path / "bare"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "cell = harness.load_cell('.', 'cbox-path', 1, device='cpu')\n"
            "print(harness.run_cell(cell, 0.1))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and "misaki_tpu_torch" in res.stderr
    assert "correct" not in res.stdout


# ---------------------------------------------------------------------------
# the check: the port's tiny output passes; a broken timed path fails
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["cbox-path", "cbox-sppm", "cbox-train"])
def test_the_ports_own_output_passes(tmp_path, workload):
    res = run_tiny(tiny_root(tmp_path), workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


def test_a_traced_run_reports_per_layer_metrics_and_its_breakdown(tmp_path):
    res = run_tiny(tiny_root(tmp_path), "cbox-train", trace=True)
    assert res["correct"]
    assert set(res) >= {"breakdown", "metrics", "checks"}
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def _alter_one_pixel(monkeypatch, module, name):
    real = getattr(module, name)

    def altered(*a, **kw):
        out = real(*a, **kw)
        rgb = out["rgb"].clone()
        rgb[1, 2, 0] += 10.0 * float(rgb.abs().mean())
        return dict(out, rgb=rgb)

    monkeypatch.setattr(module, name, altered)


def _drop_odd_samples(monkeypatch):
    """Half of every pixel's samples left out of the film (value and weight),
    so the developed pixel is the mean of the rest."""
    from misaki_tpu_torch.render import film

    real = film.splat_aligned

    def half(film_flat, pixel0, pos, values, W, H, spp, *a, **kw):
        keep = (torch.arange(values[0].shape[0]) % spp) < spp // 2
        values = tuple(torch.where(keep, v, 0.0) for v in values)
        return real(film_flat, pixel0, pos, values, W, H, spp, *a, **kw)

    monkeypatch.setattr(film, "splat_aligned", half)


FAULTS = {
    "cbox-path/answer_altered": lambda mp: _alter_one_pixel(
        mp, __import__("misaki_tpu_torch.render.driver", fromlist=["x"]), "render"),
    "cbox-path/half_batch": _drop_odd_samples,
    "cbox-sppm/answer_altered": lambda mp: _alter_one_pixel(
        mp, __import__("misaki_tpu_torch.render.ppm", fromlist=["x"]), "render_ppm"),
    "cbox-sppm/half_batch": lambda mp: mp.setattr(
        __import__("misaki_tpu_torch.render.ppm", fromlist=["x"]), "photon_count",
        lambda scene: -(-scene.ppm_photons // 2048) * 1024),
}


def _train_fault(monkeypatch, kind):
    from misaki_tpu_torch.diff import train

    real = train.train_step
    first = {}

    def broken(scene, target, **kw):
        if kind == "half_batch":
            n = scene.film_width * scene.film_height * scene.spp
            return real(scene, target, lanes=(0, n // 2), **kw)
        if kind == "stale_leaves":
            # every step on the leaves of the first, as a graph captured in
            # the warm-up and replayed would take them
            return real(first.setdefault("scene", scene), target, **kw)
        loss, grads = real(scene, target, **kw)
        return loss, {k: torch.zeros_like(g) for k, g in grads.items()}

    monkeypatch.setattr(train, "train_step", broken)


FAULTS["cbox-train/state_unchanged"] = lambda mp: _train_fault(mp, "state_unchanged")
FAULTS["cbox-train/half_batch"] = lambda mp: _train_fault(mp, "half_batch")
FAULTS["cbox-train/stale_leaves"] = lambda mp: _train_fault(mp, "stale_leaves")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    root = tiny_root(tmp_path)
    FAULTS[fault](monkeypatch)
    res = run_tiny(root, fault.split("/")[0])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_the_check(tmp_path, workload):
    """The reference in TF32 in the program's place, at a test's size, fails
    the cell's limits."""
    cell = harness.load_cell(tiny_root(tmp_path), workload, 2 ** 31 + 5, device="cpu")
    correct, rows = harness.check_numbers(cell, harness.job_module(cell).control(cell))
    assert not correct, rows


def test_frame_seeds_take_large_seeds_and_differ():
    seeds = {common.frame_seed(2 ** 33 + 7, i) for i in range(-1, 50)}
    assert len(seeds) == 51 and all(0 <= s < 2 ** 32 for s in seeds)
    assert common.frame_seed(5, 3) == common.frame_seed(5, 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cbox-path",
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
