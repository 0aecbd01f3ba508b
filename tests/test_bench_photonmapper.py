"""The cbox-photonmapper cell on the CPU: its reference
(benchmark/reference/photonmapper.py) against the port's photonmapper frame,
and its job through the harness, at a test's size (cbox at 16x12, 4,096
photons x 2 iterations)."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import torch_helpers  # noqa: F401  (caps the threads)

from benchmark import common, harness
from benchmark.reference import photonmapper as ref
from benchmark.reference import scene as ref_scene
from benchmark.reference import sppm as ref_sppm
from benchmark.test_bench_harness import BENCH, REPO
from misaki_tpu_torch.render import ppm
from misaki_tpu_torch.scene.compiler import load_and_compile

CELL = "cbox-photonmapper"
PHOTONS, ITERS = 4096, 2


def small_xml(path, name="photonmapper.xml"):
    """The cell's photonmapper XML at the test's photons and iterations,
    written to `path`."""
    text = (BENCH / "configs" / "scenes" / "cbox" / name).read_text()
    text = text.replace('value="262144"', f'value="{PHOTONS}"').replace(
        '"iterations" value="8"', f'"iterations" value="{ITERS}"')
    assert f'value="{PHOTONS}"' in text
    path.write_text(text)
    return path


def tiny_root(tmp_path):
    root = tmp_path / "root"
    for d in ("configs", "traffic", "limits", "jobs", "metrics", "end_to_end"):
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = root / "benchmark" / "configs" / "cbox.json"
    c = json.loads(cfg.read_text())
    c.update(width=16, height=12, photons=PHOTONS, iterations=ITERS)
    cfg.write_text(json.dumps(c))
    small_xml(root / "benchmark" / "configs" / "scenes" / "cbox" / "photonmapper.xml")
    return root


@pytest.fixture(autouse=True)
def _threads():
    k = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(k)


def test_the_frozen_scene_is_the_ports():
    assert (BENCH / "configs" / "scenes" / "cbox" / "photonmapper.xml").read_text() == (
        REPO / "misaki_tpu_torch" / "scenes" / "cbox" / "photonmapper.xml").read_text()


def test_the_reference_renders_the_ports_frame_and_not_sppms(tmp_path):
    """Two seeds: the reference's frame and the port's photonmapper frame
    agree far inside the cell's limit; the sppm reference on the same scene
    (light samples, gathers after the first vertex, a shrinking radius) lies
    outside it by more than 4 times (about 0.12 against 0.015)."""
    xml = small_xml(tmp_path / "pm.xml")
    limit = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())["rgb_rel_l1"]
    scene = load_and_compile(str(xml), width=16, height=12, device="cpu")
    assert scene.integrator == "photonmapper" and scene.ppm_photons == PHOTONS
    mine = ref.load(xml, width=16, height=12)
    sppm_scene = ref_scene.load(small_xml(tmp_path / "sppm.xml", "sppm.xml"), width=16,
                                height=12)
    for seed in (3, 2 ** 32 - 9):
        port = ppm.render_ppm(scene, seed=seed, depth_cap=4)["rgb"]
        assert float(port.mean()) > 0.01
        got = common.image_numbers([(port, ref.render(mine, seed, 4))])["rgb_rel_l1"]
        assert got < 1e-2 * limit
        other = common.image_numbers([(port, ref_sppm.render(sppm_scene, seed, 4))])
        assert other["rgb_rel_l1"] > 4 * limit


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


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_passes_the_ports_output(tmp_path, trace):
    code = RUN.format(repo=str(REPO), root=str(tiny_root(tmp_path)), cell=CELL, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1][7:])
    assert res["correct"] and set(res["checks"]) == {"rgb_rel_l1"}, res["checks"]
    if trace:
        assert {"live_lane_share.frame", "graph_replay_share.sppm",
                "rng_kernel_share.frame"} <= set(res["metrics"])
    else:
        assert {"frame_s", "setup_s", "peak_mem_gib"} == set(res["metrics"])


def test_the_control_fails_the_check_at_a_tiny_size(tmp_path):
    cell = harness.load_cell(tiny_root(tmp_path), CELL, 2 ** 31 + 5, device="cpu")
    correct, rows = harness.check_numbers(cell, harness.job_module(cell).control(cell))
    assert not correct, rows
