"""The cbox-sierpinski-path cell on the CPU: its reference
(benchmark/reference/sierpinski.py) against `reference/path.py`'s casts and
against the port, its job through the harness at a test's size (level 3,
16x16 x 4 spp), and the readers of `bvh_nodes_per_ray.frame` and
`bvh_faces_per_ray.frame` on synthetic counters."""

import json
import shutil
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (caps the threads)

from benchmark import common, harness
from benchmark import program_spans as ps
from benchmark.reference import path as pt
from benchmark.reference import sierpinski as ref
from benchmark.test_bench_harness import BENCH, REPO
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene import compiler, procedural

CELL = "cbox-sierpinski-path"
XML = BENCH / "configs" / "scenes" / "cbox-sierpinski" / "scene.xml"
LEVEL_9 = 'name="level" value="9"'


def tiny_root(tmp_path, level=3):
    """The benchmark's data and readers in `tmp_path`, cbox-sierpinski cut
    to `level` and 16x16 x 4 spp (its band of 8 rows kept)."""
    root = tmp_path / "root"
    for d in ("configs", "traffic", "limits", "jobs", "metrics", "end_to_end"):
        shutil.copytree(BENCH / d, root / "benchmark" / d)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    cfg = root / "benchmark" / "configs" / "cbox-sierpinski.json"
    c = json.loads(cfg.read_text())
    c.update(width=16, height=16, spp=4, faces=12 + 4 ** (level + 1), level=level)
    cfg.write_text(json.dumps(c))
    xml = root / "benchmark" / "configs" / "scenes" / "cbox-sierpinski" / "scene.xml"
    xml.write_text(xml.read_text().replace(LEVEL_9, f'name="level" value="{level}"'))
    return root


def small_xml(tmp_path, level):
    path = tmp_path / f"sierpinski_{level}.xml"
    path.write_text(XML.read_text().replace(LEVEL_9, f'name="level" value="{level}"'))
    return path


@pytest.fixture(autouse=True)
def _threads():
    k = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(k)


def test_the_reference_generates_the_ports_triangles():
    """The reference's own formula gives the port's faces at level 4: the
    same triangles (each a set of corners, in float32), both wound
    outward."""
    mine = ref.tetra_faces(4)
    theirs = procedural.sierpinski(4)["positions"]

    def key(tris):
        return sorted(tuple(sorted(map(tuple, t.tolist()))) for t in tris.astype(np.float32))

    assert key(mine) == key(theirs)
    cross = np.cross(mine[:, 1] - mine[:, 0], mine[:, 2] - mine[:, 0])
    centre = mine.reshape(-1, 4, 3, 3).mean(axis=(1, 2)).repeat(4, axis=0)
    assert ((cross * (mine[:, 0] - centre)).sum(1) > 0).all()


@pytest.mark.parametrize("level", [1, 5])
def test_blocked_casts_equal_the_plain_matrix_cast(tmp_path, level):
    """Closest hit and occlusion over the blocks (level 5: 4,108 faces, two
    blocks of the tetrahedron and the box's) equal `path.closest_hit` and
    `path.occluded` over one matrix of every face."""
    bs = ref.load(small_xml(tmp_path, level), width=8, height=8, spp=1, max_depth=5)
    assert len(bs.first) - 1 == 1 + -(-4 ** (level + 1) // ref.BLOCK_FACES)
    whole = replace(bs.scene, cast_rows=torch.cat([r.reshape(3, 3, -1) for r in bs.rows], 2)
                    .reshape(3, -1), cast_off=torch.cat([o.reshape(3, -1) for o in bs.off], 1)
                    .reshape(-1))
    g = torch.Generator().manual_seed(11)
    L = 4096
    o = torch.tensor([20.0, 1.0, 20.0]) + torch.rand((L, 3), generator=g) * torch.tensor(
        [510.0, 500.0, 520.0])
    d = torch.nn.functional.normalize(torch.randn((L, 3), generator=g), dim=1)
    mint = torch.where(torch.rand(L, generator=g) < 0.2, 0.0, 1e-3)
    maxt = torch.where(mint == 0.0, -1.0, torch.inf)
    t_w, f_w = pt.closest_hit(whole, o, d, mint, maxt)
    t_b, f_b = ref.closest_hit(bs, o, d, mint, maxt)
    assert torch.equal(f_b, f_w) and torch.equal(t_b, t_w)
    assert (f_w >= 12).sum() > 200
    short = torch.where(torch.isfinite(t_w), 0.5 * t_w, 1e3)
    for cap in (short, torch.where(torch.isfinite(t_w), 2.0 * t_w, 1e3)):
        assert torch.equal(ref.occluded(bs, o, d, mint, cap), pt.occluded(whole, o, d, mint, cap))


def test_the_reference_renders_the_ports_frame(tmp_path):
    """Level 3, 16x16 x 4 spp, two seeds: the reference's whole frame and
    the port's (the CPU twins) agree far inside the cell's limits."""
    xml = small_xml(tmp_path, 3)
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    scene = compiler.load_and_compile(str(xml), width=16, height=16, spp=4, max_depth=5,
                                      device="cpu")
    bs = ref.load(xml, width=16, height=16, spp=4, max_depth=5)
    for seed in (7, 2 ** 32 - 5):
        port = driver.render(scene, seed=seed, chunk_size=1 << 10, depth_cap=4,
                             progress=lambda *a: None)["rgb"]
        got = common.image_numbers([(port, ref.render_rows(bs, seed, 0, 16))])
        assert float(port.mean()) > 0.01
        assert got["rgb_rel_l1"] < 1e-2 * limits["rgb_rel_l1"], got
        assert got["rgb_max_rel"] < 1e-2 * limits["rgb_max_rel"], got


# the run in a process of its own: this one has loaded JAX, which the
# harness refuses in a run
RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from benchmark import harness
from misaki_tpu_torch.scene import compiler
if {drop_shape!r}:
    compiler._SHAPE_TYPES = ("obj", "rectangle", "sphere")
cell = harness.load_cell({root!r}, {cell!r}, 2 ** 31 + 77, device="cpu")
res = harness.run_cell(cell, 0.3, trace={trace!r}, err=lambda line: None)
print("RESULT " + json.dumps(res))
"""


def run_cell(root, trace=False, drop_shape=False):
    code = RUN.format(repo=str(REPO), root=str(root), cell=CELL, trace=trace,
                      drop_shape=drop_shape)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)


def result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_passes_the_ports_output(tmp_path, trace):
    res = result(run_cell(tiny_root(tmp_path), trace=trace))
    assert res["correct"] and res["attempted"] >= 1, res["checks"]
    assert set(res["checks"]) == {"rgb_rel_l1", "rgb_max_rel"}
    if trace:       # the CPU twins count no BVH2 walk: the walk readers find nothing
        assert {"live_lane_share.frame", "graph_replay_share.frame",
                "rng_kernel_share.frame", "material_col_share.frame"} <= set(res["metrics"])
        assert not {"bvh_nodes_per_ray.frame", "bvh_faces_per_ray.frame"} & set(res["metrics"])


def test_the_control_fails_the_check_at_a_tiny_size(tmp_path):
    cell = harness.load_cell(tiny_root(tmp_path), CELL, 2 ** 31 + 5, device="cpu")
    correct, rows = harness.check_numbers(cell, harness.job_module(cell).control(cell))
    assert not correct, rows


def test_a_program_without_the_shape_fails_at_set_up(tmp_path):
    """A compiler that does not know the shape drops it (as the program
    before it did): the run fails at its set-up on the face count, with no
    result."""
    proc = run_cell(tiny_root(tmp_path), drop_shape=True)
    assert proc.returncode != 0 and "RESULT" not in proc.stdout
    assert "faces" in proc.stderr


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

class Run:
    trace, jobs_traced = None, 0


@pytest.mark.parametrize("counts,nodes,faces", [
    ({"cast.closest.live": 1000, "cast.closest.nodes": 52000, "cast.closest.faces": 31000},
     52.0, 31.0),
    ({"cast.closest.live": 4, "cast.closest.nodes": 6, "cast.closest.faces": 9}, 1.5, 2.25),
    ({"cast.closest.live": 1000, "cast.closest.nodes": 0, "cast.closest.faces": 0}, None, None),
    ({"cast.closest.live": 0, "cast.closest.nodes": 0, "cast.closest.faces": 0}, None, None),
    ({"cast.closest.live": 640, "cast.closest.rays": 1000}, None, None),
    ({}, None, None),
    (None, None, None),
])
def test_the_walk_readers(monkeypatch, counts, nodes, faces):
    monkeypatch.setattr(ps, "counts", lambda: counts)
    got = [harness.load_module(BENCH / "metrics" / f"bvh_{w}_per_ray.frame.py",
                               f"t_bvh_{w}").read(Run) for w in ("nodes", "faces")]
    assert got == [nodes, faces]


def test_the_walk_metrics_are_declared_for_both_path_cells():
    for w in ("cbox-path", CELL):
        names = {m["name"] for m in harness.load_cell(REPO, w, 1).metrics("per_layer")}
        assert {"bvh_nodes_per_ray.frame", "bvh_faces_per_ray.frame", "cast_roofline.frame",
                "graph_replay_share.frame"} <= names, w
        assert not {"bounce_host_ms.frame", "cast_host_ms.frame"} & names or w == "cbox-path"
    cfg = harness.load_cell(REPO, CELL, 1).config
    assert cfg["faces"] == 12 + 4 ** 10 and cfg["reduced"] == []
