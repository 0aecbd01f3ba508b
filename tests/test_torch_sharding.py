"""The port's sharding (misaki_tpu_torch/parallel/sharding.py) on the CPU:
ranks are processes joined over gloo (`sharding.run_ranks`), each with one
intra-op thread. Sharded films against the port's one-process `render()`,
the sharded train step against `train_step`, and the port's sharded film
against misaki_tpu's film for the same XML, seed and depth, under the
criteria of misaki_tpu's own sharding test
(tests/test_diff_and_sharding.py:97-130). The scenes are
misaki_tpu's `cbox_tiny` size: the in-repo cbox at 16x12 x 8 spp."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_helpers import CBOX_XML, n, t

from misaki_tpu.parallel import sharding as jsharding
from misaki_tpu.render.driver import render as jrender
from misaki_tpu.scene.compiler import load_and_compile as jload
from misaki_tpu_torch import graft_entry
from misaki_tpu_torch.diff import replace_leaves
from misaki_tpu_torch.diff.train import DEFAULT_TRAIN_LEAVES, train_step
from misaki_tpu_torch.parallel import sharding as sh
from misaki_tpu_torch.render import driver as pdriver
from misaki_tpu_torch.scene import from_compiled
from misaki_tpu_torch.scene.compiler import load_and_compile as pload

SEED, DEPTH = 5, 3                # misaki_tpu's sharding test
TRAIN_SEED, TRAIN_DEPTH = 3, 2
RTOL = 1e-5
# a train step's autograd chunk small enough that each rank's block (768
# lanes at 2 ranks, 384 at 4) takes image_grads' primal and re-render
SMALL_GRAD_CHUNK = 256
WORLDS = {2: [(2,)], 4: [(4,)], 8: [(8,), (2, 4)]}


def misaki_lanes(n_total, spp, n_dev):
    """misaki_tpu's split, restated from render_sharded (sharding.py:83-85):
    device r renders `lanes_per_dev` lanes from r * lanes_per_dev, the lanes
    at or past n_total masked."""
    lanes_per_dev = -(-(-(-n_total // n_dev)) // spp) * spp
    return [(r * lanes_per_dev, r * lanes_per_dev + lanes_per_dev) for r in range(n_dev)]


def rel_l1(got, want):
    return float(np.abs(got - want).sum() / max(np.abs(want).sum(), 1e-30))


def assert_film_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def scenes():
    """cbox 16x12 x 8 spp in both packages (the port's through
    from_compiled, on the same tables), live emitter coefficients for the
    train step (the compiler's are saturated, (0, 0, 1e5), where the
    gradient is float32 noise: tests/test_torch_diff.py `live_coeff`), and
    a 15x11 x 8 spp cbox whose last block over 8 ranks is short."""
    js = jload(str(CBOX_XML), spp=8, width=16, height=12)
    ps = from_compiled(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    rs = np.random.default_rng(11)
    e = ps.n_emitters
    coeff = np.stack([rs.normal(0.0, 1e-6, e), rs.normal(0.0, 1e-3, e),
                      rs.uniform(-0.5, 0.5, e)], axis=1).astype(np.float32)
    train = replace_leaves(ps, {"rad_coeff": t(coeff)})
    target = rs.uniform(0.0, 0.5, (12, 16, 3)).astype(np.float32)
    short = pload(str(CBOX_XML), spp=8, width=15, height=11, device="cpu")
    return {"js": js, "ps": ps, "train": train, "target": target, "short": short}


@pytest.fixture(scope="module")
def runs(scenes):
    """One process group a world size: the cbox film on each of its meshes,
    then (2 and 4 ranks) a train step in one autograd chunk and one in
    SMALL_GRAD_CHUNK chunks, or (8 ranks) the 15x11 film -> {world: [each
    rank's [(result, seconds)]]}."""
    out = {}
    for world, shapes in WORLDS.items():
        tasks = [("render", scenes["ps"], s, dict(seed=SEED, depth_cap=DEPTH)) for s in shapes]
        if world == 8:
            tasks.append(("render", scenes["short"], (8,), dict(seed=SEED, depth_cap=DEPTH)))
        else:
            tasks += [("train", scenes["train"], (world,),
                       dict(target_rgb=scenes["target"], seed=TRAIN_SEED,
                            depth_cap=TRAIN_DEPTH, **kw))
                      for kw in ({}, {"chunk_size": SMALL_GRAD_CHUNK})]
        out[world], _ = sh.run_ranks(world, sh.sharded_job, tasks, device="cpu")
    return out


def task(runs, world, i):
    """Task i's result on rank 0, after checking that every rank returned
    the same to the bit."""
    def tensors(res):
        return [res] if isinstance(res, torch.Tensor) else [res[0], *res[1].values()]

    ranks = [r[i][0] for r in runs[world]]
    for r, res in enumerate(ranks[1:], 1):
        assert all(a.equal(b) for a, b in zip(tensors(res), tensors(ranks[0]))), r
    return ranks[0]


@pytest.mark.parametrize("n_total,spp,n_dev", [
    (16 * 12 * 8, 8, 2), (16 * 12 * 8, 8, 8), (15 * 11 * 8, 8, 8), (15 * 11 * 8, 8, 7),
    (3 * 2 * 4, 4, 8), (1 * 1 * 16, 16, 4), (256 * 256 * 64, 64, 3), (7 * 5 * 3, 3, 6)])
def test_lane_blocks(n_total, spp, n_dev):
    """misaki_tpu's split: each block starts where misaki_tpu's device block
    does and ends where its unmasked lanes end; the blocks cover [0,
    n_total) exactly once, start on a pixel, and are empty past the frame
    (more devices than pixels)."""
    blocks = sh.lane_blocks(n_total, spp, n_dev)
    assert len(blocks) == n_dev
    for (a, b), (ja, jb) in zip(blocks, misaki_lanes(n_total, spp, n_dev)):
        assert (a, b) == (min(ja, n_total), min(jb, n_total))
        assert a % spp == 0 and a <= b
    covered = np.zeros(n_total, np.int64)
    for a, b in blocks:
        covered[a:b] += 1
    assert (covered == 1).all()
    if n_dev * spp > n_total:
        assert blocks[-1][0] == blocks[-1][1] == n_total


@pytest.mark.parametrize("world,i,scene", [(2, 0, "ps"), (4, 0, "ps"), (8, 0, "ps"),
                                           (8, 2, "short")])
def test_render_sharded_matches_render(scenes, runs, world, i, scene):
    """The sharded film at 2, 4 and 8 ranks (and the 15x11 film, whose last
    block over 8 ranks is short) against the one-process render() film,
    the same on every rank."""
    ps = scenes[scene]
    want = n(pdriver.render(ps, seed=SEED, depth_cap=DEPTH)["film"])
    got = n(task(runs, world, i))
    assert got.shape == want.shape == (ps.film_height, ps.film_width, 5)
    assert_film_close(got, want)


def test_2d_mesh_matches_1d(scenes, runs):
    """The (2, 4) (host, chip) mesh against the 8-rank 1D mesh."""
    assert_film_close(n(task(runs, 8, 1)), n(task(runs, 8, 0)))


@pytest.mark.parametrize("world,i", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_train_step_sharded_matches_train_step(scenes, runs, world, i):
    """The sharded step's loss and gradients against the one-process
    train_step, the same on every rank: a world-size factor in the
    gradient fails at once. Task 1 differentiates each rank's block in one
    autograd chunk, task 2 in SMALL_GRAD_CHUNK chunks (the primal, the
    film's sum over the ranks, then the chunked re-render)."""
    ps = scenes["train"]
    if i == 2:
        lane0, lane1 = sh.lane_blocks(ps.film_width * ps.film_height * ps.spp, ps.spp, world)[0]
        assert lane1 - lane0 > pdriver.pick_chunk(SMALL_GRAD_CHUNK, ps.spp, lane1 - lane0)
    want_loss, want = train_step(ps, scenes["target"], seed=TRAIN_SEED, depth_cap=TRAIN_DEPTH)
    loss, grads = task(runs, world, i)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    for k in DEFAULT_TRAIN_LEAVES:
        assert np.isfinite(n(grads[k])).all(), k
        err = rel_l1(n(grads[k]), n(want[k]))
        assert err <= 1e-5, f"{k}: relative L1 {err:.3e}"


@pytest.mark.parametrize("integrator", ["aov", "sppm", "photonmapper"])
def test_unsharded_integrators_raise(scenes, integrator):
    """misaki_tpu's sharded renders splat only the 5-channel film of path,
    direct, volpath and debug; its photon integrators stay unsharded."""
    mesh = sh.make_mesh(1, "cpu")
    scene = scenes["ps"].replace(integrator=integrator)
    with pytest.raises(NotImplementedError, match=integrator):
        sh.render_sharded(mesh, scene)
    with pytest.raises(NotImplementedError, match=integrator):
        sh.train_step_sharded(mesh, scene, scenes["target"])


def test_single_process(scenes):
    """init_distributed is a no-op in a single process; make_mesh(1) and
    make_host_chip_mesh() give a mesh of one, on which render_sharded is
    render() to the bit (the same chunks); a larger mesh needs a process
    group, and a CUDA rank raises where there is no card."""
    assert sh.init_distributed(world_size=1, device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    mesh = sh.make_mesh(1, "cpu")
    assert (mesh.shape, mesh.rank, mesh.groups) == ((1,), 0, (None,))
    assert sh.make_host_chip_mesh(device="cpu").shape == (1, 1)
    ps = scenes["ps"]
    want = pdriver.render(ps, seed=SEED, depth_cap=DEPTH)["film"]
    assert sh.render_sharded(mesh, ps, seed=SEED, depth_cap=DEPTH).equal(want)
    with pytest.raises(ValueError, match="process group"):
        sh.make_mesh(2, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sh.init_distributed(world_size=1)


def test_entry():
    """entry()'s function renders one 2^11-lane chunk; over the frame's two
    chunks it gives render()'s film of the same chunk size to the bit."""
    fn, (scene, film_flat, lane0, seed) = graft_entry.entry(device="cpu")
    assert (scene.film_width, scene.film_height, scene.spp) == (32, 24, 4)
    for lane0 in (0, 1 << 11):
        film_flat = fn(scene, film_flat, lane0, seed)
    want = pdriver.render(scene, seed=seed, chunk_size=1 << 11, depth_cap=3)["film"]
    from misaki_tpu_torch.render.film import film_from_flat

    got = film_from_flat(film_flat, 24, 32, scene.filter_type, scene.filter_stddev)
    assert torch.isfinite(got).all() and got[..., :3].abs().sum() > 0
    assert got.equal(want)


def test_dryrun_multichip(capsys):
    """Two gloo processes, two sharded train steps: finite gradients, a
    non-zero leaf, a second loss that differs."""
    graft_entry.dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): loss=" in capsys.readouterr().out


def _misaki_criteria(got, want):
    """misaki_tpu's test_sharded_render_matches_single_device: fewer than
    0.5% of texels off at rtol 1e-3 (atol 1e-5), those within half the
    film's largest value, the channel sums at rtol 1e-3."""
    off = ~np.isclose(got, want, rtol=1e-3, atol=1e-5)
    assert off.mean() < 0.005, f"{off.sum()} / {off.size} texels differ"
    if off.any():
        assert np.abs(got - want)[off].max() <= 0.5 * max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got.sum(axis=(0, 1)), want.sum(axis=(0, 1)), rtol=1e-3)


def test_sharded_film_matches_misaki_tpu(scenes, runs):
    """The port's 8-rank film against misaki_tpu's render() film of the
    same tables, seed and depth."""
    want = np.asarray(jrender(scenes["js"], seed=SEED, chunk_size=1 << 20,
                              depth_cap=DEPTH)["film"])
    _misaki_criteria(n(task(runs, 8, 0)), want)


@pytest.mark.slow
def test_sharded_film_matches_misaki_tpu_sharded(scenes, runs):
    """The port's 8-rank film against misaki_tpu's render_sharded on its
    8-device CPU mesh (minutes of XLA compile)."""
    want = np.asarray(jsharding.render_sharded(jsharding.make_mesh(8), scenes["js"],
                                               seed=SEED, depth_cap=DEPTH))
    _misaki_criteria(n(task(runs, 8, 0)), want)
