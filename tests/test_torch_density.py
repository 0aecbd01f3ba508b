"""The photon density estimate's grid design on the CPU: `density_binned_plain`
(the grid, keys, margin and span walk of `csrc/ppm_density.cu` in plain
PyTorch) against the dense twin `density_plain` and misaki_tpu's
`_density_blocks`, the frame's grid, and the estimate's CPU route.

Inputs: the adversarial cases of `tools/profile_ppm_density.py` (numpy,
seeded; a unit-cube grid of 16 cells an axis): photons at the largest
float32 distance that still passes along each axis and diagonal, photons
and visible points on cell boundaries, radii varying 100x and one larger
than a cell, every photon in one cell, photons outside the grid's box,
photons that cannot contribute at inf and NaN positions, no photons; and
the first splatted photon depth of cbox under sppm and the photonmapper,
captured on the CPU at 64x48 with 8192 photons and the frame's own grid.

Tolerances: the binned walk tests a subset of the dense pairs with the
same float32 expressions, so the counts equal the twin's to the bit (no
passing pair is lost); phi allclose(rtol 1e-5, atol 1e-6 of the twin's
largest magnitude): the flux sums are taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import n

from misaki_tpu.render import ppm as jppm
from misaki_tpu_torch.render import ppm
from misaki_tpu_torch.tools import profile_ppm_density as pd
from misaki_tpu_torch.utils import tracing


def _close(got, want):
    (phi, count), (phi_t, count_t) = got, want
    assert torch.equal(count, count_t)
    scale = float(phi_t.abs().max()) if phi_t.numel() else 0.0
    torch.testing.assert_close(phi, phi_t, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("sppm_mode", [True, False])
@pytest.mark.parametrize("case", pd.CASES)
def test_binned_plain_adversarial(case, sppm_mode):
    args = pd.to_args(*pd.adversarial(case), sppm_mode, "cpu")
    want = ppm.density_plain(*args)
    stats = {}
    _close(ppm.density_binned_plain(*args, pd.adversarial_grid(), stats=stats), want)
    passed = float(want[1].sum())
    assert (passed == 0) == (case == "empty")
    # the walk tests fewer pairs than the dense form where cells prune
    wiz = sum(args[3][k] * args[4][k] for k in range(3))
    dense = int((args[0]["valid"] & ~args[0]["glossy"]).sum()) * int((args[6] & (wiz > 0)).sum())
    assert passed <= stats["pair_tests"] <= dense


def test_farthest_photons_sit_on_the_radius():
    """The max_distance case's photons: along each axis and diagonal of each
    visible point, q_in passes the twin's float32 test and q_out, a hair
    farther, does not; the binned walk counts every q_in."""
    vp, r2, ph = pd.adversarial("max_distance")
    n_vp, n_dir = r2.shape[0], 26
    p = np.repeat(vp["p"], n_dir, axis=1)
    q_in, q_out = np.split(ph["p"], 2, axis=1)
    r2r = np.repeat(r2, n_dir)

    def d2(q):
        d = q - p
        return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]

    assert (d2(q_in) < r2r).all() and not (d2(q_out) < r2r).any()
    gap = np.abs(q_out.astype(np.float64) - q_in).max(axis=0)
    assert (gap <= 4 * np.spacing(np.abs(q_in).max(axis=0))).all()
    # each visible point alone against its own q_in photons
    for i in range(n_vp):
        sel = slice(i * n_dir, (i + 1) * n_dir)
        one = {k: v[..., i:i + 1] for k, v in vp.items()}
        own = {k: v[..., :n_vp * n_dir][..., sel] for k, v in ph.items()}
        args = pd.to_args(one, r2[i:i + 1], own, True, "cpu")
        got = ppm.density_binned_plain(*args, pd.adversarial_grid())
        assert float(got[1][0]) == n_dir


@pytest.mark.parametrize("r2", [0.0, 1e-45, 1e-40, 1e-30, 3.3e-12, 1e-6, 0.0039, 1.0, 7e3,
                                1e12, 3e37])
def test_margin_covers_the_farthest_pair(r2):
    """r' = sqrt(r2) (1 + 2^-16) + 2^-64 in float32 reaches every float32
    offset the twin's test passes, from subnormal radii to huge ones, at
    several positions."""
    r2 = np.float32(r2)
    rr = np.float32(np.float32(np.sqrt(r2) if r2 > 0 else 0.0) * np.float32(ppm.REL_MARGIN)
                    + np.float32(ppm.ABS_MARGIN))
    for x in (0.0, 1.0, -3.75, 1e6, 1e-20):
        p = np.full((3, 2), np.float32(x), np.float32)
        u = np.array([[1.0, -1.0], [0.0, 0.0], [0.0, 0.0]])
        q_in, _ = pd.farthest(p, np.full(2, r2, np.float32), u, iters=200)
        passes = (q_in[0] - p[0]) ** 2 < r2
        reach = np.where(passes, np.abs(q_in[0].astype(np.float64) - p[0]), 0.0)
        assert (np.float32(p[0] + rr) >= np.maximum(q_in[0], p[0])).all()
        assert (np.float32(p[0] - rr) <= np.minimum(q_in[0], p[0])).all()
        assert (reach <= float(rr)).all()


@pytest.fixture(scope="module")
def captured():
    """{integrator: (args, grid)}: cbox's first splatted photon depth on the
    CPU at 64x48, 8192 photons, with the frame's grid."""
    return {i: pd.capture(i, width=64, height=48, device="cpu", ppm_photons=8192)
            for i in ("sppm", "photonmapper")}


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_binned_plain_on_cbox_depth(captured, integrator):
    args, grid = captured[integrator]
    assert args[-1] == (integrator == "sppm")
    want = ppm.density_plain(*args)
    stats = {}
    _close(ppm.density_binned_plain(*args, grid, stats=stats), want)
    assert float(want[1].sum()) > 100
    # cells of the initial radius: a small share of the dense form's pairs
    live = int((args[0]["valid"] & ~args[0]["glossy"]).sum())
    assert stats["pair_tests"] < 0.05 * live * args[6].shape[0]


@pytest.mark.parametrize("integrator", ["sppm", "photonmapper"])
def test_frame_grid_from_the_bounding_sphere(captured, integrator):
    """render_ppm passes every estimate the grid of the scene's bounding
    sphere with cells of the initial radius (cbox: 0.025 of the radius, 81
    cells an axis)."""
    from misaki_tpu_torch.scene.compiler import load_and_compile

    _, grid = captured[integrator]
    scene = load_and_compile(str(pd.SCENES / "cbox" / f"{integrator}.xml"), width=64,
                             height=48, device="cpu")
    r0 = ppm.initial_radius(scene)
    R = float(scene.emitters.bsphere_radius)
    assert r0 == pytest.approx(0.025 * R)
    assert grid == ppm.scene_grid(scene, r0)
    assert grid.dims == (81, 81, 81) and grid.inv_h == np.float32(1.0 / r0)
    c = n(scene.emitters.bsphere_center)
    assert grid.lo == tuple(np.float32(float(v) - R) for v in c)


@pytest.mark.parametrize("center,radius,r0,dims", [
    ((0.0, 0.0, 0.0), 1.0, 1e-4, (128, 128, 128)),    # h = 2 R / 128
    ((5.0, -2.0, 1.0), 10.0, 1.0, (20, 20, 20)),      # h = r0
    ((0.0, 0.0, 0.0), 1.0, 50.0, (1, 1, 1)),          # one cell
    ((0.0, 0.0, 0.0), 0.0, 0.3, (1, 1, 1)),           # a point
    ((0.0, 0.0, 0.0), 1.0, float("inf"), (1, 1, 1)),
])
def test_density_grid(center, radius, r0, dims):
    g = ppm.density_grid(center, radius, r0)
    assert g.dims == dims and g.n_cells == dims[0] ** 3
    assert g.inv_h.dtype == np.float32 and g.inv_h > 0
    assert all(v.dtype == np.float32 for v in g.lo)


def test_grid_changes_only_the_pairs_tested(captured):
    """Any grid gives the same estimate: one cell, the frame's, a coarser
    one shifted off the scene's centre, the finest."""
    args, frame_grid = captured["sppm"]
    want = ppm.density_plain(*args)
    tests = []
    for grid in (ppm.density_grid((0, 0, 0), 1.0, 1e9), frame_grid,
                 ppm.density_grid((300.0, 250.0, 260.0), 300.0, 40.0),
                 ppm.density_grid((278, 274, 279), 480, 1e-3)):
        stats = {}
        _close(ppm.density_binned_plain(*args, grid, stats=stats), want)
        tests.append(stats["pair_tests"])
    assert tests[0] > tests[1] and tests[0] > tests[3]


@pytest.mark.parametrize("sppm_mode", [True, False])
def test_binned_plain_against_misaki_tpu(sppm_mode):
    """Every adversarial case in one estimate through misaki_tpu's
    _density_blocks (the photons padded with dead ones to whole 2048-photon
    blocks) and through the binned walk."""
    vp, r2, ph = pd.mixed()
    pad = -ph["p"].shape[1] % ppm.PHOTON_BLOCK
    phj = {k: np.concatenate([v, np.zeros(v.shape[:-1] + (pad,), v.dtype)], axis=-1)
           for k, v in ph.items()}

    def j3(x):
        return tuple(jnp.asarray(c) for c in x)

    jvp = {k: j3(v) if v.ndim == 2 else jnp.asarray(v) for k, v in vp.items()}
    want = jppm._density_blocks(jvp, jnp.asarray(r2), j3(phj["p"]), j3(phj["wi"]),
                                j3(phj["n"]), j3(phj["flux"]), jnp.asarray(phj["ok"]),
                                sppm_mode)
    got = ppm.density_binned_plain(*pd.to_args(vp, r2, ph, sppm_mode, "cpu"),
                                   pd.adversarial_grid())
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    scale = float(np.abs(np.asarray(want[0])).max())
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), rtol=1e-5, atol=1e-6 * scale)


def test_cpu_estimate_takes_the_twin(captured):
    """On the CPU the estimate is the dense twin, grid or no grid, and
    launches nothing."""
    args, grid = captured["photonmapper"]
    before = tracing.launches["density"]
    want = ppm.density_plain(*args)
    for kw in ({}, {"grid": grid}):
        got = ppm.density_estimate(*args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tracing.launches["density"] == before


def test_binned_plain_takes_no_position_of_a_photon_that_cannot_contribute():
    """Photons that cannot contribute key past every cell whatever their
    position: the estimate is the same with their positions at inf, NaN or
    anywhere."""
    vp, r2, ph = pd.adversarial("nonfinite")
    grid = pd.adversarial_grid()
    base = ppm.density_binned_plain(*pd.to_args(vp, r2, ph, False, "cpu"), grid)
    moved = dict(ph, p=ph["p"].copy())
    moved["p"][:, 1000:] = 0.5
    _close(ppm.density_binned_plain(*pd.to_args(vp, r2, moved, False, "cpu"), grid), base)


def test_profile_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the density profile runs on a CUDA machine (chip_smoke.py phase 17)")
    with pytest.raises(RuntimeError, match="CUDA"):
        pd.profile(out=tmp_path / "p.md")


def test_bounds_count_bytes_and_passing_pairs(captured):
    """The implementation-independent bound reads only the bytes the
    function needs (every alive flag; an alive photon's wi and n; a photon
    that may contribute, its position and flux; a live visible point's
    position, tested direction and r2) and writes each output once, against
    5 FP32 operations an alive photon and 20 a passing pair; the dense
    form's reads every input row and counts every pair of a live visible
    point and a photon that may contribute."""
    args, _ = captured["sppm"]
    vp, r2, _, ph_wi, ph_n, _, ok, _ = args
    want = ppm.density_plain(*args)
    b = pd.bounds(args, want)
    L, P = r2.shape[0], ok.shape[0]
    alive = int(ok.sum())
    live = int((vp["valid"] & ~vp["glossy"]).sum())
    may = int((ok & (sum(ph_wi[k] * ph_n[k] for k in range(3)) > 0)).sum())
    assert 0 < may <= alive <= P and 0 < live < L
    assert (b["alive_photons"], b["contributing_photons"], b["live_visible_points"]) == (
        alive, may, live)
    assert b["bytes"] == 4 * (P + 6 * alive + 7 * may + L + 7 * live + 5 * L)
    assert b["bytes"] < b["dense_bytes"] == 4 * (14 * P + 16 * L)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)
    assert b["dense_bound_ms"] >= b["bound_ms"]
    assert b["dense_pairs"] == live * may
    assert b["pairs_passed"] == int(want[1].sum()) > 0
