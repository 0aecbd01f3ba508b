"""Veach's multiple-importance-sampling scene (the veach-mis configuration)
in the port, against the benchmark's plain reference
(benchmark/reference/veach.py), on the CPU:

* whole frames at 48x32 x 1 spp, three seeds, and three faults planted in
  the port that the cell's limits must catch;
* the reference's GGX conductor (eval, pdf, sample) against the port's
  `bsdf/kernels.py` at each of the scene's four roughnesses;
* the mesh light's face pick (`emitter/kernels.py` `_area_point`, a binary
  search of the CDF row) against the count over the whole comparison
  matrix that it replaced, to the bit, in `sample_emitter_direct` and
  `sample_emitter_ray`, on a scene whose 2-face light sits beside a
  5,120-face one (padded CDF rows); tests/test_torch_path.py holds both
  samplers against misaki_tpu's on the same scene.

The case marked `cuda` repeats the face pick at 2^20 lanes on the card and
skips where none is present:

    python -m pytest tests/test_torch_veach.py -q --noconftest -m cuda
"""

import functools
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from torch_helpers import REPO, TWO_LIGHTS, samples_at_entries

from benchmark import common
from benchmark.reference import veach as ref
from misaki_tpu_torch.bsdf import kernels as bsdf
from misaki_tpu_torch.core import microfacet, vec, warp
from misaki_tpu_torch.emitter import kernels as emitter
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.scene.compiler import compile_scene, load_and_compile
from misaki_tpu_torch.scene.loader import load_string
from misaki_tpu_torch.scene.types import (
    BSDF_ROUGH_CONDUCTOR,
    EF_CDF_HI,
    EF_CDF_LO,
    EF_E1,
    EF_E2,
    EF_P0,
    MC_ALPHA_U,
    MC_ALPHA_V,
    MC_KIND,
    SCALAR_SLOT_COLS,
)

XML = REPO / "benchmark" / "configs" / "scenes" / "veach-mis" / "scene.xml"
LIMITS = json.loads((REPO / "benchmark" / "limits" / "veach-mis-path.json").read_text())
ALPHAS = (0.005, 0.02, 0.05, 0.1)
W, H = 48, 32


@pytest.fixture(autouse=True)
def _threads():
    k = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(k)


def render(scene, seed):
    return driver.render(scene, seed=seed, chunk_size=1 << 12, depth_cap=4,
                         progress=lambda *a: None)["rgb"]


# ---------------------------------------------------------------------------
# whole frames
# ---------------------------------------------------------------------------

@functools.cache
def frames(spp):
    """(the port's scene, the reference's) at 48x32 x `spp`, the
    configuration's depth."""
    return (load_and_compile(str(XML), width=W, height=H, spp=spp, max_depth=5, device="cpu"),
            ref.load(XML, width=W, height=H, spp=spp, max_depth=5))


# The two sides differ by float rounding alone: their casts, barycentrics and
# a few sums are computed apart. At this size that reads 3e-7 to 6e-6 over the
# frame and at most 0.004 of the mean in a pixel; a sample that one side sends
# past a light's edge and the other into it would move its pixel by many
# times the mean, and the faults below read 0.02 and more over the frame.
REL_L1 = 1e-4
MAX_REL = 0.05


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5, 2 ** 32 - 9])
def test_the_reference_renders_the_ports_frame(seed):
    scene, rs = frames(1)
    port = render(scene, seed)
    got = common.image_numbers([(port, ref.render_rows(rs, seed, 0, H))])
    assert float(port.mean()) > 0.05
    assert got["rgb_rel_l1"] < REL_L1 and got["rgb_max_rel"] < MAX_REL, got
    assert REL_L1 < LIMITS["rgb_rel_l1"]


def _alpha_swap(scene):
    """The two top plates' roughness swapped (0.005 and 0.02)."""
    params = scene.materials.params.clone()
    top, second = torch.nonzero(params[MC_KIND] == BSDF_ROUGH_CONDUCTOR).squeeze(1)[:2].tolist()
    a = slice(MC_ALPHA_U, MC_ALPHA_V + SCALAR_SLOT_COLS)
    params[a, [top, second]] = params[a, [second, top]]
    assert float(params[MC_ALPHA_U + 1, top]) == pytest.approx(0.02)   # the slot's value
    return scene.replace(materials=replace(scene.materials, params=params))


def _brighter_light(scene):
    """The largest light's radiance times 1.1."""
    curve = scene.emitters.rad_curve.clone()
    curve[3] = curve[3] * 1.1
    return scene.replace(emitters=replace(scene.emitters, rad_curve=curve))


def _selection_pdf_one(monkeypatch):
    """Next-event estimation that takes the light picked with probability 1
    in place of 1/4: the sample's pdf and weight without the selection."""
    real = emitter.sample_emitter_direct

    def broken(scene, *a, **kw):
        out = real(scene, *a, **kw)
        n = scene.n_emitters
        return dict(out, pdf=out["pdf"] * n, spec=out["spec"] / n)

    monkeypatch.setattr(emitter, "sample_emitter_direct", broken)


@pytest.mark.parametrize("fault", ["light_radiance_x1.1", "alphas_swapped", "selection_pdf_1"])
def test_the_cells_limits_catch_a_planted_fault(monkeypatch, fault):
    scene, rs = frames(1)
    if fault == "light_radiance_x1.1":
        scene = _brighter_light(scene)
    elif fault == "alphas_swapped":
        scene = _alpha_swap(scene)
    else:
        _selection_pdf_one(monkeypatch)
    seed = 11
    got = common.image_numbers([(render(scene, seed), ref.render_rows(rs, seed, 0, H))])
    assert any(got[k] > lim for k, lim in LIMITS.items()), got


# ---------------------------------------------------------------------------
# the GGX conductor
# ---------------------------------------------------------------------------

def _directions(g, L, upper=True):
    v = torch.nn.functional.normalize(torch.randn((L, 3), generator=g, dtype=torch.float64), dim=1)
    if upper:
        v[:, 2] = v[:, 2].abs()
    return v.float()


@pytest.mark.parametrize("alpha", ALPHAS)
def test_the_references_ggx_conductor_is_the_ports(alpha):
    L = 4096
    g = torch.Generator().manual_seed(int(alpha * 1e4))
    lam = 360.0 + 470.0 * torch.rand((L, 4), generator=g)
    eta, k = torch.tensor([0.143, 0.374, 1.442]), torch.tensor([3.983, 2.386, 1.603])
    spec = torch.tensor([0.0, 0.0, 49.992499])
    s = ref.Surface.__new__(ref.Surface)
    s.conductor = torch.ones(L, dtype=torch.bool)
    s.refl = torch.zeros((L, 4))
    s.spec = ref.pt.sigmoid_spectrum(spec, lam)
    s.alpha = torch.full((L,), alpha)
    s.eta = ref.anchored(eta.expand(L, 3), lam)
    s.k = ref.anchored(k.expand(L, 3), lam)
    a = torch.full((L,), alpha)
    p = {"alpha_u": a, "alpha_v": a, "distr": torch.full((L,), microfacet.GGX, dtype=torch.int32),
         "eta_spec": s.eta.T.contiguous(), "k_spec": s.k.T.contiguous(),
         "spec_refl": s.spec.T.contiguous()}
    wi = _directions(g, L)
    # directions near the mirror of wi, where the lobe lives, and anywhere
    mirror = torch.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], 1)
    near = torch.nn.functional.normalize(mirror + 3.0 * alpha * torch.randn((L, 3), generator=g),
                                         dim=1)
    for wo in (near, _directions(g, L, upper=False)):
        t_wi, t_wo = tuple(wi.T), tuple(wo.T)
        torch.testing.assert_close(s.eval(wi, wo), bsdf._eval_roughconductor(p, t_wi, t_wo).T,
                                   rtol=2e-4, atol=1e-6)
        torch.testing.assert_close(s.pdf(wi, wo), bsdf._pdf_roughconductor(p, t_wi, t_wo),
                                   rtol=2e-4, atol=1e-6)
    u = torch.rand((2, L), generator=g)
    wo, pdf, weight, valid = s.sample(wi, u[0], u[1])
    port = bsdf._sample_roughconductor(p, tuple(wi.T), (u[0], u[1]))
    assert torch.equal(valid, port["valid"])
    assert valid.float().mean() > 0.5
    torch.testing.assert_close(wo[valid], torch.stack(port["wo"], 1)[valid], rtol=0, atol=2e-5)
    torch.testing.assert_close(pdf, port["pdf"], rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(weight, port["weight"].T, rtol=2e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# the mesh light's face pick
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_lights():
    return compile_scene(load_string(TWO_LIGHTS), device="cpu")


def test_the_lights_rows_are_padded(two_lights):
    em = two_lights.emitters
    assert em.face_cdf.shape == (2, 5120) and two_lights.n_faces == 2 + 5120 + 2
    assert torch.all(em.face_cdf[0, 1:] == 1.0) and float(em.face_cdf[0, 0]) < 1.0
    assert torch.all(em.face_cdf[:, 1:] >= em.face_cdf[:, :-1])


@pytest.mark.parametrize("ei", [0, 1])
def test_the_searched_face_is_the_dense_count(two_lights, ei):
    g = torch.Generator().manual_seed(ei)
    em = two_lights.emitters
    uy = samples_at_entries(em.face_cdf[ei], g, 20000)
    ux = torch.rand(uy.shape[0], generator=g)
    fd, b1, b2, p = emitter._area_point(two_lights, ei, (ux, uy))
    below = uy[None, :] > em.face_cdf[ei][:, None]
    dense = torch.clamp(below.to(torch.int32).sum(dim=0), 0, em.face_cdf.shape[1] - 1)
    assert torch.equal(fd, em.face_pack[ei][:, dense])
    # a sample below 1 picks a face of the light (beyond it, the row's last)
    assert len(torch.unique(dense[uy < 1.0])) == (2 if ei == 0 else 5120)


def _dense(scene, ei, u2):
    """`_area_point` with the dense count in place of the search."""
    em = scene.emitters
    cdf = em.face_cdf[ei]
    below = u2[1][None, :] > cdf[:, None]
    idx = torch.clamp(below.to(torch.int32).sum(dim=0), 0, cdf.shape[0] - 1)
    fd = em.face_pack[ei][:, idx]
    lo, hi = fd[EF_CDF_LO], fd[EF_CDF_HI]
    uy = torch.clamp((u2[1] - lo) / torch.clamp(hi - lo, min=1e-20), 0.0, 1.0 - 1e-7)
    b1, b2 = warp.square_to_uniform_triangle((u2[0], uy))
    p0 = (fd[EF_P0], fd[EF_P0 + 1], fd[EF_P0 + 2])
    e1 = (fd[EF_E1], fd[EF_E1 + 1], fd[EF_E1 + 2])
    e2 = (fd[EF_E2], fd[EF_E2 + 1], fd[EF_E2 + 2])
    return fd, b1, b2, vec.add(p0, vec.add(vec.scale(e1, b1), vec.scale(e2, b2)))


def test_the_samplers_are_the_dense_forms_to_the_bit(two_lights, monkeypatch):
    """`sample_emitter_direct` (next-event estimation) and
    `sample_emitter_ray` (the photon passes) give the outputs of the dense
    face pick, to the bit, on samples at and beside every CDF entry."""
    g = torch.Generator().manual_seed(9)
    cdf = two_lights.emitters.face_cdf
    uy = torch.cat([samples_at_entries(cdf[0], g, 3000), samples_at_entries(cdf[1], g, 3000)])
    L = uy.shape[0]
    ux = torch.rand(L, generator=g)
    ref_p = tuple(torch.rand(L, generator=g) * 4.0 - 2.0 + off for off in (0.0, 0.0, 3.0))
    lam = 400.0 + 300.0 * torch.rand((4, L), generator=g)
    u_dir = (torch.rand(L, generator=g), torch.rand(L, generator=g))

    def run():
        return (emitter.sample_emitter_direct(two_lights, ref_p, lam, (ux, uy)),
                emitter.sample_emitter_ray(two_lights, lam, ux, (ux, uy), u_dir))

    searched = run()
    monkeypatch.setattr(emitter, "_area_point", _dense)
    dense = run()
    for a, b in zip(searched, dense):
        assert a.keys() == b.keys()
        for key in a:
            x, y = a[key], b[key]
            for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
                assert torch.equal(u, v), key
    assert float(searched[0]["pdf"].gt(0).float().mean()) > 0.2


@pytest.mark.cuda
def test_the_searched_face_is_the_dense_count_on_the_card():
    """2^20 lanes on the scene's 5,120-face light, on the card: the index
    the search gathers equals the dense count's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = compile_scene(load_string(TWO_LIGHTS), device="cuda")
    g = torch.Generator().manual_seed(3)
    cdf = scene.emitters.face_cdf[1].cpu()
    uy = samples_at_entries(cdf, g, (1 << 20) // 4)
    uy = torch.cat([uy, torch.rand((1 << 20) - uy.shape[0], generator=g)]).cuda()
    ux = torch.rand(1 << 20, generator=g).cuda()
    fd = emitter._area_point(scene, 1, (ux, uy))[0]
    dense = _dense(scene, 1, (ux, uy))[0]
    assert torch.equal(fd, dense)
    assert np.unique(fd[EF_P0].cpu().numpy()).shape[0] > 1000
