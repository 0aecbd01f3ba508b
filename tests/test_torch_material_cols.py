"""The material gather in the rows a scene's BSDF kinds read
(misaki_tpu_torch/bsdf/kernels.py `material_rows`, `material_params`), held
to the gather of every row of the packed table (all `N_MAT_COLS`, which a
scene whose kinds read every group gathers anyway).

On the CPU: for each kind alone, every kind mixed, the mask wrapper and a
scene with a bitmap slot, `material_params` equals the full gather's to the
bit; a guard that records every column `material_params`, `sample_bsdf`,
`eval_bsdf` and `pdf_bsdf` read under the full gather finds each in the
scene's rows; a cbox path frame equals the full gather's to the bit; a cbox
training step's `materials` gradient is zero outside the rows and the full
gather's elsewhere; and a traced frame counts 20 of 165 rows
(`bsdf.cols.gathered` / `bsdf.cols.packed`, read by the benchmark's
`material_col_share.frame`). The case marked `cuda` holds a captured and
replayed cbox chunk to the eager one and to the full gather's, and its
counters to the eager frame's. This file imports no JAX; on a card:

    python -m pytest tests/test_torch_material_cols.py -q --noconftest -m cuda
"""

import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_helpers import CBOX_XML

from benchmark import harness
from benchmark import program_spans as ps
from misaki_tpu_torch.bsdf import kernels as pbsdf
from misaki_tpu_torch.core import microfacet as pmf
from misaki_tpu_torch.diff.train import train_step
from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.scene.types import (
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFUSE,
    BSDF_DISNEY,
    BSDF_NULL,
    BSDF_PLASTIC,
    BSDF_ROUGH_CONDUCTOR,
    BSDF_ROUGH_DIELECTRIC,
    MASK_FLAG,
    MC_ALPHA_U,
    MC_ALPHA_V,
    MC_DISTR,
    MC_DS_CC_GLOSS,
    MC_DS_SUBSURFACE,
    MC_ETA,
    MC_ETA_RGB,
    MC_FDR,
    MC_K_RGB,
    MC_KIND,
    MC_MASK,
    MC_NONLINEAR,
    MC_OPACITY,
    MC_REFL,
    MC_SPEC_REFL,
    MC_SPEC_TRANS,
    MC_SSW,
    MC_TWOSIDED,
    N_MAT_COLS,
    SCALAR_SLOT_COLS,
    SPEC_SLOT_COLS,
)
from misaki_tpu_torch.utils import tracing

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
L, N_ROWS = 2048, 24
W, H, SPP, CHUNK, CAP = 16, 12, 4, 256, 4
CBOX_ROWS = (0, 1, 2, 3, *range(10, 23), 67, 68, 69)

# case -> BSDF kinds of the table (MASK_FLAG: every other row masked)
CASES = {
    "diffuse": (BSDF_DIFFUSE,),
    "roughconductor": (BSDF_ROUGH_CONDUCTOR,),
    "roughdielectric": (BSDF_ROUGH_DIELECTRIC,),
    "dielectric": (BSDF_DIELECTRIC,),
    "conductor": (BSDF_CONDUCTOR,),
    "null": (BSDF_NULL,),
    "roughplastic": (BSDF_PLASTIC,),
    "disney": (BSDF_DISNEY,),
    "mask_diffuse": (BSDF_DIFFUSE, MASK_FLAG),
    "mask_roughconductor": (BSDF_ROUGH_CONDUCTOR, MASK_FLAG),
    "every_kind": pbsdf.ALL_KINDS + (MASK_FLAG,),
    "bitmap": None,     # the envlit scene: a bitmap floor's slot
}


def _spec_slot(rs):
    """A plain sigmoid-spectrum slot, reflectances in about [0.05, 0.95]."""
    slot = np.zeros(SPEC_SLOT_COLS)
    slot[1:4] = [rs.normal() * 1e-6, rs.normal() * 1e-3, rs.normal() * 0.5]
    slot[7:13] = [1, 0, 0, 0, 1, 0]
    return slot


def _scalar_slot(value):
    slot = np.zeros(SCALAR_SLOT_COLS)
    slot[1] = slot[2] = value
    slot[3:9] = [1, 0, 0, 0, 1, 0]
    return slot


def _row(kind, rs, masked):
    """One material row of `kind`: every column of every group filled, so
    a column read from another group would show."""
    row = np.zeros(N_MAT_COLS)
    row[MC_KIND] = kind
    row[MC_TWOSIDED] = rs.integers(0, 2)
    row[MC_DISTR] = pmf.GGX if rs.uniform() < 0.5 else pmf.BECKMANN
    row[MC_ETA] = rs.uniform(1.2, 2.0)
    row[MC_ETA_RGB: MC_ETA_RGB + 3] = rs.uniform(0.1, 2.0, 3)
    row[MC_K_RGB: MC_K_RGB + 3] = rs.uniform(0.5, 5.0, 3)
    for base in (MC_REFL, MC_SPEC_REFL, MC_SPEC_TRANS, MC_OPACITY):
        row[base: base + SPEC_SLOT_COLS] = _spec_slot(rs)
    for base in (MC_ALPHA_U, MC_ALPHA_V, *range(MC_DS_SUBSURFACE, MC_DS_CC_GLOSS + 1,
                                                SCALAR_SLOT_COLS)):
        row[base: base + SCALAR_SLOT_COLS] = _scalar_slot(rs.uniform(0.05, 0.9))
    row[MC_SSW] = rs.uniform(0.1, 0.9)
    row[MC_NONLINEAR] = rs.integers(0, 2)
    row[MC_FDR] = rs.uniform(0.3, 0.6)
    row[MC_MASK] = masked
    return row


def _table_case(name):
    """(scene, ids, uv, wavelengths) of a made-up table of the case's kinds,
    the same in every process."""
    kinds = CASES[name]
    rs = np.random.default_rng(zlib.crc32(name.encode()))
    bsdfs = [k for k in kinds if k != MASK_FLAG]
    rows = [_row(bsdfs[i % len(bsdfs)], rs, float(MASK_FLAG in kinds and i % 2))
            for i in range(N_ROWS)]
    params = torch.from_numpy(np.stack(rows, axis=-1).astype(np.float32))
    scene = SimpleNamespace(materials=SimpleNamespace(params=params),
                            bsdf_kinds=tuple(sorted(kinds)), bitmap_slots=(), bitmap_meta=(),
                            diff_mode=False)
    ids = torch.from_numpy(rs.integers(0, N_ROWS, L).astype(np.int32))
    return scene, ids, *_lanes(rs)


def _lanes(rs):
    uv = tuple(torch.from_numpy(rs.uniform(size=L).astype(np.float32)) for _ in range(2))
    lam = torch.from_numpy(rs.uniform(360.0, 830.0, (4, L)).astype(np.float32))
    return uv, lam


@pytest.fixture(scope="module")
def bitmap_case(tmp_path_factory):
    """The envlit scene (a bitmap floor) at a test's size, random lanes over
    its materials."""
    from misaki_tpu_torch.scenes.envlit import assets

    xml = assets.write_assets(tmp_path_factory.mktemp("envlit"), sky_shape=(64, 128),
                              floor_res=64)
    scene = load_and_compile(str(xml), spp=1, width=8, height=8, device="cpu")
    assert scene.bitmap_slots, "the envlit floor holds a bitmap slot"
    rs = np.random.default_rng(7)
    ids = torch.from_numpy(rs.integers(0, scene.materials.params.shape[1], L).astype(np.int32))
    return scene, ids, *_lanes(rs)


def _unit(rs):
    v = rs.normal(size=(3, L))
    return tuple(torch.from_numpy(c.astype(np.float32)) for c in v / np.linalg.norm(v, axis=0))


def _case(name, request):
    return request.getfixturevalue("bitmap_case") if name == "bitmap" else _table_case(name)


def _full(monkeypatch):
    """Make `material_params` gather every row of the table, as the parent
    gather did."""
    monkeypatch.setattr(pbsdf, "material_rows", lambda kinds: tuple(range(N_MAT_COLS)))


def _same(a, b, key=""):
    """Equal to the bit, through the dict's nesting."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), key
        for k in a:
            _same(a[k], b[k], f"{key}.{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), key
    else:
        assert a == b, key


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_rows_give_the_full_gathers_params(name, request, monkeypatch):
    scene, ids, uv, lam = _case(name, request)
    rows = pbsdf.material_rows(scene.bsdf_kinds)
    got = pbsdf.material_params(scene, ids, uv, lam)
    _full(monkeypatch)
    want = pbsdf.material_params(scene, ids, uv, lam)
    _same(got, want)
    assert (len(rows) == N_MAT_COLS) == (name == "every_kind")


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_column_read_is_in_the_rows(name, request, monkeypatch):
    """Under the full gather, every column that `material_params` and the
    BSDF's sample, eval and pdf read lies in `material_rows`: a kind that
    comes to read a new column fails here."""
    scene, ids, uv, lam = _case(name, request)
    rows = set(pbsdf.material_rows(scene.bsdf_kinds))
    read = set()
    get = pbsdf._Columns.__getitem__

    def recording(self, col):
        read.update(range(col.start, col.stop) if isinstance(col, slice) else (col,))
        return get(self, col)

    _full(monkeypatch)
    monkeypatch.setattr(pbsdf._Columns, "__getitem__", recording)
    p = pbsdf.material_params(scene, ids, uv, lam)
    rs = np.random.default_rng(3)
    wi, wo = (_unit(rs) for _ in range(2))
    u1 = torch.from_numpy(rs.uniform(size=L).astype(np.float32))
    u2 = tuple(torch.from_numpy(rs.uniform(size=L).astype(np.float32)) for _ in range(2))
    pbsdf.sample_bsdf(p, wi, u1, u2)
    pbsdf.eval_bsdf(p, wi, wo)
    pbsdf.pdf_bsdf(p, wi, wo)
    assert read and read <= rows, sorted(read - rows)


def test_material_rows_follow_the_kinds():
    """cbox's diffuse reads 20 rows; every group together all 165, in
    order."""
    assert pbsdf.material_rows((BSDF_DIFFUSE,)) == CBOX_ROWS
    assert pbsdf.material_rows(CASES["every_kind"]) == tuple(range(N_MAT_COLS))
    assert len(pbsdf.material_rows((BSDF_NULL,))) == 7


@pytest.fixture(scope="module")
def cbox():
    return load_and_compile(str(CBOX_XML), spp=SPP, width=W, height=H, device="cpu")


def _frame(scene, seed=1):
    return driver.render(scene, seed=seed, chunk_size=CHUNK, depth_cap=CAP,
                         progress=lambda done, total: None)


def test_a_cbox_frame_equals_the_full_gathers(cbox, monkeypatch):
    assert cbox.bsdf_kinds == (BSDF_DIFFUSE,)
    got = _frame(cbox)
    _full(monkeypatch)
    want = _frame(cbox)
    assert torch.equal(got["rgb"], want["rgb"]) and torch.equal(got["film"], want["film"])
    assert float(got["rgb"].mean()) > 0.01


def test_a_training_steps_gradient_lies_in_the_rows(cbox, monkeypatch):
    """The `materials` gradient of a cbox step: exact zeros outside the rows
    the scene's kinds read, the full gather's inside them (only the one-hot
    gemm's summation order may differ)."""
    target = np.full((H, W, 3), 0.25, np.float32)
    loss, grads = train_step(cbox, target, seed=2, depth_cap=CAP, leaves=("materials",))
    _full(monkeypatch)
    loss_full, grads_full = train_step(cbox, target, seed=2, depth_cap=CAP,
                                       leaves=("materials",))
    g, g_full = grads["materials"].numpy(), grads_full["materials"].numpy()
    assert g.shape == g_full.shape == tuple(cbox.materials.params.shape)
    rows = list(CBOX_ROWS)
    others = [c for c in range(N_MAT_COLS) if c not in CBOX_ROWS]
    assert not g[others].any() and not g_full[others].any()
    assert np.abs(g[rows]).max() > 0
    np.testing.assert_allclose(g[rows], g_full[rows], rtol=1e-6, atol=0)
    assert float(loss) == float(loss_full)


class _Run:
    trace, jobs_traced = None, 0


def _reader():
    return harness.load_module(BENCH / "metrics" / "material_col_share.frame.py",
                               "t_material_col_share")


def test_a_traced_frame_counts_20_of_165_rows(cbox):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _frame(cbox, seed=3)
    c = tracing.read()
    packed, gathered = c[tracing.MATERIAL_ROWS_PACKED], c[tracing.MATERIAL_ROWS_GATHERED]
    n_chunks = W * H * SPP // CHUNK
    assert packed > 0 and packed % (N_MAT_COLS * CHUNK * n_chunks) == 0
    assert gathered * N_MAT_COLS == packed * len(CBOX_ROWS)
    assert _reader().read(_Run) == pytest.approx(20 / 165, rel=1e-12)


@pytest.mark.parametrize("counts,share", [
    ({"bsdf.cols.gathered": 20, "bsdf.cols.packed": 165}, 20 / 165),
    ({"bsdf.cols.gathered": 330, "bsdf.cols.packed": 330}, 1.0),
    ({"bsdf.cols.gathered": 0, "bsdf.cols.packed": 0}, None),
    ({"rng.floats": 10}, None),
    (None, None),
])
def test_the_share_reader(monkeypatch, counts, share):
    """Gathered over packed; None where the program has no such counters
    (the parent) or gathered nothing."""
    monkeypatch.setattr(ps, "counts", lambda: counts)
    assert _reader().read(_Run) == share


@pytest.mark.cuda
def test_a_replayed_chunk_equals_the_eager_and_the_full_gather(monkeypatch):
    """On the card: a cbox frame whose chunks replay the captured chunk
    equals the eager frame and the full gather's eager frame to the bit;
    under a profiler the replays count the eager frame's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    w, h, spp = 64, 48, 4
    n_total = w * h * spp
    chunk = n_total // 3
    scene = load_and_compile(str(CBOX_XML), spp=spp, width=w, height=h,
                             device="cpu").to("cuda")

    def eager(seed):
        with torch.inference_mode():
            flat = film_mod.new_film_flat(h, w, 5, scene.filter_type, scene.filter_stddev,
                                          device="cuda")
            for c0 in range(0, n_total, chunk):
                driver._render_chunk(scene, flat, c0, n_total, seed, chunk, CAP)
        return flat

    def graphed(seed):
        with torch.inference_mode():
            flat = film_mod.new_film_flat(h, w, 5, scene.filter_type, scene.filter_stddev,
                                          device="cuda")
            driver.render_lanes(scene, flat, 0, n_total, seed, chunk, CAP)
        return flat

    def traced(fn):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            fn()
            torch.cuda.synchronize()
        return tracing.read()

    first = graphed(5)                 # its first chunk eager, then captured
    assert scene.__dict__.get("_path_graph") is not None
    assert torch.equal(first, eager(5))
    assert torch.equal(graphed(6), eager(6))
    replays, eagers = traced(lambda: graphed(7)), traced(lambda: eager(7))
    assert replays[tracing.PATH_REPLAYS] == 3
    for name in (tracing.MATERIAL_ROWS_GATHERED, tracing.MATERIAL_ROWS_PACKED):
        assert replays[name] == eagers[name] > 0
    assert replays[tracing.MATERIAL_ROWS_GATHERED] * N_MAT_COLS == (
        replays[tracing.MATERIAL_ROWS_PACKED] * len(CBOX_ROWS))
    compact = eager(8)
    _full(monkeypatch)
    assert torch.equal(compact, eager(8))
