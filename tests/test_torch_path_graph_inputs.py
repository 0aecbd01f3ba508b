"""What a path chunk captured as a CUDA graph reads, held on the CPU to the
eager chunk (misaki_tpu_torch/render/driver.py `_graph_chunk`): a chunk
whose first lane and seed words are (1,) int64 tensors, as a graph's input
buffer gives them, renders the film of the Python ints to the bit; the
splat of a chunk inside the image, which indexes no mask, adds what the
masked splat adds; a tail chunk still drops its tail pixels; and the rule
that keeps the CPU, autograd, `aov` and tail chunks eager. The capture and
its replays run on the card (tests/test_torch_path_graph.py)."""

import pytest
import torch

from torch_helpers import CBOX_XML

from misaki_tpu_torch.render import driver
from misaki_tpu_torch.render import film as film_mod
from misaki_tpu_torch.scene.compiler import load_and_compile
from misaki_tpu_torch.utils import tracing

W, H, SPP = 16, 12, 2
N_TOTAL = W * H * SPP
BIG_SEED = (1 << 31) + 7


@pytest.fixture(scope="module")
def cbox():
    return load_and_compile(str(CBOX_XML), spp=SPP, width=W, height=H, device="cpu")


def _words(lane0, seed):
    """lane0 and the seed's words as (1,) int64 views of one input row."""
    row = torch.tensor((lane0, *driver.seed_words(seed)), dtype=torch.int64)
    return row[0:1], tuple(row[i:i + 1] for i in range(1, 4))


def _flat(scene):
    return film_mod.new_film_flat(H, W, 5, scene.filter_type, scene.filter_stddev)


@pytest.mark.parametrize("seed", [3, 4, BIG_SEED])
@pytest.mark.parametrize("integrator", ["path", "direct", "volpath", "debug"])
def test_a_chunk_of_tensor_inputs_renders_the_film_of_ints(cbox, integrator, seed):
    """The second half of the frame (a chunk inside it, as every replayed
    chunk is) rendered from tensor inputs equals the chunk of Python ints,
    to the bit, under each integrator a graph replays and for seeds below
    and above 2^31."""
    scene = cbox.replace(integrator=integrator)
    lane0, chunk = N_TOTAL // 2, N_TOTAL // 2
    with torch.inference_mode():
        want = driver._render_chunk(scene, _flat(scene), lane0, N_TOTAL, seed, chunk, 2)
        t_lane0, words = _words(lane0, seed)
        got = driver._render_chunk(scene, _flat(scene), t_lane0, N_TOTAL, words, chunk, 2)
    assert torch.equal(got, want)
    assert float(want[4].sum()) > 0.0 and float(want[0:3].abs().sum()) > 0.0


@pytest.mark.parametrize("seed", [0, 5, BIG_SEED, (1 << 32) + 9])
def test_seed_words_seed_the_streams_of_the_int_seed(seed):
    """make_rng from the seed's words, as ints or as (1,) tensors, gives the
    int seed's states, full-sized, to the bit."""
    lane = torch.arange(1000, 1300, dtype=torch.int64)
    want = driver.make_rng(lane, seed)
    for words in (driver.seed_words(seed), _words(0, seed)[1]):
        got = driver.make_rng(lane, words)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and torch.equal(got[k], want[k])


SPLAT_SPP = 3


def _splat_inputs(pixel0, n_pix, n_kept, seed, tail=0.0):
    """Jittered positions and 5 channels of random values for n_pix pixels
    from pixel0, SPLAT_SPP samples each; pixels from the n_kept-th on carry
    `tail`."""
    g = torch.Generator().manual_seed(seed)
    L = n_pix * SPLAT_SPP
    pix = pixel0 + torch.arange(L) // SPLAT_SPP
    pos = (pix % W + torch.rand(L, generator=g), pix // W + torch.rand(L, generator=g))
    kept = torch.arange(L) < n_kept * SPLAT_SPP
    return pos, tuple(torch.where(kept, torch.rand(L, generator=g), tail) for _ in range(5))


def _splat(pixel0, pos, values):
    return film_mod.splat_aligned(film_mod.new_film_flat(H, W), pixel0, pos, values, W, H,
                                  SPLAT_SPP)


def _first(inputs, n_pix):
    pos, values = inputs
    k = n_pix * SPLAT_SPP
    return (pos[0][:k], pos[1][:k]), tuple(v[:k] for v in values)


@pytest.mark.parametrize("pixel0,n_pix", [(0, W * H), (W * 5 + 3, W * 4), (W * 8, W * 4)])
def test_the_unmasked_splat_adds_what_the_masked_splat_adds(pixel0, n_pix):
    """A chunk inside the image, splatted unmasked (an int or a tensor
    pixel0), gives the film of the masked splat of a chunk that goes on
    with zero values from there to two rows past the image."""
    longer = H * W + 2 * W - pixel0
    masked = _splat(pixel0, *_splat_inputs(pixel0, longer, n_pix, seed=pixel0))
    inside = _first(_splat_inputs(pixel0, longer, n_pix, seed=pixel0), n_pix)
    for p0 in (pixel0, torch.tensor([pixel0])):
        assert torch.equal(_splat(p0, *inside), masked)
    assert float(masked[4].sum()) > 0.0


def test_a_tail_chunk_drops_its_tail_pixels():
    """A chunk that runs on past the image, its tail carrying values and
    reaching far beyond the film's guard rows, splats the film of its
    pixels inside the image alone."""
    n_in = 2 * W
    pixel0 = H * W - n_in
    inputs = _splat_inputs(pixel0, n_in + 3 * H * W, n_in, seed=1, tail=7.0)
    got = _splat(pixel0, *inputs)
    assert torch.equal(got, _splat(pixel0, *_first(inputs, n_in)))
    assert float(got[4].sum()) > 0.0


def test_the_eligibility_rule():
    """A graph replays a chunk only on a CUDA device, with no gradient to
    record, under path, direct, volpath or debug, and with every lane in
    the frame."""
    with torch.inference_mode():
        assert driver.graph_eligible("cuda", "path", 0, 100, 100)
        assert driver.graph_eligible(torch.device("cuda", 1), "debug", 50, 100, 50)
        assert all(driver.graph_eligible("cuda", i, 0, 100, 100)
                   for i in ("path", "direct", "volpath", "debug"))
        assert not driver.graph_eligible("cpu", "path", 0, 100, 100)
        assert not driver.graph_eligible("cuda", "aov", 0, 100, 100)
        assert not driver.graph_eligible("cuda", "sppm", 0, 100, 100)
        assert not driver.graph_eligible("cuda", "path", 60, 100, 50)
    with torch.no_grad():
        assert driver.graph_eligible("cuda", "path", 0, 100, 100)
    with torch.enable_grad():
        assert not driver.graph_eligible("cuda", "path", 0, 100, 100)


def test_the_cpu_renders_every_chunk_eagerly_and_counts_it(cbox):
    """On the CPU a frame captures nothing; under a profiler it counts each
    chunk in `path.chunks`, the tail chunk too, and no replay."""
    chunk = 5 * W * SPP                   # 3 chunks, the last past the frame
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        out = driver.render(cbox, seed=3, chunk_size=chunk, depth_cap=2)
    counts = tracing.read()
    assert counts[tracing.PATH_CHUNKS] == 3 and counts[tracing.PATH_REPLAYS] == 0
    assert "_path_graph" not in cbox.__dict__
    flat = _flat(cbox)
    with torch.inference_mode():
        for c0 in range(0, N_TOTAL, chunk):
            driver._render_chunk(cbox, flat, c0, N_TOTAL, 3, chunk, 2)
    want = film_mod.film_from_flat(flat, H, W, cbox.filter_type, cbox.filter_stddev)
    assert torch.equal(out["film"], want)
