"""PCG32 in the port must be bit-exact against misaki_tpu.core.rng on the
per-lane streams of the render driver (driver.make_rng)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_helpers import n, t  # noqa: F401  (also caps torch threads)

from misaki_tpu.core import rng as jrng
from misaki_tpu.render import driver as jdriver
from misaki_tpu_torch.core import rng as prng
from misaki_tpu_torch.render import driver as pdriver

SEEDS = [0, 1, 7, 2654435761, 0xFFFFFFFF]


def _lanes():
    rs = np.random.default_rng(3)
    return np.concatenate([
        np.arange(0, 1024, dtype=np.uint32),
        rs.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32),
        np.array([2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    ])


def _states(seed):
    lanes = _lanes()
    js = jdriver.make_rng(jnp.asarray(lanes), seed)
    ps = pdriver.make_rng(t(lanes.astype(np.int64)), seed)
    return js, ps


def _assert_state_equal(js, ps):
    for k in ("hi", "lo", "inc_hi", "inc_lo"):
        np.testing.assert_array_equal(np.asarray(js[k]).astype(np.int64), n(ps[k]))


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_state_equal(seed):
    js, ps = _states(seed)
    _assert_state_equal(js, ps)


@pytest.mark.parametrize("seed", SEEDS)
def test_next_uint32_bit_exact(seed):
    js, ps = _states(seed)
    for _ in range(10):
        jv, js = jrng.next_uint32(js)
        pv, ps = prng.next_uint32(ps)
        np.testing.assert_array_equal(np.asarray(jv).astype(np.int64), n(pv))
    _assert_state_equal(js, ps)


@pytest.mark.parametrize("seed", SEEDS)
def test_next_float32_and_2d_bit_exact(seed):
    js, ps = _states(seed)
    for _ in range(10):
        jv, js = jrng.next_float32(js)
        pv, ps = prng.next_float32(ps)
        assert np.array_equal(np.asarray(jv).view(np.uint32), n(pv).view(np.uint32))
        (jx, jy), js = jrng.next_2d(js)
        (px, py), ps = prng.next_2d(ps)
        assert np.array_equal(np.asarray(jx).view(np.uint32), n(px).view(np.uint32))
        assert np.array_equal(np.asarray(jy).view(np.uint32), n(py).view(np.uint32))
    _assert_state_equal(js, ps)


def test_floats_in_unit_interval():
    _, ps = _states(11)
    for _ in range(10):
        v, ps = prng.next_float32(ps)
        assert float(v.min()) >= 0.0 and float(v.max()) < 1.0


@pytest.mark.parametrize("k", [1, 5, 6, 9])
@pytest.mark.parametrize("seed", SEEDS)
def test_next_floats_equals_k_draws(seed, k):
    """One group of k draws gives the k floats of k `next_float32` calls, in
    order, and the same state; the state passed in is left as it was."""
    _, ps = _states(seed)
    before = {name: v.clone() for name, v in ps.items()}
    got, got_state = prng.next_floats(ps, k)
    assert len(got) == k
    want_state = ps
    for f in got:
        w, want_state = prng.next_float32(want_state)
        assert np.array_equal(n(f).view(np.uint32), n(w).view(np.uint32))
    for name in prng.LIMBS:
        np.testing.assert_array_equal(n(got_state[name]), n(want_state[name]))
        np.testing.assert_array_equal(n(ps[name]), n(before[name]))


def test_the_counters_count_k_a_call():
    """While a profiler runs, `rng.floats` counts each call's k; on the CPU
    no float is the kernel's."""
    import torch

    from misaki_tpu_torch.utils import tracing

    _, ps = _states(5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, ps = prng.next_floats(ps, 6)
        _, ps = prng.next_float32(ps)
        _, ps = prng.next_2d(ps)
    c = tracing.read()
    assert (c[tracing.RNG_FLOATS], c[tracing.RNG_KERNEL_FLOATS]) == (9, 0)


@pytest.mark.parametrize("case", ["no_kernel", "mixed_state", "mixed_words", "k_0"])
def test_the_wrappers_raise_on_what_they_cannot_draw(case):
    """A state or words on a device with no kernel (here `meta`), limbs or
    words on two devices, and a group of no draws are refused."""
    import torch

    _, ps = _states(3)
    meta = {k: torch.empty_like(v, device="meta") for k, v in ps.items()}
    with pytest.raises(ValueError):
        if case == "no_kernel":
            prng.next_floats(meta, 2)
        elif case == "mixed_state":
            prng.next_floats({**ps, "inc_lo": meta["inc_lo"]}, 2)
        elif case == "mixed_words":
            prng.seed_lanes(ps["hi"], torch.zeros(1, dtype=torch.int64, device="meta"), 0, 1)
        else:
            prng.next_floats(ps, 0)
