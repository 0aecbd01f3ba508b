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
