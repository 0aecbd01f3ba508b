"""Bit-exact vectorized PCG32 (reference: include/misaki/core/mathutils.h:89-143).

Every wavefront lane owns its own PCG32 stream, seeded from (lane, seed), so
a render is deterministic for a given seed whatever the chunking or device.
The streams are bit-identical to `misaki_tpu.core.rng`.

PyTorch has no unsigned 64-bit arithmetic, so the 64-bit state is carried as
two 32-bit limbs, each held in an int64 tensor with values in [0, 2^32).
Products are formed from one 32-bit and one 16-bit factor (< 2^48, exact in
int64) and every result is masked back to 32 bits.
"""

import torch

PCG32_MULT_HI = 0x5851f42d
PCG32_MULT_LO = 0x4c957f2d

MASK32 = 0xFFFFFFFF


def _mul32_wide(a, b):
    """Full 32x32 -> 64 bit product of [0, 2^32) int64 tensors, as (hi, lo)."""
    p0 = a * (b & 0xFFFF)                      # < 2^48
    p1 = a * (b >> 16)                         # < 2^48
    s = p0 + ((p1 & 0xFFFF) << 16)             # < 2^49
    lo = s & MASK32
    hi = ((p1 >> 16) + (s >> 32)) & MASK32
    return hi, lo


def _mul32_lo(a, b):
    """Low 32 bits of a * b."""
    return ((a * (b & 0xFFFF)) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK32


def _mul64(ah, al, bh, bl):
    """(ah:al) * (bh:bl) mod 2^64 as (hi, lo)."""
    hi, lo = _mul32_wide(al, bl)
    hi = (hi + _mul32_lo(al, bh) + _mul32_lo(ah, bl)) & MASK32
    return hi, lo


def _add64(ah, al, bh, bl):
    s = al + bl
    lo = s & MASK32
    hi = (ah + bh + (s >> 32)) & MASK32
    return hi, lo


def _step(state_hi, state_lo, inc_hi, inc_lo):
    """One LCG step: state = state * PCG32_MULT + inc."""
    mh, ml = _mul64(state_hi, state_lo, PCG32_MULT_HI, PCG32_MULT_LO)
    return _add64(mh, ml, inc_hi, inc_lo)


def _output(old_hi, old_lo):
    """PCG32 XSH-RR output function on the pre-step state."""
    s18_lo = ((old_lo >> 18) | (old_hi << 14)) & MASK32
    s18_hi = old_hi >> 18
    x_lo = s18_lo ^ old_lo
    x_hi = s18_hi ^ old_hi
    xorshifted = ((x_lo >> 27) | (x_hi << 5)) & MASK32
    rot = old_hi >> 27
    return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & MASK32


def _u32(x, like):
    """A Python int or int tensor as a [0, 2^32) int64 tensor like `like`."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.full_like(like, int(x) & MASK32)


def seed(initstate, initseq=1):
    """Per-lane seeding (reference seed(): mathutils.h:96-103).

    initstate / initseq are int tensors of 32-bit values, or (hi, lo) pairs
    of them for 64-bit values; Python ints broadcast against the tensors.
    """
    is_hi, is_lo = initstate if isinstance(initstate, tuple) else (0, initstate)
    iq_hi, iq_lo = initseq if isinstance(initseq, tuple) else (0, initseq)
    like = next(x for x in (is_lo, is_hi, iq_lo, iq_hi)
                if isinstance(x, torch.Tensor)).to(torch.int64)
    is_hi, is_lo, iq_hi, iq_lo = (_u32(x, like) for x in (is_hi, is_lo, iq_hi, iq_lo))

    inc_hi = ((iq_hi << 1) | (iq_lo >> 31)) & MASK32
    inc_lo = ((iq_lo << 1) | 1) & MASK32
    st_hi = torch.zeros_like(inc_hi)
    st_lo = torch.zeros_like(inc_lo)
    st_hi, st_lo = _step(st_hi, st_lo, inc_hi, inc_lo)
    st_hi, st_lo = _add64(st_hi, st_lo, is_hi, is_lo)
    st_hi, st_lo = _step(st_hi, st_lo, inc_hi, inc_lo)
    return {"hi": st_hi, "lo": st_lo, "inc_hi": inc_hi, "inc_lo": inc_lo}


def next_uint32(state):
    """-> (uint32 values as int64 tensor, new state)."""
    old_hi, old_lo = state["hi"], state["lo"]
    new_hi, new_lo = _step(old_hi, old_lo, state["inc_hi"], state["inc_lo"])
    out = _output(old_hi, old_lo)
    return out, {**state, "hi": new_hi, "lo": new_lo}


def next_float32(state):
    """Uniform in [0, 1) via the [1,2) bit trick (mathutils.h:117-127)."""
    bits, state = next_uint32(state)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0, state


def next_2d(state):
    x, state = next_float32(state)
    y, state = next_float32(state)
    return (x, y), state
