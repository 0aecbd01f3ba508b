"""PCG32 (O'Neill's permuted congruential generator, XSH-RR output) and
the per-lane streams of the jobs: the one definition the reference shares
with the program, since a sample-for-sample comparison needs both sides to
draw the same numbers. Everything that uses the numbers is written anew.

The 64-bit state is carried as two 32-bit limbs in int64 tensors (PyTorch
has no unsigned 64-bit arithmetic); products of a 32-bit and a 16-bit factor
stay exact in int64.
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
    """Per-lane seeding (PCG32's srandom).

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
    """Uniform in [0, 1): the top 23 bits as the mantissa of a float in [1, 2), less 1."""
    bits, state = next_uint32(state)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0, state


def next_2d(state):
    x, state = next_float32(state)
    y, state = next_float32(state)
    return (x, y), state


M32 = MASK32


def path_stream(lane, seed_):
    """The stream of path lane `lane` (pixel * spp + sample) of a frame with
    seed `seed_`: initstate (seed * 0x9E3779B9, lane), initseq (lane ^ seed *
    2654435761, seed | 1), each half in uint32."""
    s = int(seed_) & M32
    lane = lane.to(torch.int64) & M32
    return seed(((s * 0x9E3779B9) & M32, lane), (lane ^ ((s * 2654435761) & M32), s | 1))


def iteration_stream(lane, mult, it, lane_offset, mix, seed_):
    """The stream of lane `lane` in photon-mapping iteration `it`: initstate
    (seed * mult + it, lane + lane_offset), initseq (lane ^ it * mix,
    seed | 1), each half in uint32. The camera pass takes mult 0x9E3779B9,
    offset 0, mix 0x85EBCA6B; the photon pass 0x6C078965, 0x400000,
    0xB5297A4D."""
    s = int(seed_) & M32
    return seed((((s * mult) + it) & M32, (lane + lane_offset) & M32),
                (lane ^ ((it * mix) & M32), (s | 1) & M32))


def iteration_wavelength_sample(it, seed_, device):
    """The one uniform number that picks iteration `it`'s hero wavelengths:
    the first draw of the stream initstate (0xA511E9B3, it), initseq
    (seed, 7). -> (1,) float32."""
    st = seed((0xA511E9B3, torch.full((1,), int(it), dtype=torch.int64, device=device)),
              (int(seed_) & M32, 7))
    return next_float32(st)[0]
