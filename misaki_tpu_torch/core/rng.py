"""Bit-exact vectorized PCG32 (reference: include/misaki/core/mathutils.h:89-143).

Every wavefront lane owns its own PCG32 stream, seeded from (lane, seed), so
a render is deterministic for a given seed whatever the chunking or device.
The streams are bit-identical to `misaki_tpu.core.rng`.

The state is carried as two 32-bit limbs, each held in an int64 tensor with
values in [0, 2^32): {hi, lo, inc_hi, inc_lo}. `seed`, `seed_lanes` and
`next_floats` (and `next_float32`, `next_2d`, thin calls of it) take the
path of the state's device: on CUDA tensors one launch of csrc/pcg32.cu a
seeding or a group of draws; on CPU tensors the plain twins (`seed_plain`,
`seed_lanes_plain`, `next_floats_plain`, built on `next_uint32`), which do
the limb arithmetic in torch ops, because PyTorch has no unsigned 64-bit
arithmetic: products are formed from one 32-bit and one 16-bit factor
(< 2^48, exact in int64) and every result is masked back to 32 bits.

While tracing is on, `next_floats` counts the floats a call draws (its k)
in `rng.floats`, and those the kernel drew in `rng.kernel.floats`.
"""

import ctypes

import torch

from misaki_tpu_torch.utils import cuda_build, tracing

PCG32_MULT_HI = 0x5851f42d
PCG32_MULT_LO = 0x4c957f2d

MASK32 = 0xFFFFFFFF
LIMBS = ("hi", "lo", "inc_hi", "inc_lo")
SRC = cuda_build.CSRC / "pcg32.cu"


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


def seed_plain(initstate, initseq=1):
    """The plain twin of `seed`, in torch ops on the words' device: per-lane
    seeding (reference seed(): mathutils.h:96-103).

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


def seed(initstate, initseq=1):
    """Per-lane seeding (reference seed(): mathutils.h:96-103): `seed_plain`
    on CPU tensors, one launch of the kernel on CUDA tensors (int64, each a
    word or one a lane)."""
    is_hi, is_lo = initstate if isinstance(initstate, tuple) else (0, initstate)
    iq_hi, iq_lo = initseq if isinstance(initseq, tuple) else (0, initseq)
    if _device(is_hi, is_lo, iq_hi, iq_lo).type == "cpu":
        return seed_plain(initstate, initseq)
    return _seed_launch(state=is_hi, lane=is_lo, offset=0, xa=iq_hi, xb=0, seq=iq_lo)


def seed_lanes_plain(lane, state, mix, seq, offset=0):
    """The plain twin of `seed_lanes`: its words made by torch ops on the
    lanes' device, then `seed_plain`."""
    lane = lane.to(torch.int64)
    state, seq = (x.expand_as(lane) if isinstance(x, torch.Tensor) else x for x in (state, seq))
    return seed_plain((state, (lane + offset) & MASK32), (lane ^ mix, seq))


def seed_lanes(lane, state, mix, seq, offset=0):
    """The streams of the lanes `lane` (an int tensor): initstate (state,
    lane + offset), initseq (lane ^ mix, seq) as (high, low) words mod 2^32
    (misaki_tpu's driver.make_rng and per-iteration photon-mapping
    streams). state, mix, seq and offset: Python ints, or int64 tensors of
    one word (a captured graph's inputs) or one a lane. `seed_lanes_plain`
    on CPU tensors; on CUDA tensors one launch of the kernel, which does the
    word arithmetic too."""
    if _device(lane, state, mix, seq, offset).type == "cpu":
        return seed_lanes_plain(lane, state, mix, seq, offset)
    return _seed_launch(state=state, lane=lane, offset=offset, xa=lane, xb=mix, seq=seq)


def next_uint32(state):
    """-> (uint32 values as int64 tensor, new state), in torch ops on the
    state's device."""
    old_hi, old_lo = state["hi"], state["lo"]
    new_hi, new_lo = _step(old_hi, old_lo, state["inc_hi"], state["inc_lo"])
    out = _output(old_hi, old_lo)
    return out, {**state, "hi": new_hi, "lo": new_lo}


def next_floats_plain(state, k):
    """The plain twin of `next_floats`: k `next_uint32` draws, each made a
    float by the [1,2) bit trick (mathutils.h:117-127)."""
    out = []
    for _ in range(k):
        bits, state = next_uint32(state)
        out.append(((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    return tuple(out), state


def next_floats(state, k):
    """k floats uniform in [0, 1) from each lane's stream, in draw order,
    and the state after them: (a tuple of k (L,) float32 tensors, the new
    state). `next_floats_plain` on a CPU state, one launch of the kernel on
    a CUDA one; the state passed in is left as it was."""
    k = int(k)
    if k < 1:
        raise ValueError(f"next_floats draws k >= 1 floats, got {k}")
    if _device(*(state[n] for n in LIMBS)).type == "cpu":
        tracing.add(tracing.RNG_FLOATS, k)
        return next_floats_plain(state, k)
    out = _next_floats_launch(state, k)
    tracing.add(tracing.RNG_FLOATS, k)
    tracing.add(tracing.RNG_KERNEL_FLOATS, k)
    return out


def next_float32(state):
    """Uniform in [0, 1) via the [1,2) bit trick (mathutils.h:117-127)."""
    (f,), state = next_floats(state, 1)
    return f, state


def next_2d(state):
    (x, y), state = next_floats(state, 2)
    return (x, y), state


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def build():
    """Compile csrc/pcg32.cu with nvcc for sm_90a (once per source hash) and
    load it. Returns the ctypes library."""
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_build.load_library(SRC, {
        "pcg32_seed_launch": ([i64] + [p, i64, i64] * 6 + [p] * 5, i32),
        "pcg32_next_floats_launch": ([i64, i32] + [p, i64] * 4 + [p] * 4, i32),
    })


def _device(*xs):
    """The one device of the tensors among `xs`, the CPU where there is
    none; raises where they lie on more than one."""
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"PCG32's words and state must lie on one device, got "
                         f"{sorted(str(d) for d in devs)}")
    return devs.pop() if devs else torch.device("cpu")


def _cuda(dev):
    if dev.type != "cuda":
        raise ValueError(f"no PCG32 kernel for device {dev}")
    return torch.cuda.current_stream(dev).cuda_stream


def _word(name, x, L):
    """(address, stride, value) of a seeding word: a Python int as a value,
    a tensor by its address, stride 0 where it holds one word (or is
    broadcast), so a captured graph reads the replay's word."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & MASK32
    if x.dtype != torch.int64:
        raise ValueError(f"PCG32 word {name} must be int64, got {x.dtype}")
    if x.dim() > 1 or x.numel() not in (1, L):
        raise ValueError(f"PCG32 word {name} must hold one word or one a lane ({L}), got "
                         f"shape {tuple(x.shape)}")
    return x.data_ptr(), 0 if x.numel() == 1 else x.stride(0), 0


def _seed_launch(**words):
    """One seeding launch of the words `state`, `lane`, `offset`, `xa`, `xb`,
    `seq` (csrc/pcg32.cu's contract)."""
    dev = _device(*words.values())
    stream = _cuda(dev)
    L = max(x.numel() for x in words.values() if isinstance(x, torch.Tensor))
    args = [a for name in ("state", "lane", "offset", "xa", "xb", "seq")
            for a in _word(name, words[name], L)]
    st = torch.empty((2, L), dtype=torch.int64, device=dev)
    inc = torch.empty((2, L), dtype=torch.int64, device=dev)
    if L:
        cuda_build.check_launch(build().pcg32_seed_launch(
            L, *args, st[0].data_ptr(), st[1].data_ptr(), inc[0].data_ptr(),
            inc[1].data_ptr(), stream), "PCG32 seeding kernel")
        tracing.launches["pcg32"] += 1
    return {"hi": st[0], "lo": st[1], "inc_hi": inc[0], "inc_lo": inc[1]}


def _next_floats_launch(state, k):
    """One launch of k draws from a CUDA state (int64 limbs, hi and lo one
    a lane, the increment's one a lane or one word)."""
    hi = state["hi"]
    dev = hi.device
    stream = _cuda(dev)
    L = hi.numel()
    args = []
    for name in LIMBS:
        x = state[name]
        if x.dtype != torch.int64 or x.dim() != 1 or x.numel() not in (1, L) \
                or (name in ("hi", "lo") and x.numel() != L):
            raise ValueError(f"PCG32 state limb {name} must be an int64 (L,) tensor like hi "
                             f"({L}), got {x.dtype} {tuple(x.shape)}")
        args += [x.data_ptr(), 0 if x.numel() == 1 else x.stride(0)]
    out = torch.empty((k, L), dtype=torch.float32, device=dev)
    new = torch.empty((2, L), dtype=torch.int64, device=dev)
    if L:
        cuda_build.check_launch(build().pcg32_next_floats_launch(
            L, k, *args, out.data_ptr(), new[0].data_ptr(), new[1].data_ptr(), stream),
            "PCG32 draws kernel")
        tracing.launches["pcg32"] += 1
    return tuple(out.unbind(0)), {**state, "hi": new[0], "lo": new[1]}
