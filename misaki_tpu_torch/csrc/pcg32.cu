// PCG32 for Hopper (sm_90a): a lane's seeding, and a group of k draws from
// each lane's stream, each as one launch. The plain twins are
// `core/rng.py` `seed_plain` (`seed_lanes_plain`) and `next_floats_plain`,
// which carry the 64-bit state as two 32-bit limbs in int64 tensors and
// issue 87 torch ops to seed driver.make_rng's streams and 54 a float
// (PyTorch has no unsigned 64-bit arithmetic).
//
// Replaces no Pallas kernel: misaki_tpu's PCG32 (misaki_tpu/core/rng.py) is
// plain jnp, which XLA fuses into the kernels around it. On the card the
// twin's ops are separate elementwise kernels over every lane, a third of a
// path chunk's kernels.
//
// Contract (the same as the twins', bit for bit):
//   state: four int64 limbs a lane, each in [0, 2^32): hi, lo (the state's
//   high and low words) and inc_hi, inc_lo (the stream's increment); a
//   limb may be broadcast (stride 0).
//   pcg32_seed: per lane i, initstate = (state_w << 32) | ((lane + offset)
//   mod 2^32) and initseq = (((xa ^ xb) mod 2^32) << 32) | (seq mod 2^32),
//   each of the six words read at i * stride of its pointer (stride 0: one
//   word for every lane), or a constant where its pointer is null; then
//   misaki's seed(): inc = (initseq << 1) | 1, state = 0, one LCG step,
//   state += initstate, one LCG step. driver.make_rng and ppm._lane_rng
//   pass lane = xa = the lanes, offset the lane offset and xb the mix word;
//   a generic seed passes offset 0 and xb 0. A seed word that changes from
//   frame to frame comes in through a pointer, so a captured CUDA graph
//   reads the replay's word and not the capture's.
//   pcg32_next_floats: k draws a lane, in stream order: out[j * L + i] =
//   ((xsh_rr(old) >> 9) | 0x3F800000 as float) - 1 in [0, 1) with old the
//   state before draw j; the state after the k-th step written as new
//   limbs hi, lo (the increment does not change). The input limbs are read
//   only: a caller may still hold the old state.
//
// What bounds it: bytes. A draw is an integer multiply-add and a few
// shifts, under 20 integer operations; each lane reads its 32 B of state
// and writes 16 B of state and 4 B a float, so a group of k = 6 over 2^20
// lanes moves 72 MB, 21.6 us at 3.35 TB/s, and a seeding of 2^20 lanes
// reads 8 B of lanes and writes 32 B of state, 12.5 us.
//
// What the design does about it: one thread a lane, the state in registers
// as one uint64 from the first read to the last write, and every float
// written straight to its row of the (k, L) output: a warp's 32 lanes read
// and write 32 consecutive words of each limb and each row, whole sectors.
// The k draws of a group stay in registers, where the twin wrote and read
// back eight int64 temporaries a draw. Words shared by every lane (stride
// 0) are one load that the L1 serves to the whole warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr uint64_t kMult = 0x5851f42d4c957f2dULL;
constexpr uint64_t kMask32 = 0xFFFFFFFFULL;

// A word of the seeding: a lane's value at p[i * stride], or `value` for
// every lane where p is null.
struct Word {
  const long long* p;
  long long stride;
  long long value;
};

struct SeedWords {
  Word state, lane, offset, xa, xb, seq;
};

// A limb of the state, read at p[i * stride].
struct Limb {
  const long long* p;
  long long stride;
};

struct State {
  Limb hi, lo, inc_hi, inc_lo;
};

__device__ __forceinline__ uint64_t word_at(const Word& w, long long i) {
  return w.p ? (uint64_t)__ldg(w.p + i * w.stride) : (uint64_t)w.value;
}

__device__ __forceinline__ uint64_t limb_at(const Limb& l, long long i) {
  return (uint64_t)__ldg(l.p + i * l.stride) & kMask32;
}

__global__ void __launch_bounds__(kBlock)
    seed_kernel(SeedWords w, long long L, long long* __restrict__ hi, long long* __restrict__ lo,
                long long* __restrict__ inc_hi, long long* __restrict__ inc_lo) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= L) return;
  const uint64_t initstate =
      ((word_at(w.state, i) & kMask32) << 32) | ((word_at(w.lane, i) + word_at(w.offset, i)) & kMask32);
  const uint64_t initseq =
      (((word_at(w.xa, i) ^ word_at(w.xb, i)) & kMask32) << 32) | (word_at(w.seq, i) & kMask32);
  const uint64_t inc = (initseq << 1) | 1ULL;
  uint64_t s = inc;           // 0 * kMult + inc
  s += initstate;
  s = s * kMult + inc;
  hi[i] = (long long)(s >> 32);
  lo[i] = (long long)(s & kMask32);
  inc_hi[i] = (long long)(inc >> 32);
  inc_lo[i] = (long long)(inc & kMask32);
}

__global__ void __launch_bounds__(kBlock)
    next_floats_kernel(State st, long long L, int k, float* __restrict__ out,
                       long long* __restrict__ new_hi, long long* __restrict__ new_lo) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= L) return;
  uint64_t s = (limb_at(st.hi, i) << 32) | limb_at(st.lo, i);
  const uint64_t inc = (limb_at(st.inc_hi, i) << 32) | limb_at(st.inc_lo, i);
  for (int j = 0; j < k; ++j) {
    const uint64_t old = s;
    s = old * kMult + inc;
    const uint32_t xorshifted = (uint32_t)(((old >> 18) ^ old) >> 27);
    const uint32_t rot = (uint32_t)(old >> 59);
    const uint32_t bits = (xorshifted >> rot) | (xorshifted << ((0u - rot) & 31u));
    out[(long long)j * L + i] = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  }
  new_hi[i] = (long long)(s >> 32);
  new_lo[i] = (long long)(s & kMask32);
}

long long grid_of(long long L) { return (L + kBlock - 1) / kBlock; }

}  // namespace

// Each of the six words as (pointer or null, stride, value); the four
// limbs written contiguous, L of each.
extern "C" int pcg32_seed_launch(long long L,
                                 const long long* state_p, long long state_s, long long state_v,
                                 const long long* lane_p, long long lane_s, long long lane_v,
                                 const long long* offset_p, long long offset_s, long long offset_v,
                                 const long long* xa_p, long long xa_s, long long xa_v,
                                 const long long* xb_p, long long xb_s, long long xb_v,
                                 const long long* seq_p, long long seq_s, long long seq_v,
                                 long long* hi, long long* lo, long long* inc_hi,
                                 long long* inc_lo, void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const SeedWords w{{state_p, state_s, state_v}, {lane_p, lane_s, lane_v},
                    {offset_p, offset_s, offset_v}, {xa_p, xa_s, xa_v},
                    {xb_p, xb_s, xb_v}, {seq_p, seq_s, seq_v}};
  seed_kernel<<<grid_of(L), kBlock, 0, (cudaStream_t)stream>>>(w, L, hi, lo, inc_hi, inc_lo);
  return (int)cudaGetLastError();
}

// The four limbs as (pointer, stride); out (k, L) float32 and the new hi,
// lo (L,) contiguous.
extern "C" int pcg32_next_floats_launch(long long L, int k,
                                        const long long* hi, long long hi_s,
                                        const long long* lo, long long lo_s,
                                        const long long* inc_hi, long long inc_hi_s,
                                        const long long* inc_lo, long long inc_lo_s,
                                        float* out, long long* new_hi, long long* new_lo,
                                        void* stream) {
  if (L <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const State st{{hi, hi_s}, {lo, lo_s}, {inc_hi, inc_hi_s}, {inc_lo, inc_lo_s}};
  next_floats_kernel<<<grid_of(L), kBlock, 0, (cudaStream_t)stream>>>(st, L, k, out, new_hi,
                                                                      new_lo);
  return (int)cudaGetLastError();
}
