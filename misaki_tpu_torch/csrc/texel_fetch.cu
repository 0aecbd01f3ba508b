// Weighted 4-tap texel fetch for Hopper (sm_90a), and its backward.
//
// Replaces the Pallas TPU kernel of misaki_tpu/render/paged_fetch.py:55
// `_fetch_kernel` (called by `paged_fetch`). The Pallas kernel's sort, pages,
// tile walk and one-hot matmuls work around the TPU's lack of a per-lane
// gather; on this card the gather is a load.
//
// Contract (the same as the Pallas kernel and the plain twin fetch4_plain in
// render/texel_fetch.py): table (N, 3) float32 RGB, texel-major (a texel's
// channels are adjacent); idx4 (4, L) int32 texel ids; w4 (4, L) float32 tap
// weights; out (3, L) float32 with
//     out[c, l] = sum_{k=0..3} w4[k, l] * table[idx4[k, l], c].
// A tap is live when w != 0 and 0 <= idx < N. A dead tap contributes exactly
// 0 and is never read. The four terms are added in tap order k = 0..3
// (acc = t0; acc = acc + t1; ...), each product rounded on its own: built
// with -fmad=false, `acc + w * v` does not contract into a fused multiply-add,
// so the kernel equals its twin bit for bit.
//
// What bounds it on an H100 (`python -m misaki_tpu_torch.tools.profile_texel_fetch`:
// 2^20 lanes, device time with the launch queue held full, NVIDIA H100 80GB
// HBM3 at 700 W; this design's times, the first version's in brackets):
// every lane streams 32 B of taps in and 12 B out, coalesced, 46 MB a
// launch. With every tap dead that stream alone takes 0.0146 ms (0.0162)
// against its bound of 0.0138 ms; every tap on one texel adds 0.0004 ms.
// The four scattered 12-byte texel reads are what cost: random taps into a
// 4 MB table, all in L2, take 0.0346 ms (0.0372), the L2 answering requests
// rather than bytes; into the 100 MB envmap, twice L2, 0.0797 ms (0.0842),
// the rows that miss L2 read from DRAM as random 32-byte sectors (touched
// sectors and stream: 112 MB, 0.034 ms at 3.35 TB/s). The bitmap's mip
// chain (17 MB) stays in L2 with coherent taps: 0.0166 ms (0.0197) against
// a bound of 0.0147 ms. The envmap's importance-sampled NEE taps, 1.3 M
// distinct texels (random taps: 3.3 M): 0.0358 ms (0.0407).
//
// What the design does about it:
//   * idx4 and w4 are loaded and out stored evict-first (ld/st.global.cs),
//     so the 44 B per lane of stream do not push table lines out of L2;
//   * a bilinear row whose two taps are adjacent texels, both live, is read
//     as one span: two 16-byte loads and, for one alignment in four, a 4-byte
//     one, instead of six 4-byte loads (the table is 16-byte aligned). Other
//     rows (the envmap's wrap column, a bitmap's wrap edge, dead taps, any
//     taps that are not quads, a window that would pass the table's end)
//     take per-tap loads;
//   * every load of the lane is issued before the first multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// The RGB texels of the two taps (a, b) of one bilinear row: a dead tap's
// values are 0 and its texel is not read.
__device__ __forceinline__ void load_row(const float* __restrict__ table, long long n, int a,
                                         int b, bool live_a, bool live_b, float* va, float* vb) {
  // the span's six floats [f, f + 6) inside the 16-byte-aligned window
  // [e, e + 8), plus one float for r == 3; the window stays in the table
  const long long f = 3LL * a;
  const long long e = f & ~3LL;
  const int r = (int)(f - e);
  if (live_a && live_b && b == a + 1 && e + (r == 3 ? 9 : 8) <= 3 * n) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(table + e));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(table + e + 4));
    const float w2 = r == 3 ? __ldg(table + e + 8) : 0.0f;
    const float win[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2};
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float x = r == 0 ? win[c] : r == 1 ? win[c + 1] : r == 2 ? win[c + 2] : win[c + 3];
      if (c < 3) {
        va[c] = x;
      } else {
        vb[c - 3] = x;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      va[c] = live_a ? __ldg(table + f + c) : 0.0f;
      vb[c] = live_b ? __ldg(table + 3LL * b + c) : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    fetch4_kernel(const float* __restrict__ table, long long n, const int* __restrict__ idx4,
                  const float* __restrict__ w4, long long L, float* __restrict__ out) {
  const long long l = (long long)blockIdx.x * kBlock + threadIdx.x;
  int id[4];
  float w[4];
  bool live[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    id[k] = l < L ? __ldcs(idx4 + k * L + l) : 0;
    w[k] = l < L ? __ldcs(w4 + k * L + l) : 0.0f;
    live[k] = w[k] != 0.0f && id[k] >= 0 && (long long)id[k] < n;
  }
  float v[4][3];
  load_row(table, n, id[0], id[1], live[0], live[1], v[0], v[1]);
  load_row(table, n, id[2], id[3], live[2], live[3], v[2], v[3]);
  if (l >= L) return;
  float acc[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float term = live[k] ? w[k] * v[k][c] : 0.0f;
      acc[c] = k == 0 ? term : acc[c] + term;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) __stcs(out + c * L + l, acc[c]);
}

// The backward of the fetch: the gradient of the table,
//     grad_table[idx4[k, l], c] += w4[k, l] * grad_out[c, l]
// for each live tap (the forward's rule: w != 0 and 0 <= idx < N); dead taps
// add nothing. grad_table (N, 3) is float64, zeroed by the caller, who
// rounds it to float32 once. The JAX package has no backward kernel (its
// gradient transposes the one-hot matmuls of misaki_tpu/core/table.py:
// 26-58); the plain twin is fetch4_backward_plain in render/texel_fetch.py.
//
// What bounds it: the stream of 44 B per lane (ids, weights, grad_out), read
// once, evict-first as in the forward, and a read-modify-write of each
// distinct live texel in L2. Neighbouring lanes hit the same texels: a
// frame's lanes are a pixel's samples in a row, so a warp's 32 lanes are
// one pixel's and fetch one or two bilinear quads; a coarse mip texel is
// every lane's; the sun's few envmap texels take most NEE taps. Atomics on
// one address serialise in L2, so the contention, not bytes, is what costs.
//
// What the design does about it: one thread per lane; for each tap k the
// warp groups its lanes by texel id (__match_any_sync), sums each group's
// products in float64 in a tree of shuffles (log2 of the largest group's
// size steps; none where every id differs), and the group's lowest lane
// alone adds the sums, one atomicAdd per channel. Its value is unused, so it
// compiles to a reduction (RED.ADD.F64) that does not wait for the old
// value. Each product is rounded to float32 (-fmad=false, nothing to fuse
// anyway) and summed in float64: the order of the atomic sums varies from
// run to run, and two orders of a float32 sum of a coarse mip texel's 10^5
// terms differ by about the twin's tolerance (5e-3 at a scale of 678 on
// chip_smoke.py's bitmap_camera_mips taps, against 7e-3 allowed); in
// float64 they agree after the one rounding.

// Adds to x[] the x[] of every lane of the warp in this lane's group
// `peers` (from __match_any_sync) into the group's lowest lane, in a tree:
// in each step a lane adds the partial sum of the next remaining peer above
// it, and the peers of odd rank drop out. Every lane of the warp calls it.
__device__ __forceinline__ void sum_peers(unsigned peers, double x[3]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);  // 1 + the next peer's lane, 0 if none
    const int src = next > 0 ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double t = __shfl_sync(0xffffffffu, x[c], src);
      if (next > 0) x[c] += t;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
}

__global__ void __launch_bounds__(kBlock)
    fetch4_backward_kernel(const int* __restrict__ idx4, const float* __restrict__ w4,
                           const float* __restrict__ grad_out, long long L, long long n,
                           double* __restrict__ grad_table) {
  const long long l = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool in = l < L;  // lanes past the end take part in the warp's votes
  float g[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) g[c] = in ? __ldcs(grad_out + c * L + l) : 0.0f;
  int id[4];
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    id[k] = in ? __ldcs(idx4 + k * L + l) : -1;
    w[k] = in ? __ldcs(w4 + k * L + l) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool live = w[k] != 0.0f && id[k] >= 0 && (long long)id[k] < n;
    // a dead tap is a group of its own (a negative key no id takes)
    const int key = live ? id[k] : -1 - (int)(threadIdx.x & 31);
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    double x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = live ? (double)(w[k] * g[c]) : 0.0;
    sum_peers(peers, x);
    if (live && (threadIdx.x & 31) == __ffs(peers) - 1) {
      double* dst = grad_table + 3LL * id[k];
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(dst + c, x[c]);
    }
  }
}

}  // namespace

extern "C" int fetch4_backward_launch(const int* idx4, const float* w4, const float* grad_out,
                                      long long L, long long n_texels, double* grad_table,
                                      void* stream) {
  const long long blocks = (L + kBlock - 1) / kBlock;
  if (L <= 0 || n_texels <= 0 || n_texels > 0x7FFFFFFFLL || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  fetch4_backward_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      idx4, w4, grad_out, L, n_texels, grad_table);
  return (int)cudaGetLastError();
}

extern "C" int fetch4_launch(const float* table, long long n_texels, const int* idx4,
                             const float* w4, long long L, float* out, void* stream) {
  const long long blocks = (L + kBlock - 1) / kBlock;
  if (L <= 0 || n_texels <= 0 || n_texels > 0x7FFFFFFFLL || blocks > 0x7FFFFFFFLL ||
      ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  fetch4_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(table, n_texels, idx4,
                                                                        w4, L, out);
  return (int)cudaGetLastError();
}
