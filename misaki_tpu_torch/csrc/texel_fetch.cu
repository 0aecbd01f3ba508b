// Weighted 4-tap texel fetch for Hopper (sm_90a).
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

}  // namespace

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
