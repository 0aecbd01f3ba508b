// Weighted 4-tap texel fetch for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of misaki_tpu/render/paged_fetch.py:
//   fetch4_kernel <- _fetch_kernel (called by paged_fetch)
//
// Contract (the same as the Pallas kernel and the plain twin fetch4_plain in
// render/texel_fetch.py): table (N, 3) float32 RGB, texel-major (a texel's
// channels are adjacent); idx4 (4, L) int32 texel ids; w4 (4, L) float32
// tap weights; out (3, L) float32 with
//     out[c, l] = sum_{k=0..3} w4[k, l] * table[idx4[k, l], c].
// A tap is live when w != 0 and 0 <= idx < N. A dead tap contributes
// exactly 0 and is never read: the Pallas kernel drops taps with w == 0
// from its page walk (paged_fetch.py:63-66), and callers mask lanes with
// zero weights and arbitrary ids.
//
// Design: one thread per lane, the four taps summed in tap order k = 0..3
// (acc = t0; acc = acc + t1; ...), each term rounded on its own. The
// Pallas kernel's sort, pages, tile walk and one-hot matmuls work around
// the TPU's lack of a per-lane gather; on this card the gather is a load.
//
// What bounds it on an H100: memory. Per lane it streams 32 bytes of taps
// in and 12 bytes out, coalesced, and makes four scattered 12-byte texel
// reads. Bilinear taps of one lane share rows, and the taps of camera-
// coherent lanes share sectors, so the scattered reads mostly hit L2. The
// slice's largest table (a 2048x4096 RGB envmap, 100 MB) is twice L2, so
// random directions miss to HBM: about two 32-byte sectors per lane.
//
// Built with -fmad=false: `acc + w * v` would otherwise contract into a
// fused multiply-add, and this kernel is held bit for bit against its plain
// twin, which rounds the product before the sum.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChannels = 3;

__global__ void fetch4_kernel(const float* __restrict__ table, long long n_texels,
                              const int* __restrict__ idx4, const float* __restrict__ w4,
                              long long L, float* __restrict__ out) {
  const long long l = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (l >= L) return;
  float acc[kChannels];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = idx4[k * L + l];
    const float w = w4[k * L + l];
    const bool live = w != 0.0f && i >= 0 && (long long)i < n_texels;
    // a dead tap reads texel 0, which exists, and its value is discarded
    const float* t = table + (live ? (long long)i : 0LL) * kChannels;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      const float term = live ? w * __ldg(t + c) : 0.0f;
      acc[c] = k == 0 ? term : acc[c] + term;
    }
  }
#pragma unroll
  for (int c = 0; c < kChannels; ++c) out[c * L + l] = acc[c];
}

}  // namespace

extern "C" int fetch4_launch(const float* table, long long n_texels, const int* idx4,
                             const float* w4, long long L, float* out, void* stream) {
  const long long blocks = (L + kBlock - 1) / kBlock;
  if (L <= 0 || n_texels <= 0 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fetch4_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(table, n_texels, idx4,
                                                                        w4, L, out);
  return (int)cudaGetLastError();
}
