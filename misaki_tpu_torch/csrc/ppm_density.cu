// Dense photon density estimation for Hopper (sm_90a): the pair sum of the
// `sppm` and `photonmapper` integrators.
//
// Replaces misaki_tpu/render/ppm.py:282 `_density_blocks`, an XLA matmul
// rather than a Pallas kernel: per 2048-photon block it forms the (2048, L)
// pair mask and sums the flux as one (4, B) x (B, L) matrix product, which
// keeps the TPU's matrix unit busy. On this card that form writes about
// twenty (2048, L) float32 temporaries a block to device memory; here the
// pair test and the sum stay in registers.
//
// Contract (the same as the plain twin `density_plain` in render/ppm.py):
//   ph  (14, P) float32 rows: photon position (3), incoming direction wi
//       (3, pointing away from the surface), shading normal n (3), flux (4),
//       alive flag (1: alive, 0: not);
//   vp  (11, L) float32 rows: visible point position (3), camera direction
//       wi (3), normal n (3), squared radius r2, live flag (valid and not
//       glossy);
//   sppm: 1 for sppm, 0 for the photonmapper;
//   phi (4, L), count (L,) float32, written once:
//     phi[c, i] = sum_j flux[c, j] * mask[j, i],  count[i] = sum_j mask[j, i],
//     mask[j, i] = d2 < r2[i] && cosw > 0 && alive[j] && wi_j . n_j > 0
//                  && live[i],
//   with d2 = dx*dx + dy*dy + dz*dz, (dx, dy, dz) = p_j - p_i, and cosw =
//   n_j . wi_i in sppm (the photon's frame against the camera direction),
//   wi_j . n_i in the photonmapper. Built with -fmad=false, each of these is
//   the twin's float32 expression rounded as the twin rounds it, so the mask
//   and the counts equal the twin's bit for bit; the flux sums are taken in
//   photon order here and by a matmul there, so they agree to rounding.
//
// What bounds it: the pair tests. About 15 FP32 operations a pair (three
// differences, five for d2, five for cosw, two compares) and 5 more for a
// pair that passes: at 262,144 photons against a 256x256 image 1.7e10
// pairs, 4 ms a launch at the card's 67 TFLOP/s, against 19 MB of inputs
// and outputs (6 us at 3.35 TB/s).
//
// What the design does about it (a first, simple design):
//   * one thread per visible point, its position, direction, r2 and the
//     running sums in registers; a dead visible point skips the photon loop;
//   * the photons staged through shared memory in tiles of one block's size,
//     as three float4 per photon: (p, alive and wi . n > 0), the direction
//     the mode tests, and the flux, read only for a pair that passes; every
//     thread of a warp reads the same photon, a broadcast;
//   * nothing but phi and count is written.
// Not done here (ROADMAP Queue 2): a spatial hash or a sort of the visible
// points by cell, which would skip the pairs that cannot pass; with one
// thread per visible point a 256x256 image gives 2,048 warps, about 15 of the
// 64 an SM can hold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    density_kernel(const float* __restrict__ ph, long long P, const float* __restrict__ vp,
                   long long L, int sppm, float* __restrict__ phi, float* __restrict__ count) {
  __shared__ float4 s_pos[kBlock];   // p, and 1 where the photon may contribute
  __shared__ float4 s_dir[kBlock];   // n (sppm) or wi (photonmapper)
  __shared__ float4 s_flux[kBlock];

  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool in = i < L;
  float px = 0.0f, py = 0.0f, pz = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f, r2 = 0.0f;
  bool live = false;
  if (in) {
    px = vp[i];
    py = vp[L + i];
    pz = vp[2 * L + i];
    const long long d = sppm ? 3 : 6;   // wi in sppm, n in the photonmapper
    ax = vp[d * L + i];
    ay = vp[(d + 1) * L + i];
    az = vp[(d + 2) * L + i];
    r2 = vp[9 * L + i];
    live = vp[10 * L + i] != 0.0f;
  }
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f, c = 0.0f;

  for (long long base = 0; base < P; base += kBlock) {
    const long long j = base + threadIdx.x;
    if (j < P) {
      const float wx = ph[3 * P + j], wy = ph[4 * P + j], wz = ph[5 * P + j];
      const float nx = ph[6 * P + j], ny = ph[7 * P + j], nz = ph[8 * P + j];
      const float wiz = wx * nx + wy * ny + wz * nz;
      const bool ok = ph[13 * P + j] != 0.0f && wiz > 0.0f;
      s_pos[threadIdx.x] = make_float4(ph[j], ph[P + j], ph[2 * P + j], ok ? 1.0f : 0.0f);
      s_dir[threadIdx.x] = sppm ? make_float4(nx, ny, nz, 0.0f) : make_float4(wx, wy, wz, 0.0f);
      s_flux[threadIdx.x] =
          make_float4(ph[9 * P + j], ph[10 * P + j], ph[11 * P + j], ph[12 * P + j]);
    }
    __syncthreads();
    if (live) {
      const int n = (int)(P - base < kBlock ? P - base : kBlock);
      for (int k = 0; k < n; ++k) {
        const float4 q = s_pos[k];
        const float dx = q.x - px;
        const float dy = q.y - py;
        const float dz = q.z - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float4 e = s_dir[k];
        const float cosw = e.x * ax + e.y * ay + e.z * az;
        if (d2 < r2 && cosw > 0.0f && q.w != 0.0f) {
          const float4 fl = s_flux[k];
          f0 += fl.x;
          f1 += fl.y;
          f2 += fl.z;
          f3 += fl.w;
          c += 1.0f;
        }
      }
    }
    __syncthreads();
  }
  if (in) {
    phi[i] = f0;
    phi[L + i] = f1;
    phi[2 * L + i] = f2;
    phi[3 * L + i] = f3;
    count[i] = c;
  }
}

}  // namespace

extern "C" int density_launch(const float* ph, long long P, const float* vp, long long L,
                              int sppm, float* phi, float* count, void* stream) {
  const long long blocks = (L + kBlock - 1) / kBlock;
  if (L <= 0 || P < 0 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  density_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(ph, P, vp, L, sppm,
                                                                         phi, count);
  return (int)cudaGetLastError();
}
