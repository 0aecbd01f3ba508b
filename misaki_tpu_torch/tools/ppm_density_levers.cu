// The photon density estimate's levers, for `tools/profile_ppm_density.py`.
// The render path never builds or launches this file: the port launches the
// one set that measured best from csrc/ppm_density.cu.
//
//   density_dense_launch  the first, dense kernel, unchanged: one thread per
//                         visible point, every photon staged through shared
//                         memory in 256-photon tiles and tested (the dense
//                         form of misaki_tpu's blocked matmul);
//   density_lever_launch  the grid design of csrc/ppm_density.cu (included
//                         below, so its binning and gather are the port's
//                         own) with two switches: `lanes` per visible point
//                         (1, 2, 4, 8, 16 or 32) and `cell_order`, which
//                         sorts the visible points by their cell with the
//                         same radix sort (dead ones last), copies their
//                         rows into that order, gathers the copy and puts
//                         phi and count back in index order, so the lanes
//                         of neighbouring visible points read the same
//                         photons (the port's gather is unchanged; the
//                         copies are two more launches).
//
// Contract: that of csrc/ppm_density.cu, for both.

#include "../csrc/ppm_density.cu"

namespace dense {

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

}  // namespace dense

namespace {

// The visible points' keys (a dead one the sentinel) and the block's counts
// of the first digit.
__global__ void __launch_bounds__(kSortThreads)
    density_vp_keys_kernel(const float* __restrict__ vp, long long L, Grid g, unsigned sentinel,
                           unsigned* __restrict__ keys, int* __restrict__ vals,
                           int* __restrict__ hist, int blocks) {
  __shared__ int s_count[kDigits];
  s_count[threadIdx.x] = 0;
  __syncthreads();
  for (int r = 0; r < kItems; ++r) {
    const long long i = (long long)blockIdx.x * kTile + r * kSortThreads + threadIdx.x;
    if (i >= L) break;
    unsigned key = sentinel;
    if (vp[10 * L + i] != 0.0f) {
      const int cx = cell_of(vp[i], g.lo[0], g.inv_h, g.n[0]);
      const int cy = cell_of(vp[L + i], g.lo[1], g.inv_h, g.n[1]);
      const int cz = cell_of(vp[2 * L + i], g.lo[2], g.inv_h, g.n[2]);
      key = (unsigned)((cz * g.n[1] + cy) * g.n[0] + cx);
    }
    keys[i] = key;
    vals[i] = (int)i;
    atomicAdd(&s_count[key & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[blockIdx.x * kDigits + threadIdx.x] = s_count[threadIdx.x];
}

// The visible points sorted by cell: returns the order's buffer in `work`.
cudaError_t enqueue_vp_order(const Plan& p, const float* vp, const Grid& g, void* work,
                             cudaStream_t st, int* launches, const int** order) {
  int* hist = at<int>(work, p.hist);
  density_vp_keys_kernel<<<p.blocks, kSortThreads, 0, st>>>(
      vp, p.P, g, (unsigned)p.n_cells, at<unsigned>(work, p.keys[0]), at<int>(work, p.vals[0]),
      hist, p.blocks);
  DENSITY_LAUNCHED();
  int src = 0;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int shift = pass * kDigitBits;
    if (pass > 0) {
      density_hist_kernel<<<p.blocks, kSortThreads, 0, st>>>(at<unsigned>(work, p.keys[src]),
                                                              p.P, shift, hist, p.blocks);
      DENSITY_LAUNCHED();
    }
    density_scan_kernel<<<1, kScanThreads, 0, st>>>(hist, p.blocks);
    DENSITY_LAUNCHED();
    density_scatter_kernel<false><<<p.blocks, kSortThreads, 0, st>>>(
        at<unsigned>(work, p.keys[src]), at<int>(work, p.vals[src]), p.P, shift, hist, p.blocks,
        at<unsigned>(work, p.keys[1 - src]), at<int>(work, p.vals[1 - src]), nullptr,
        (unsigned)p.n_cells, nullptr);
    DENSITY_LAUNCHED();
    src = 1 - src;
  }
  *order = at<int>(work, p.vals[src]);
  return cudaSuccess;
}

// The visible points' (11, L) rows in `order`: out[r, s] = vp[r, order[s]].
__global__ void __launch_bounds__(kBoundsThreads)
    density_vp_permute_kernel(const float* __restrict__ vp, long long L,
                              const int* __restrict__ order, float* __restrict__ out) {
  const long long s = (long long)blockIdx.x * kBoundsThreads + threadIdx.x;
  if (s >= L) return;
  const long long i = order[s];
  for (int r = 0; r < 11; ++r) out[r * L + s] = vp[r * L + i];
}

// phi and count back in index order: phi[c, order[s]] = phi_s[c, s].
__global__ void __launch_bounds__(kBoundsThreads)
    density_vp_unpermute_kernel(const float* __restrict__ phi_s, const float* __restrict__ count_s,
                                long long L, const int* __restrict__ order,
                                float* __restrict__ phi, float* __restrict__ count) {
  const long long s = (long long)blockIdx.x * kBoundsThreads + threadIdx.x;
  if (s >= L) return;
  const long long i = order[s];
  for (int c = 0; c < 4; ++c) phi[c * L + i] = phi_s[c * L + s];
  count[i] = count_s[s];
}

// The gather over G lanes a visible point, the visible points in cell order
// (sorted, copied, gathered, put back) or in index order.
template <int G>
cudaError_t enqueue_lever_gather(const Plan& p, const Plan& q, const Grid& g, const float* vp,
                                 long long L, int sppm, int cell_order, void* work, float* phi,
                                 float* count, unsigned long long* tests, cudaStream_t st,
                                 int* launches) {
  if (!cell_order) return enqueue_gather<G>(p, g, vp, L, sppm, work, phi, count, tests, st, launches);
  void* vp_work = at<char>(work, p.bytes);
  const int* order = nullptr;
  cudaError_t err = enqueue_vp_order(q, vp, g, vp_work, st, launches, &order);
  if (err != cudaSuccess) return err;
  float* vp_s = at<float>(vp_work, q.bytes);
  float* phi_s = vp_s + 11 * L;
  float* count_s = phi_s + 4 * L;
  const unsigned blocks = (unsigned)((L + kBoundsThreads - 1) / kBoundsThreads);
  density_vp_permute_kernel<<<blocks, kBoundsThreads, 0, st>>>(vp, L, order, vp_s);
  DENSITY_LAUNCHED();
  err = enqueue_gather<G>(p, g, vp_s, L, sppm, work, phi_s, count_s, tests, st, launches);
  if (err != cudaSuccess) return err;
  density_vp_unpermute_kernel<<<blocks, kBoundsThreads, 0, st>>>(phi_s, count_s, L, order, phi,
                                                                  count);
  DENSITY_LAUNCHED();
  return cudaSuccess;
}

// Bytes of the lever workspace: the photons' plan, the visible points'
// plan, their rows in cell order and phi and count in that order.
size_t lever_bytes(const Plan& p, const Plan& q, long long L) {
  return p.bytes + q.bytes + align_up(4 * 16 * (size_t)L);
}

}  // namespace

extern "C" int density_dense_launch(const float* ph, long long P, const float* vp, long long L,
                                    int sppm, float* phi, float* count, void* stream) {
  const long long blocks = (L + dense::kBlock - 1) / dense::kBlock;
  if (L <= 0 || P < 0 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  dense::density_kernel<<<(unsigned)blocks, dense::kBlock, 0, (cudaStream_t)stream>>>(
      ph, P, vp, L, sppm, phi, count);
  return (int)cudaGetLastError();
}

// Bytes of density_lever_launch's workspace (`lever_bytes`).
extern "C" long long density_lever_workspace_bytes(long long P, long long L, long long n_cells) {
  if (P < 0 || L < 1 || n_cells < 1 || n_cells >= (1LL << 30)) return -1;
  return (long long)lever_bytes(make_plan(P, (int)n_cells), make_plan(L, (int)n_cells), L);
}

extern "C" int density_lever_launch(const float* ph, long long P, const float* vp, long long L,
                                    int sppm, float lo_x, float lo_y, float lo_z, float inv_h,
                                    int nx, int ny, int nz, int lanes, int cell_order, void* work,
                                    long long work_bytes, float* phi, float* count,
                                    unsigned long long* tests, int* launches, void* stream) {
  Grid g;
  *launches = 0;
  if (!make_grid(P, L, lo_x, lo_y, lo_z, inv_h, nx, ny, nz, &g) || L > 0x7FFFFFFFLL - kTile)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(P, nx * ny * nz), q = make_plan(L, nx * ny * nz);
  if (work_bytes < (long long)lever_bytes(p, q, L)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = enqueue_binning(p, ph, sppm, g, work, st, launches);
  if (err != cudaSuccess) return (int)err;
  switch (lanes) {
    case 1:
      return (int)enqueue_lever_gather<1>(p, q, g, vp, L, sppm, cell_order, work, phi, count,
                                           tests, st, launches);
    case 2:
      return (int)enqueue_lever_gather<2>(p, q, g, vp, L, sppm, cell_order, work, phi, count,
                                           tests, st, launches);
    case 4:
      return (int)enqueue_lever_gather<4>(p, q, g, vp, L, sppm, cell_order, work, phi, count,
                                           tests, st, launches);
    case 8:
      return (int)enqueue_lever_gather<8>(p, q, g, vp, L, sppm, cell_order, work, phi, count,
                                           tests, st, launches);
    case 16:
      return (int)enqueue_lever_gather<16>(p, q, g, vp, L, sppm, cell_order, work, phi, count,
                                           tests, st, launches);
    case 32:
      return (int)enqueue_lever_gather<32>(p, q, g, vp, L, sppm, cell_order, work, phi, count,
                                           tests, st, launches);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
