// Cluster-BVH closest-hit and any-hit kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of misaki_tpu/accel/cluster.py:
//   closest_hit_kernel <- _closest_kernel (called by intersect_clusters)
//   any_hit_kernel     <- _anyhit_kernel  (called by ray_test_clusters)
//
// Contract (identical to the Pallas kernels and to the plain twins in
// accel/cluster.py): rays (8, Lp) rows [ox oy oz dx dy dz mint maxt], Lp a
// multiple of 256; tri (C, B, 10) rows [p0(3) e1(3) e2(3) face_id], pads
// have face_id -1 and sit at the end of their cluster; tab (C, T, B) face
// rows in cluster order; the schedule of cull_order: order/keys
// (Lp/256, max_visits) int32/float32 and count (Lp/256,) int32, negative =
// scan all |count| clusters in id order.
//
// Design: one block per 256-ray tile, one thread per ray. The block walks
// the tile's front-to-back visit list; for each visited cluster it stages the
// (B, 10) face block in shared memory (5 KB) and every thread runs dense
// Moller-Trumbore over it. The block continues while any of its rays can
// still be served by the next cluster (__syncthreads_or), which is exactly
// the Pallas tile-wide exit: closest hit stops once the next key is >= every
// ray's committed t; any hit once every ray is occluded or the key is past
// every open ray's maxt.
//
// Ties (same as Pallas): inside a cluster the largest face id among equal t
// wins; across clusters a commit needs a strictly smaller t, so the first
// cluster visited wins. Misses give t = 3e38 (the wrapper maps it to inf),
// face id -1 and an all-zero face row.
//
// What bounds it on an H100: the tables are small and stay in L2 (cbox: one
// 32-face cluster; the 20,480-face bunny stand-in: 160 clusters, 0.8 MB of
// faces), so the kernel is bound by its arithmetic: ~30 FP32 operations and
// one division per ray-triangle test, issued from shared memory. The block
// stages each cluster once for 256 rays, so a face costs 40 bytes of global
// load per 256 tests; pads end a cluster's loop early. Coherent tiles (cbox
// primaries are 4 pixels x 64 samples) exit after few visits. Measured on
// an H100 SXM at 700 W: 2^20 random rays x 160 clusters x 128 faces (full
// scans) in 63 ms, ~3.4e11 ray-triangle tests/s, about a fifth of the FP32
// peak at ~35 operations per test. Later work: in-kernel cull, wider tiles,
// persistent blocks, fma.
//
// Built with -fmad=false: a fused multiply-add changes t in the last ulp and
// can flip edge and tie cases, and this kernel is held bit-for-bit against
// its plain PyTorch twin, which rounds every product.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kMaxFaces = 128;
constexpr float kBig = 3.0e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint, maxt;
};

__device__ __forceinline__ Ray load_ray(const float* rays, long long Lp, long long lane) {
  Ray r;
  r.ox = rays[0 * Lp + lane];
  r.oy = rays[1 * Lp + lane];
  r.oz = rays[2 * Lp + lane];
  r.dx = rays[3 * Lp + lane];
  r.dy = rays[4 * Lp + lane];
  r.dz = rays[5 * Lp + lane];
  r.mint = rays[6 * Lp + lane];
  r.maxt = rays[7 * Lp + lane];
  return r;
}

// Moller-Trumbore, written in the operation order of misaki_tpu's
// _mt_cluster so that every rounding matches.
__device__ __forceinline__ bool mt(const Ray& r, const float* f, float t_cap,
                                   float& t, float& u, float& v) {
  const float p0x = f[0], p0y = f[1], p0z = f[2];
  const float e1x = f[3], e1y = f[4], e1z = f[5];
  const float e2x = f[6], e2y = f[7], e2z = f[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t >= r.mint && t <= t_cap;
}

__device__ __forceinline__ void stage(float* s_tri, const float* tri, int c, int B) {
  const float* src = tri + (long long)c * B * 10;
  for (int i = threadIdx.x; i < B * 10; i += blockDim.x) s_tri[i] = src[i];
}

__global__ void __launch_bounds__(kTile)
closest_hit_kernel(const float* __restrict__ rays, long long Lp,
                   const float* __restrict__ tri, const float* __restrict__ tab,
                   int C, int B, int T, const int* __restrict__ order,
                   const float* __restrict__ keys, const int* __restrict__ count,
                   int max_visits, float* __restrict__ out, float* __restrict__ fd) {
  __shared__ float s_tri[kMaxFaces * 10];
  const long long tile = blockIdx.x;
  const long long lane = tile * kTile + threadIdx.x;
  const Ray r = load_ray(rays, Lp, lane);

  float t_b = fminf(r.maxt, kBig);
  float u_b = 0.0f, v_b = 0.0f, f_b = -1.0f;
  int c_win = 0, s_win = 0;

  const int n_raw = count[tile];
  const bool full = n_raw < 0;
  const int n = full ? -n_raw : n_raw;
  for (int k = 0; k < n; ++k) {
    const int kk = min(k, max_visits - 1);
    const bool need = full || keys[tile * max_visits + kk] < t_b;
    if (!__syncthreads_or(need)) break;
    const int c = min(full ? k : order[tile * max_visits + kk], C - 1);
    stage(s_tri, tri, c, B);
    __syncthreads();

    float tmin = kBig, fwin = -1.0f, um = 0.0f, vm = 0.0f;
    int swin = 0;
    for (int j = 0; j < B; ++j) {
      const float* f = s_tri + j * 10;
      const float fid = f[9];
      if (fid < 0.0f) break;  // pads only trail a cluster's faces
      float t, u, v;
      if (!mt(r, f, t_b, t, u, v)) continue;
      if (t < tmin || (t == tmin && fid > fwin)) {
        tmin = t;
        fwin = fid;
        um = u;
        vm = v;
        swin = j;
      }
    }
    if (tmin < t_b) {
      t_b = tmin;
      u_b = um;
      v_b = vm;
      f_b = fwin;
      c_win = c;
      s_win = swin;
    }
    __syncthreads();  // the next stage overwrites s_tri
  }

  const bool hit = f_b >= 0.0f;
  out[0 * Lp + lane] = hit ? t_b : kBig;
  out[1 * Lp + lane] = u_b;
  out[2 * Lp + lane] = v_b;
  out[3 * Lp + lane] = f_b;
  const float* row = tab + (long long)c_win * T * B + s_win;
  for (int i = 0; i < T; ++i) fd[i * Lp + lane] = hit ? row[(long long)i * B] : 0.0f;
}

__global__ void __launch_bounds__(kTile)
any_hit_kernel(const float* __restrict__ rays, long long Lp,
               const float* __restrict__ tri, int C, int B,
               const int* __restrict__ order, const float* __restrict__ keys,
               const int* __restrict__ count, int max_visits,
               float* __restrict__ out) {
  __shared__ float s_tri[kMaxFaces * 10];
  const long long tile = blockIdx.x;
  const long long lane = tile * kTile + threadIdx.x;
  const Ray r = load_ray(rays, Lp, lane);
  const float maxt_cap = fminf(r.maxt, kBig);

  bool occ = false;
  const int n_raw = count[tile];
  const bool full = n_raw < 0;
  const int n = full ? -n_raw : n_raw;
  for (int k = 0; k < n; ++k) {
    const int kk = min(k, max_visits - 1);
    const bool need = full || (!occ && keys[tile * max_visits + kk] <= maxt_cap);
    if (!__syncthreads_or(need)) break;
    const int c = min(full ? k : order[tile * max_visits + kk], C - 1);
    stage(s_tri, tri, c, B);
    __syncthreads();
    if (!occ) {
      for (int j = 0; j < B; ++j) {
        const float* f = s_tri + j * 10;
        if (f[9] < 0.0f) break;
        float t, u, v;
        if (mt(r, f, r.maxt, t, u, v)) {
          occ = true;
          break;
        }
      }
    }
    __syncthreads();
  }
  out[lane] = occ ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int closest_hit_launch(const float* rays, long long Lp, const float* tri,
                                  const float* tab, int C, int B, int T,
                                  const int* order, const float* keys,
                                  const int* count, int max_visits, float* out,
                                  float* fd, void* stream) {
  if (B > kMaxFaces || Lp % kTile != 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(Lp / kTile);
  closest_hit_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      rays, Lp, tri, tab, C, B, T, order, keys, count, max_visits, out, fd);
  return (int)cudaGetLastError();
}

extern "C" int any_hit_launch(const float* rays, long long Lp, const float* tri,
                              int C, int B, const int* order, const float* keys,
                              const int* count, int max_visits, float* out,
                              void* stream) {
  if (B > kMaxFaces || Lp % kTile != 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(Lp / kTile);
  any_hit_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(
      rays, Lp, tri, C, B, order, keys, count, max_visits, out);
  return (int)cudaGetLastError();
}
