// Photon density estimation for Hopper (sm_90a): the pair sum of the `sppm`
// and `photonmapper` integrators, over a uniform grid of the photons.
//
// Replaces misaki_tpu/render/ppm.py:282 `_density_blocks`, an XLA matmul
// rather than a Pallas kernel: per 2048-photon block it forms the (2048, L)
// pair mask and sums the flux as one (4, B) x (B, L) matrix product, which
// keeps the TPU's matrix unit busy. That dense form tests every photon
// against every visible point; almost every pair lies far outside the gather
// radius. Here the photons are binned into a grid and each visible point
// tests only the photons of the cells its radius reaches.
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
//   another order than the twin's matmuls, so they agree to rounding. Two
//   launches on the same inputs give the same bits: no step depends on the
//   order in which threads run.
//   The grid (lo, inv_h, n = (nx, ny, nz)) is the caller's, any grid with
//   inv_h > 0 and n >= 1: cell(x) = clamp(floor((x - lo) * inv_h), 0, n - 1)
//   per axis, key = (z * ny + y) * nx + x. No result depends on it; only the
//   number of pairs tested does.
//
// What bounds it: the least work any implementation must do is to read the
// bytes the function needs once and write its outputs once: every photon's
// alive flag; an alive photon's wi and n (for wi . n > 0); a photon that
// may contribute, its position and flux; every visible point's live flag; a
// live one's position, the one direction the mode tests and r2; phi and
// count. That is 4 (P + 6 alive + 7 contributing + L + 7 live + 5 L) bytes,
// 10.47 MB at cbox sppm's first depth (262,144 photons, 131,027 of them
// alive and contributing; 65,536 visible points, 36,983 live), 3.1 us at
// 3.35 TB/s; the FP32 operations of the alive photons' wi . n and of the
// passing pairs (about 1e6 of them, 20 operations each) take under 1 us at
// 67 TFLOP/s. The dense form's work (15 operations for each of the 4.8e9
// pairs of a live visible point and a photon that may contribute, 1.09 ms)
// is what this design avoids. What takes the time here (an H100 SXM at
// 700 W, cbox sppm's first depth, 0.12 ms an estimate): eleven short
// launches, each one pass over 1-2 MB or less, at about 10 us each and none
// near its own bound, and the gather's 3.1e6 candidate tests, read from L2.
//
// What the design does about it:
//   1. Keys. One thread a photon: a photon that may contribute (alive and
//      wi . n > 0) gets its cell's key and is staged at its index as three
//      float4: (p, 1), the direction the mode tests (n in sppm, wi in the
//      photonmapper), the flux. Any other photon gets the sentinel n_cells,
//      past every cell, without its position being converted (it may be inf
//      or NaN after a miss). The same kernel counts the first digit of the
//      keys in each block.
//   2. A stable LSD radix sort of (key, photon index), 8-bit digits, as many
//      passes as the sentinel needs (3 for up to 2^24 cells): per-block digit
//      counts, one exclusive scan of them in (digit, block) order (one
//      block, reading the count rows coalesced), and a scatter that ranks
//      each key within its block: in 256-key rounds a warp groups its lanes
//      by digit (__match_any_sync), each lane's rank among the earlier lanes
//      of its digit is a __popc, and the warps' counts are added in warp
//      order. Keys of one digit keep their order,
//      so within a cell the photons stay in ascending index order. Linear
//      in P however the photons crowd into cells (a caustic, a dense floor).
//      The last pass moves each staged photon to its sorted position: 48
//      contiguous bytes a photon, 6.3 MB at 131,027 photons, so the gather
//      finds them in the 50 MB L2.
//   3. offsets[c] = the first sorted position whose key is >= c, for c in
//      0..n_cells, by a binary search per cell (no atomics; independent of
//      how the photons crowd). A row of cells (z, y) along x is one span
//      [offsets[row + x0], offsets[row + x1 + 1]).
//   4. Gather: kLanes lanes a visible point. A dead visible point writes 0
//      and returns at once. A live one visits the cells of its sphere's box
//      cell(p - r') .. cell(p + r') on each axis, the rows in (z, y) order,
//      the offsets of kRows rows' spans loaded together, each lane taking
//      every kLanes-th photon of each span in stored order and applying the
//      twin's exact test (the flux read only for a pair that passes); the
//      lanes' sums are combined by a fixed butterfly of shuffles and written
//      once. 65,536 visible points of which about 37,000 are live would fill
//      about 9 of the 64 warps an SM holds with one thread each; 8 lanes give
//      8 times the warps.
//
// The margin r' = sqrt(r2) * (1 + 2^-16) + 2^-64 (each step rounded to
// float32). With u = 2^-24: if the twin passes a pair, d2 = fl(fl(dx2 + dy2)
// + dz2) < r2 with every term >= 0, and rounding is monotone, so dx2 =
// fl(dx * dx) <= d2 < r2 (likewise dy2, dz2). fl(y) >= y (1 - u) for a
// normal result and >= y - 2^-150 for a subnormal one, so dx^2 < r2 / (1 -
// u) + 2^-150 and |dx| < sqrt(r2) (1 - u)^-1/2 + 2^-75; dx = fl(x_j - x_i)
// is exact when subnormal and within a factor (1 +- u) otherwise, so |x_j -
// x_i| < (sqrt(r2) (1 - u)^-1/2 + 2^-75) / (1 - u). sqrtf rounds correctly,
// so r' >= (sqrt(r2) (1 - u)^2 (1 + 2^-16) + 2^-64)(1 - u), which exceeds
// that bound since (1 + 2^-16)(1 - u)^4.5 > 1 and 2^-64 (1 - u)^2 > 2^-75.
// So the exact sum x_i + r' >= x_j, and fl(x_i + r') >= x_j because x_j is a
// float32 and rounding is monotone; likewise fl(x_i - r') <= x_j. cell() is
// monotone in x (a subtraction of lo and a product by inv_h > 0, rounded;
// fmaxf/fminf and floorf), so the photon's cell lies in [cell(fl(x_i - r')),
// cell(fl(x_i + r'))] on each axis, whatever h is: no pair the twin passes
// lies outside the visited cells. An r2 that is NaN or <= 0 passes no pair
// and visits at most one cell; a radius larger than a cell visits more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 256;
constexpr int kItems = 4;                          // keys a thread ranks per pass
constexpr int kTile = kSortThreads * kItems;       // keys a block ranks per pass
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kWarps = kSortThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kScanParts = kScanThreads / kDigits;  // block ranges of the scan
constexpr int kBoundsThreads = 256;
constexpr int kGatherThreads = 256;
constexpr int kLanes = 8;                          // lanes a visible point
constexpr int kRows = 9;                           // rows of cells whose spans load at once
constexpr float kRelMargin = 1.0000152587890625f;  // 1 + 2^-16
constexpr float kAbsMargin = 5.42101086242752217e-20f;  // 2^-64
static_assert(kSortThreads == kDigits, "a sort thread owns one digit's counts");

struct Grid {
  float lo[3];
  float inv_h;
  int n[3];
};

__device__ __forceinline__ int cell_of(float x, float lo, float inv_h, int n) {
  const float t = (x - lo) * inv_h;
  return (int)floorf(fminf(fmaxf(t, 0.0f), (float)(n - 1)));
}

// 1. Keys of the photons, each photon that may contribute staged as three
// float4 at its index, and the block's counts of the first digit.
__global__ void __launch_bounds__(kSortThreads)
    density_keys_kernel(const float* __restrict__ ph, long long P, int sppm, Grid g,
                        unsigned sentinel, unsigned* __restrict__ keys, int* __restrict__ vals,
                        float4* __restrict__ staged, int* __restrict__ hist, int blocks) {
  __shared__ int s_count[kDigits];
  s_count[threadIdx.x] = 0;
  __syncthreads();
  for (int r = 0; r < kItems; ++r) {
    const long long j = (long long)blockIdx.x * kTile + r * kSortThreads + threadIdx.x;
    if (j >= P) break;
    const float wx = ph[3 * P + j], wy = ph[4 * P + j], wz = ph[5 * P + j];
    const float nx = ph[6 * P + j], ny = ph[7 * P + j], nz = ph[8 * P + j];
    const float wiz = wx * nx + wy * ny + wz * nz;
    unsigned key = sentinel;
    if (ph[13 * P + j] != 0.0f && wiz > 0.0f) {
      const float px = ph[j], py = ph[P + j], pz = ph[2 * P + j];
      const int cx = cell_of(px, g.lo[0], g.inv_h, g.n[0]);
      const int cy = cell_of(py, g.lo[1], g.inv_h, g.n[1]);
      const int cz = cell_of(pz, g.lo[2], g.inv_h, g.n[2]);
      key = (unsigned)((cz * g.n[1] + cy) * g.n[0] + cx);
      staged[3 * j] = make_float4(px, py, pz, 1.0f);
      staged[3 * j + 1] = sppm ? make_float4(nx, ny, nz, 0.0f) : make_float4(wx, wy, wz, 0.0f);
      staged[3 * j + 2] =
          make_float4(ph[9 * P + j], ph[10 * P + j], ph[11 * P + j], ph[12 * P + j]);
    }
    keys[j] = key;
    vals[j] = (int)j;
    atomicAdd(&s_count[key & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[blockIdx.x * kDigits + threadIdx.x] = s_count[threadIdx.x];
}

// 2a. The block's counts of the digit at `shift` (passes after the first).
__global__ void __launch_bounds__(kSortThreads)
    density_hist_kernel(const unsigned* __restrict__ keys, long long n, int shift,
                        int* __restrict__ hist, int blocks) {
  __shared__ int s_count[kDigits];
  s_count[threadIdx.x] = 0;
  __syncthreads();
  for (int r = 0; r < kItems; ++r) {
    const long long j = (long long)blockIdx.x * kTile + r * kSortThreads + threadIdx.x;
    if (j >= n) break;
    atomicAdd(&s_count[(keys[j] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[blockIdx.x * kDigits + threadIdx.x] = s_count[threadIdx.x];
}

// 2b. Exclusive scan of the counts hist[block][digit] in place, in (digit,
// block) order: each entry becomes the first sorted position of that
// block's keys of that digit. One block: thread (q, d) walks digit d's
// column over a range q of the blocks, so each step of the threads of one
// range reads one contiguous row.
__global__ void __launch_bounds__(kScanThreads)
    density_scan_kernel(int* __restrict__ hist, int blocks) {
  __shared__ int s_part[kScanParts][kDigits];
  __shared__ int s_warp[kDigits / 32];
  __shared__ int s_base[kDigits];
  const int d = threadIdx.x % kDigits, q = threadIdx.x / kDigits;
  const int lane = threadIdx.x & 31, warp = d >> 5;
  const int b0 = (int)((long long)blocks * q / kScanParts);
  const int b1 = (int)((long long)blocks * (q + 1) / kScanParts);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += hist[b * kDigits + d];
  s_part[q][d] = sum;
  __syncthreads();
  // the digits' totals, scanned over the digits (each range's warps do the
  // same; the first range's are kept)
  int total = 0;
  for (int k = 0; k < kScanParts; ++k) total += s_part[k][d];
  int x = total;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (q == 0 && lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (q == 0) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    s_base[d] = before + x - total;
  }
  __syncthreads();
  int run = s_base[d];
  for (int k = 0; k < q; ++k) run += s_part[k][d];
  for (int b = b0; b < b1; ++b) {
    const int c = hist[b * kDigits + d];
    hist[b * kDigits + d] = run;
    run += c;
  }
}

// 2c. The stable scatter of one pass. kPack (the last pass of the photons'
// sort): the sorted keys, and each photon that may contribute packed at its
// sorted position; otherwise the sorted keys and values.
template <bool kPack>
__global__ void __launch_bounds__(kSortThreads)
    density_scatter_kernel(const unsigned* __restrict__ keys_in, const int* __restrict__ vals_in,
                           long long n, int shift, const int* __restrict__ hist, int blocks,
                           unsigned* __restrict__ keys_out, int* __restrict__ vals_out,
                           const float4* __restrict__ staged, unsigned sentinel,
                           float4* __restrict__ packed) {
  __shared__ int s_base[kDigits];           // next free position of each digit
  __shared__ int s_count[kWarps][kDigits];  // this round's keys of each warp and digit
  __shared__ int s_first[kWarps][kDigits];  // their first positions
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  s_base[tid] = hist[blockIdx.x * kDigits + tid];
  for (int w = 0; w < kWarps; ++w) s_count[w][tid] = 0;
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < kItems; ++r) {
    const long long idx = (long long)blockIdx.x * kTile + r * kSortThreads + tid;
    const bool in = idx < n;
    const unsigned key = in ? keys_in[idx] : 0u;
    const int digit = in ? (int)((key >> shift) & (kDigits - 1)) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int rank = __popc(peers & below);
    if (in && rank == 0) s_count[warp][digit] = __popc(peers);
    __syncthreads();
    {  // thread tid owns digit tid: the warps' first positions, in warp order
      int run = s_base[tid];
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_count[w][tid];
        s_first[w][tid] = run;
        s_count[w][tid] = 0;
        run += c;
      }
      s_base[tid] = run;
    }
    __syncthreads();
    if (in) {
      const int dst = s_first[warp][digit] + rank;
      keys_out[dst] = key;
      if constexpr (kPack) {
        if (key < sentinel) {
          const long long j = vals_in[idx];
          packed[3 * (long long)dst] = __ldg(staged + 3 * j);
          packed[3 * (long long)dst + 1] = __ldg(staged + 3 * j + 1);
          packed[3 * (long long)dst + 2] = __ldg(staged + 3 * j + 2);
        }
      } else {
        vals_out[dst] = vals_in[idx];
      }
    }
  }
}

// 3. offsets[c]: the first sorted position whose key is >= c.
__global__ void __launch_bounds__(kBoundsThreads)
    density_bounds_kernel(const unsigned* __restrict__ keys, long long n, int n_cells,
                          int* __restrict__ offsets) {
  const long long c = (long long)blockIdx.x * kBoundsThreads + threadIdx.x;
  if (c > n_cells) return;
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < (unsigned)c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  offsets[c] = (int)lo;
}

// 4. The gather: G lanes a visible point.
template <int G>
__global__ void __launch_bounds__(kGatherThreads)
    density_gather_kernel(const float4* __restrict__ packed, const int* __restrict__ offsets,
                          Grid g, const float* __restrict__ vp, long long L, int sppm,
                          float* __restrict__ phi, float* __restrict__ count,
                          unsigned long long* __restrict__ tests) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G divides a warp");
  const long long i = ((long long)blockIdx.x * kGatherThreads + threadIdx.x) / G;
  const int sub = threadIdx.x & (G - 1);
  if (i >= L) return;
  if (vp[10 * L + i] == 0.0f) {
    if (sub == 0) {
      phi[i] = 0.0f;
      phi[L + i] = 0.0f;
      phi[2 * L + i] = 0.0f;
      phi[3 * L + i] = 0.0f;
      count[i] = 0.0f;
    }
    return;
  }
  const float px = vp[i], py = vp[L + i], pz = vp[2 * L + i];
  const long long d = sppm ? 3 : 6;  // wi in sppm, n in the photonmapper
  const float ax = vp[d * L + i], ay = vp[(d + 1) * L + i], az = vp[(d + 2) * L + i];
  const float r2 = vp[9 * L + i];
  const float rr = sqrtf(r2) * kRelMargin + kAbsMargin;
  const int x0 = cell_of(px - rr, g.lo[0], g.inv_h, g.n[0]);
  const int x1 = cell_of(px + rr, g.lo[0], g.inv_h, g.n[0]);
  const int y0 = cell_of(py - rr, g.lo[1], g.inv_h, g.n[1]);
  const int y1 = cell_of(py + rr, g.lo[1], g.inv_h, g.n[1]);
  const int z0 = cell_of(pz - rr, g.lo[2], g.inv_h, g.n[2]);
  const int z1 = cell_of(pz + rr, g.lo[2], g.inv_h, g.n[2]);
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f, c = 0.0f;
  unsigned long long n_tests = 0;
  // the rows (z, y) of the box in that order, kRows at a time: their spans'
  // offsets are loaded together, then walked
  const int span_y = y1 - y0 + 1, n_rows = (z1 - z0 + 1) * span_y;
  for (int r0 = 0; r0 < n_rows; r0 += kRows) {
    int s[kRows], e[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      s[k] = e[k] = 0;
      if (r0 + k < n_rows) {
        const int z = z0 + (r0 + k) / span_y, y = y0 + (r0 + k) % span_y;
        const int row = (z * g.n[1] + y) * g.n[0];
        s[k] = __ldg(offsets + row + x0);
        e[k] = __ldg(offsets + row + x1 + 1);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      n_tests += (unsigned long long)(e[r] - s[r]);
      for (int k = s[r] + sub; k < e[r]; k += G) {
        const float4 q = __ldg(packed + 3 * (long long)k);
        const float dx = q.x - px;
        const float dy = q.y - py;
        const float dz = q.z - pz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float4 w = __ldg(packed + 3 * (long long)k + 1);
        const float cosw = w.x * ax + w.y * ay + w.z * az;
        if (d2 < r2 && cosw > 0.0f) {
          const float4 fl = __ldg(packed + 3 * (long long)k + 2);
          f0 += fl.x;
          f1 += fl.y;
          f2 += fl.z;
          f3 += fl.w;
          c += 1.0f;
        }
      }
    }
  }
  if constexpr (G > 1) {
    // the group's lanes, combined by a fixed butterfly: the same order on
    // every launch
    const unsigned mask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
    for (int o = G / 2; o > 0; o >>= 1) {
      f0 += __shfl_xor_sync(mask, f0, o);
      f1 += __shfl_xor_sync(mask, f1, o);
      f2 += __shfl_xor_sync(mask, f2, o);
      f3 += __shfl_xor_sync(mask, f3, o);
      c += __shfl_xor_sync(mask, c, o);
    }
  }
  if (sub == 0) {
    phi[i] = f0;
    phi[L + i] = f1;
    phi[2 * L + i] = f2;
    phi[3 * L + i] = f3;
    count[i] = c;
    if (tests) atomicAdd(tests, n_tests);
  }
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// The workspace of one estimate: byte offsets of its buffers.
struct Plan {
  long long P;
  int n_cells, passes, blocks;
  size_t packed, staged, keys[2], vals[2], hist, offsets, bytes;
};

Plan make_plan(long long P, int n_cells) {
  Plan p{};
  p.P = P;
  p.n_cells = n_cells;
  int bits = 1;
  while ((1LL << bits) <= n_cells) ++bits;  // keys 0..n_cells, the sentinel n_cells
  p.passes = (bits + kDigitBits - 1) / kDigitBits;
  p.blocks = (int)((P + kTile - 1) / kTile);
  size_t at = 0;
  p.packed = at;
  at = align_up(at + 48 * (size_t)P);
  p.staged = at;
  at = align_up(at + 48 * (size_t)P);
  for (int b = 0; b < 2; ++b) {
    p.keys[b] = at;
    at = align_up(at + 4 * (size_t)P);
    p.vals[b] = at;
    at = align_up(at + 4 * (size_t)P);
  }
  p.hist = at;
  at = align_up(at + 4 * (size_t)kDigits * (size_t)(p.blocks > 0 ? p.blocks : 1));
  p.offsets = at;
  at = align_up(at + 4 * ((size_t)n_cells + 1));
  p.bytes = at;
  return p;
}

template <typename T>
T* at(void* work, size_t offset) {
  return reinterpret_cast<T*>(static_cast<char*>(work) + offset);
}

#define DENSITY_LAUNCHED()                      \
  do {                                          \
    ++*launches;                                \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

// The passes after the keys: per pass the block counts (but the first's),
// their scan and the stable scatter; the last pass packs the photons. Then
// the offsets of every cell.
cudaError_t enqueue_sort(const Plan& p, void* work, cudaStream_t st, int* launches) {
  const unsigned sentinel = (unsigned)p.n_cells;
  int* hist = at<int>(work, p.hist);
  int src = 0;
  for (int pass = 0; pass < p.passes && p.P > 0; ++pass) {
    const int shift = pass * kDigitBits;
    const unsigned* keys_in = at<unsigned>(work, p.keys[src]);
    const int* vals_in = at<int>(work, p.vals[src]);
    unsigned* keys_out = at<unsigned>(work, p.keys[1 - src]);
    int* vals_out = at<int>(work, p.vals[1 - src]);
    if (pass > 0) {
      density_hist_kernel<<<p.blocks, kSortThreads, 0, st>>>(keys_in, p.P, shift, hist, p.blocks);
      DENSITY_LAUNCHED();
    }
    density_scan_kernel<<<1, kScanThreads, 0, st>>>(hist, p.blocks);
    DENSITY_LAUNCHED();
    if (pass == p.passes - 1) {
      density_scatter_kernel<true><<<p.blocks, kSortThreads, 0, st>>>(
          keys_in, vals_in, p.P, shift, hist, p.blocks, keys_out, nullptr,
          at<float4>(work, p.staged), sentinel, at<float4>(work, p.packed));
    } else {
      density_scatter_kernel<false><<<p.blocks, kSortThreads, 0, st>>>(
          keys_in, vals_in, p.P, shift, hist, p.blocks, keys_out, vals_out, nullptr, sentinel,
          nullptr);
    }
    DENSITY_LAUNCHED();
    src = 1 - src;
  }
  const long long cells = (long long)p.n_cells + 1;
  density_bounds_kernel<<<(unsigned)((cells + kBoundsThreads - 1) / kBoundsThreads),
                          kBoundsThreads, 0, st>>>(at<unsigned>(work, p.keys[src]), p.P,
                                                   p.n_cells, at<int>(work, p.offsets));
  DENSITY_LAUNCHED();
  return cudaSuccess;
}

// Keys, sort, offsets: the photons binned into the workspace.
cudaError_t enqueue_binning(const Plan& p, const float* ph, int sppm, const Grid& g, void* work,
                            cudaStream_t st, int* launches) {
  if (p.P > 0) {
    density_keys_kernel<<<p.blocks, kSortThreads, 0, st>>>(
        ph, p.P, sppm, g, (unsigned)p.n_cells, at<unsigned>(work, p.keys[0]),
        at<int>(work, p.vals[0]), at<float4>(work, p.staged), at<int>(work, p.hist), p.blocks);
    DENSITY_LAUNCHED();
  }
  return enqueue_sort(p, work, st, launches);
}

template <int G>
cudaError_t enqueue_gather(const Plan& p, const Grid& g, const float* vp, long long L, int sppm,
                           void* work, float* phi, float* count, unsigned long long* tests,
                           cudaStream_t st, int* launches) {
  const long long threads = L * G;
  const long long blocks = (threads + kGatherThreads - 1) / kGatherThreads;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  density_gather_kernel<G><<<(unsigned)blocks, kGatherThreads, 0, st>>>(
      at<float4>(work, p.packed), at<int>(work, p.offsets), g, vp, L, sppm, phi, count, tests);
  DENSITY_LAUNCHED();
  return cudaSuccess;
}

// The arguments every launcher checks; returns the grid, or false.
bool make_grid(long long P, long long L, float lo_x, float lo_y, float lo_z, float inv_h, int nx,
               int ny, int nz, Grid* g) {
  if (L <= 0 || P < 0 || P > 0x7FFFFFFFLL - kTile || nx < 1 || ny < 1 || nz < 1 ||
      !(inv_h > 0.0f) || (long long)nx * ny * nz >= (1LL << 30))
    return false;
  *g = Grid{{lo_x, lo_y, lo_z}, inv_h, {nx, ny, nz}};
  return true;
}

}  // namespace

extern "C" long long density_workspace_bytes(long long P, long long n_cells) {
  if (P < 0 || n_cells < 1 || n_cells >= (1LL << 30)) return -1;
  return (long long)make_plan(P, (int)n_cells).bytes;
}

// One estimate: `launches` receives the number of kernels enqueued, `tests`
// (may be null) the number of (visible point, photon) pairs tested.
extern "C" int density_launch(const float* ph, long long P, const float* vp, long long L, int sppm,
                              float lo_x, float lo_y, float lo_z, float inv_h, int nx, int ny,
                              int nz, void* work, long long work_bytes, float* phi, float* count,
                              unsigned long long* tests, int* launches, void* stream) {
  Grid g;
  *launches = 0;
  if (!make_grid(P, L, lo_x, lo_y, lo_z, inv_h, nx, ny, nz, &g)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(P, nx * ny * nz);
  if (work_bytes < (long long)p.bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = enqueue_binning(p, ph, sppm, g, work, st, launches);
  if (err != cudaSuccess) return (int)err;
  err = enqueue_gather<kLanes>(p, g, vp, L, sppm, work, phi, count, tests, st, launches);
  return (int)err;
}
