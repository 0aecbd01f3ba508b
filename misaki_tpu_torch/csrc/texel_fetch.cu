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
// add exactly nothing. It replaces nothing of the JAX package, which has no
// backward kernel (its gradient transposes the one-hot matmuls of
// misaki_tpu/core/table.py:26-58): it is the backward of the counterpart of
// misaki_tpu/render/paged_fetch.py:55. Its plain twin is
// fetch4_backward_plain in render/texel_fetch.py.
//
// What bounds it on an H100: the stream of 44 B per lane (ids, weights,
// grad_out), read once, evict-first as in the forward, and the (N, 3)
// gradient written once; the 13 launches of one envlit gradient (2^22 lanes
// each) move 1.0066 ms of those bytes at 3.35 TB/s. What costs is the
// scatter: a read-modify-write in L2 of each distinct live texel, 3.1-4.9 M
// of them a launch into the 8.4 M-texel envmap (a table four times L2), and
// reductions to one address, which serialise in L2: a frame's lanes are a
// pixel's samples in a row, so a warp's 32 lanes fetch one or two bilinear
// quads, a coarse mip texel is every lane's, and the sun's few envmap
// texels take most NEE taps.
//
// What the design does about it (`python -m
// misaki_tpu_torch.tools.profile_texel_fetch --backward --compare <source>`
// times it against another version of this source in one call; PERF.md §6
// row 5 has the numbers, NVIDIA H100 80GB HBM3 at 700 W):
//   * Within a warp, per tap k, lanes are grouped by texel id
//     (__match_any_sync) and each group's products summed in float64 by a
//     tree of shuffles (sum_peers).
//   * A persistent grid (as many blocks as fit on the card at once) gives
//     each block a contiguous range of lanes, walked in tiles of kBwdBlock,
//     and a table in shared memory of texel ids and their float64 sums
//     (linear probing over kProbes slots, a free slot claimed by CAS, sums
//     added by shared float64 atomics, which are CAS loops), kept to the end
//     of the range: a coarse mip texel or a sun texel reaches device memory
//     about once per block instead of once per warp. A seen-once filter
//     lets a texel into the table only at its block's second sighting of
//     it, so incoherent taps (env_random: each texel about once) pay a read
//     of the table and of the filter and go straight to device memory. A
//     group that finds no slot goes to device memory: no update is lost.
//   * The device-memory step is one 16-byte vector reduction
//     (REDG.E.ADD.F32x4, `atomicAdd(float4*)` of compute capability 9.x) per
//     partial into an (N, 4) float32 scratch that the caller zeroes, the
//     float64 partial rounded to float32 once: a third of the L2 atomic
//     operations of three RED.ADD.F64 and two thirds of their bytes.
//   * fetch4_backward_finalize_kernel writes the (N, 3) gradient from it:
//     no dense float64 scratch is zeroed, read and rounded (503 MB for the
//     envmap before; the (N, 4) float32 scratch's zeroing and finalize move
//     369 MB).
// Why float32 in device memory is within the twin's tolerance (allclose
// rtol 1e-5, atol 1e-6 of the largest magnitude): a texel's float32
// additions there are its partials, a float64 sum rounded once each, and
// a texel fetched again and again in a block adds once per block, not the
// ~10^5 taps of a coarse mip texel whose two float32 orders differ by
// ~5e-3 at a scale of 678. The hardest case is env_nee with random output
// gradients, whose sun texels sum thousands of lone products of both signs
// to near zero; PERF.md §6 row 5 gives the share of the tolerance it uses
// over many calls.

constexpr int kBwdBlock = 256;                 // threads of a block, lanes of a tile
constexpr int kSlotsLog2 = 10;
constexpr int kSlots = 1 << kSlotsLog2;        // slots of a block's table
constexpr int kProbes = 8;                     // slots a group tries
constexpr int kSeenLog2 = 12;
constexpr int kSeen = 1 << kSeenLog2;          // slots of a block's seen-once filter
constexpr int kEmpty = -1;                     // the key of a free slot
// in dynamic shared memory: the table's float64 sums [3][kSlots] and int
// keys [kSlots]; the filter's ids [kSeen]
constexpr size_t kTableBytes = kSlots * (3 * sizeof(double) + sizeof(int)) + kSeen * sizeof(int);

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

// The device-memory step: texel `id`'s float64 sums x[] rounded to float32
// once and added to row id of the (N, 4) float32 scratch by one 16-byte
// vector reduction (its value is unused: RED, not ATOM).
__device__ __forceinline__ void red_add(float* rows, int id, const double x[3]) {
  atomicAdd(reinterpret_cast<float4*>(rows) + id,
            make_float4((float)x[0], (float)x[1], (float)x[2], 0.0f));
}

// Adds a group's sums x[] to the slot of its id in the block's table (sums
// [3][kSlots], keys [kSlots]): linear probing from the id's hash over at
// most kProbes slots; a free slot is claimed by CAS if `claim`, else ends
// the search. Sums are added by shared-memory atomics (float64: a CAS
// loop). Returns whether it added.
__device__ __forceinline__ bool table_add(double* sum, int* key, bool claim, int id,
                                          const double x[3]) {
  unsigned i = ((unsigned)id * 2654435761u) >> (32 - kSlotsLog2);
  for (int p = 0; p < kProbes; ++p, i = (i + 1) & (kSlots - 1)) {
    int k = key[i];
    if (k == kEmpty) {
      if (!claim) return false;
      k = atomicCAS(key + i, kEmpty, id);
      if (k == kEmpty) k = id;
    }
    if (k == id) {
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(sum + c * kSlots + i, x[c]);
      return true;
    }
  }
  return false;
}

// One block per range [blockIdx.x * chunk, + chunk) of lanes, walked in
// tiles of kBwdBlock lanes, a lane per thread. A warp group's sums go to its
// texel's slot if the block's table holds it. Else a texel the seen-once
// filter (a direct-mapped array of the texel ids last seen) has not seen
// goes to device memory and the filter records it, and one seen before
// takes a slot, or goes to device memory if it finds none. A slot is kept
// to the end of the range, where the table goes to device memory: a texel
// that the block fetches again and again (a coarse mip texel, the sun's)
// adds to device memory about once per block, and a texel seen once
// (incoherent taps) costs a read of the table, one of the filter and a
// store. The filter's stores race between warps: a lost one only delays a
// texel's entry.
__global__ void __launch_bounds__(kBwdBlock)
    fetch4_backward_kernel(const int* __restrict__ idx4, const float* __restrict__ w4,
                           const float* __restrict__ grad_out, long long L, long long n,
                           long long chunk, float* __restrict__ rows) {
  extern __shared__ double sum[];  // [3][kSlots]
  int* key = reinterpret_cast<int*>(sum + 3 * kSlots);  // [kSlots]
  int* seen = key + kSlots;                              // [kSeen]
  for (int i = threadIdx.x; i < kSlots; i += kBwdBlock) {
    key[i] = kEmpty;
#pragma unroll
    for (int c = 0; c < 3; ++c) sum[c * kSlots + i] = 0.0;
  }
  for (int i = threadIdx.x; i < kSeen; i += kBwdBlock) seen[i] = kEmpty;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = min(L, begin + chunk);
  for (long long t0 = begin; t0 < end; t0 += kBwdBlock) {
    const long long l = t0 + threadIdx.x;
    const bool in = l < end;  // lanes past the end take part in the warp's votes
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
      const int gkey = live ? id[k] : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, gkey);
      double x[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = live ? (double)(w[k] * g[c]) : 0.0;
      sum_peers(peers, x);
      if (live && lane == __ffs(peers) - 1 && !table_add(sum, key, false, id[k], x)) {
        const int f = (int)(((unsigned)id[k] * 0x9E3779B1u) >> (32 - kSeenLog2));
        if (seen[f] != id[k]) {
          seen[f] = id[k];
          red_add(rows, id[k], x);
        } else if (!table_add(sum, key, true, id[k], x)) {
          red_add(rows, id[k], x);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += kBwdBlock) {
    if (key[i] != kEmpty) {
      const double x[3] = {sum[i], sum[kSlots + i], sum[2 * kSlots + i]};
      red_add(rows, key[i], x);
    }
  }
}

// The (N, 3) float32 gradient from the (N, 4) scratch, a row a thread,
// written evict-first.
__global__ void __launch_bounds__(kBlock)
    fetch4_backward_finalize_kernel(const float* __restrict__ rows, long long n,
                                    float* __restrict__ out) {
  for (long long r = (long long)blockIdx.x * kBlock + threadIdx.x; r < n;
       r += (long long)gridDim.x * kBlock) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(rows) + r);
    __stcs(out + 3 * r, v.x);
    __stcs(out + 3 * r + 1, v.y);
    __stcs(out + 3 * r + 2, v.z);
  }
}

}  // namespace

// The reduction into the (N, 4) float32 scratch `rows`, all zero, on a
// persistent grid: as many blocks as fit on the card at once with the
// table's shared memory, each on a contiguous range of whole tiles; then
// fetch4_backward_finalize_launch writes the gradient. Each returns the
// CUDA error code.
extern "C" int fetch4_backward_launch(const int* idx4, const float* w4, const float* grad_out,
                                      long long L, long long n_texels, float* rows,
                                      void* stream) {
  if (L <= 0 || n_texels <= 0 || n_texels > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fetch4_backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTableBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fetch4_backward_kernel,
                                                        kBwdBlock, kTableBytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (L + kBwdBlock - 1) / kBwdBlock;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long chunk = (tiles + slots - 1) / slots * kBwdBlock;
  const long long blocks = (L + chunk - 1) / chunk;
  fetch4_backward_kernel<<<(unsigned)blocks, kBwdBlock, kTableBytes, (cudaStream_t)stream>>>(
      idx4, w4, grad_out, L, n_texels, chunk, rows);
  return (int)cudaGetLastError();
}

extern "C" int fetch4_backward_finalize_launch(const float* rows, long long n_texels, float* out,
                                               void* stream) {
  if (n_texels <= 0) return (int)cudaErrorInvalidValue;
  const long long r = (n_texels + kBlock - 1) / kBlock;
  fetch4_backward_finalize_kernel<<<(unsigned)(r < (1LL << 16) ? r : (1LL << 16)), kBlock, 0,
                                    (cudaStream_t)stream>>>(rows, n_texels, out);
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
