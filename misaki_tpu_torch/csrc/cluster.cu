// Closest-hit and any-hit ray casts over a two-level BVH2, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of misaki_tpu/accel/cluster.py:
//   closest_hit_kernel <- _closest_kernel (called by intersect_clusters)
//   any_hit_kernel     <- _anyhit_kernel  (called by ray_test_clusters)
//
// Contract (accel/cluster.py): rays (8, Lp) rows [ox oy oz dx dy dz mint
// maxt]; padded lanes have maxt = -1 and hit nothing. nodes (N, 16) f32, one
// 64-byte node per row, four float4s: [c0 lo.x hi.x lo.y hi.y], [c1 lo.x
// hi.x lo.y hi.y], [c0 lo.z hi.z, c1 lo.z hi.z], [ref0 ref1 s -] with the
// refs as int32 bits: >= 0 an inner node, < 0 a leaf ~(start * 8 + count).
// Node 0 is the root and always an inner node, and its s is the largest
// |coordinate| of any vertex; an empty child has a +inf box, which every ray
// misses. leaf_tri (F, 12) f32, three float4s per face
// in leaf order: [p0 fid], [e1 cluster], [e2 slot], cluster and slot as
// int32 bits: the face's column of tab (C, T, B), the face rows in cluster
// order. The result is the exact lexicographic closest hit -- smallest t,
// then the largest face id -- which the plain twin computes by misaki_tpu's
// tile walk; misses give t = 3e38 (the wrapper maps it to inf), face id -1
// and an all-zero face row. Any hit returns 1 where some face is hit in
// [mint, maxt].
//
// What bounds it on an H100: bytes. Per ray the function must read 32 B of
// ray and write 16 B of hit and the winner's T = 36-float face row (144 B),
// about 0.06 ms per 2^20 rays at 3.35 TB/s (any hit: 36 B, 0.011 ms); the
// least arithmetic, one Moller-Trumbore test per hit ray, is far below that.
// The tables stay in the 50 MB L2 up to some 10^5 faces (the 20,480-face
// bunny stand-in: ~10k nodes and 20k faces, about 1.6 MB). A production mesh
// does not fit: the level-9 Sierpinski tetrahedron of the benchmark's
// cbox-sierpinski (1,048,588 faces) has 16.8 MB of nodes and 50.3 MB of
// leaf_tri, 67 MB, so its node and face reads go to HBM.
//
// Design: one thread per ray, each with its own short stack, in a
// while-while loop (Aila and Laine, "Understanding the efficiency of ray
// traversal on GPUs", HPG 2009): inner nodes until a leaf comes up, then the
// leaf's faces, then the next entry of the stack. At an inner node both
// children are slab-tested, the nearer is visited first and the other is
// pushed with its entry distance; a child or a popped entry is pruned only
// when its entry is greater than the best t, since a child at exactly that t
// can still hold a tie. An incoherent ray therefore pays for the nodes and
// faces along its own path, never for its neighbours' (the tile walk this
// replaces made every ray of a 256-ray tile scan the union of the tile's
// clusters, and all 161 clusters of a scene once a tile reached more than
// 128). Nodes and faces are read as float4 through the read-only cache; the
// walk uses no shared memory (the closest hit's counters take 32 bytes a
// block), so the carveout goes to L1, which then holds the upper levels every
// ray reads.
//
// Pruning must not drop a face that mt() accepts. mt() is not watertight:
// rounding lets it accept a ray that passes just outside a face, by up to
// about 10 * 2^-24 * |o - p0| / cos(angle to the face's normal), so an exact
// box test could still miss its face (a ray in the plane of a vertex ring,
// with a zero direction component, does). Node boxes are rounded outward to
// float32 at build time; each ray grows every box by a pad of PAD * (its
// largest |origin component| + the scene's largest |coordinate|), which
// covers that rounding for rays up to ~89 degrees off the normal; the
// slab's far distance is scaled up and its near distance down by 2^-18
// (Ize, "Robust BVH ray traversal", JCGT 2013, needs 1 + 2*gamma_3 on the
// far side); and a zero direction component takes the +-1e20 reciprocal of
// the twins' _safe_rcp, never inf, so (lo - o) * rcp is never 0 * inf.
//
// Built with -fmad=false (utils/cuda_build.py, file-wide): mt() rounds every
// product as misaki_tpu's _mt_cluster and the plain twin do, so t is
// bit-identical to both.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 64;  // the launchers refuse a tree that needs more
constexpr int kDone = -2147483647 - 1;
constexpr float kBig = 3.0e38f;
constexpr float kNearScale = 1.0f - 1.0f / 262144.0f;
constexpr float kFarScale = 1.0f + 1.0f / 262144.0f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint, maxt;
  float rx, ry, rz;  // _safe_rcp of the direction
  float pad;         // how far every box is grown for this ray
};

__device__ __forceinline__ float safe_rcp(float c) {
  return 1.0f / (fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c);
}

// `scene`: the largest |vertex coordinate|, node 0's s; `pad_scale`: the
// box growth per unit of origin and scene reach (accel/cluster.py PAD).
__device__ __forceinline__ Ray load_ray(const float* rays, long long Lp, long long lane,
                                        float scene, float pad_scale) {
  Ray r;
  r.ox = rays[0 * Lp + lane];
  r.oy = rays[1 * Lp + lane];
  r.oz = rays[2 * Lp + lane];
  r.dx = rays[3 * Lp + lane];
  r.dy = rays[4 * Lp + lane];
  r.dz = rays[5 * Lp + lane];
  r.mint = rays[6 * Lp + lane];
  r.maxt = rays[7 * Lp + lane];
  r.rx = safe_rcp(r.dx);
  r.ry = safe_rcp(r.dy);
  r.rz = safe_rcp(r.dz);
  r.pad = pad_scale * (fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz)) + scene);
  return r;
}

// Entry distance of the ray into the box grown by r.pad, or +inf when it
// misses that box or enters it beyond t_hi.
__device__ __forceinline__ float slab(const Ray& r, float lox, float hix, float loy,
                                      float hiy, float loz, float hiz, float t_hi) {
  const float x0 = (lox - r.pad - r.ox) * r.rx, x1 = (hix + r.pad - r.ox) * r.rx;
  const float y0 = (loy - r.pad - r.oy) * r.ry, y1 = (hiy + r.pad - r.oy) * r.ry;
  const float z0 = (loz - r.pad - r.oz) * r.rz, z1 = (hiz + r.pad - r.oz) * r.rz;
  const float near = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)) * kNearScale;
  const float far = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)) * kFarScale;
  const float tn = fmaxf(near, r.mint);
  return tn <= fminf(far, t_hi) ? tn : __int_as_float(0x7f800000);
}

// Moller-Trumbore, written in the operation order of misaki_tpu's
// _mt_cluster so that every rounding matches. a = [p0 .], b = [e1 .],
// c = [e2 .].
__device__ __forceinline__ bool mt(const Ray& r, const float4& a, const float4& b,
                                   const float4& c, float t_cap, float& t, float& u,
                                   float& v) {
  const float p0x = a.x, p0y = a.y, p0z = a.z;
  const float e1x = b.x, e1y = b.y, e1z = b.z;
  const float e2x = c.x, e2y = c.y, e2z = c.z;
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

struct Hit {
  float t, u, v, fid;
  int face;  // the winner's row of leaf_tri, -1 on a miss
};

// Walk the BVH2 for one ray. kAny: stop at the first accepted face, with
// t_cap = maxt; else the lexicographic closest hit. counts (nullable): nodes
// visited and faces tested.
template <bool kAny>
__device__ __forceinline__ Hit traverse(const Ray& r, const float4* __restrict__ nodes,
                                        const float4* __restrict__ leaf_tri, int& n_nodes,
                                        int& n_faces) {
  Hit h;
  h.t = kAny ? r.maxt : fminf(r.maxt, kBig);
  h.u = 0.0f;
  h.v = 0.0f;
  h.fid = -1.0f;
  h.face = -1;
  int stack[kStack];
  float stack_t[kStack];
  int sp = 0;
  const float t_hi = fminf(h.t, kBig);
  int ref = 0;
  while (ref != kDone) {
    // inner nodes, until a leaf or nothing is left
    while (ref >= 0) {
      const float4* n = nodes + 4 * (long long)ref;
      const float4 a = __ldg(n), b = __ldg(n + 1), c = __ldg(n + 2);
      const int4 l = __ldg(reinterpret_cast<const int4*>(n + 3));
      ++n_nodes;
      const float lim = kAny ? t_hi : h.t;
      const float t0 = slab(r, a.x, a.y, a.z, a.w, c.x, c.y, lim);
      const float t1 = slab(r, b.x, b.y, b.z, b.w, c.z, c.w, lim);
      const bool h0 = t0 <= lim, h1 = t1 <= lim;
      if (h0 && h1) {
        const bool first0 = t0 <= t1;
        stack[sp] = first0 ? l.y : l.x;
        stack_t[sp] = first0 ? t1 : t0;
        ++sp;
        ref = first0 ? l.x : l.y;
      } else if (h0 || h1) {
        ref = h0 ? l.x : l.y;
      } else {
        ref = kDone;
        while (sp > 0) {
          --sp;
          if (stack_t[sp] <= h.t) {
            ref = stack[sp];
            break;
          }
        }
      }
    }
    // leaves, each followed by the next live entry of the stack
    while (ref < 0 && ref != kDone) {
      const int start = (~ref) >> 3, count = (~ref) & 7;
      for (int i = start; i < start + count; ++i) {
        const float4 fa = __ldg(leaf_tri + 3 * (long long)i);
        const float4 fb = __ldg(leaf_tri + 3 * (long long)i + 1);
        const float4 fc = __ldg(leaf_tri + 3 * (long long)i + 2);
        ++n_faces;
        float t, u, v;
        if (!mt(r, fa, fb, fc, kAny ? r.maxt : h.t, t, u, v)) continue;
        if (kAny) {
          h.face = i;
          return h;
        }
        if (t < h.t || (t == h.t && fa.w > h.fid)) {
          h.t = t;
          h.u = u;
          h.v = v;
          h.fid = fa.w;
          h.face = i;
        }
      }
      ref = kDone;
      while (sp > 0) {
        --sp;
        if (stack_t[sp] <= h.t) {
          ref = stack[sp];
          break;
        }
      }
    }
  }
  return h;
}

// Adds the block's (nodes, faces) to walk[0], walk[1]: a sum over each warp
// by shuffle, over the warps in shared memory, then one atomic add a counter.
// Every thread of the block takes part.
__device__ __forceinline__ void block_add2(unsigned long long* walk, int a, int b) {
  __shared__ int part[kBlock / 32][2];
  a = __reduce_add_sync(0xffffffffu, a);
  b = __reduce_add_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) {
    part[threadIdx.x >> 5][0] = a;
    part[threadIdx.x >> 5][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sa = 0, sb = 0;
    for (int w = 0; w < kBlock / 32; ++w) {
      sa += (unsigned)part[w][0];
      sb += (unsigned)part[w][1];
    }
    if (sa > 0) atomicAdd(walk, sa);
    if (sb > 0) atomicAdd(walk + 1, sb);
  }
}

// live (nullable, the tracing counter cast.closest.live): adds the block's
// rays with maxt >= mint, one atomic add a block. It counts after the ray's
// loads, which the walk waits for anyway, so counting adds no memory latency
// in front of the block. walk (nullable, the counters cast.closest.nodes and
// cast.closest.faces, adjacent): adds the inner nodes those rays slab-test
// the children of and the faces they test, one atomic add a counter a block,
// after the walk. A null pointer skips its count, uniformly over the grid.
__global__ void __launch_bounds__(kBlock, 8)
closest_hit_kernel(const float* __restrict__ rays, long long Lp,
                   const float4* __restrict__ nodes, const float4* __restrict__ leaf_tri,
                   const float* __restrict__ tab, int T, int B, float* __restrict__ out,
                   float* __restrict__ fd, int* __restrict__ counts,
                   unsigned long long* __restrict__ live, unsigned long long* __restrict__ walk,
                   float pad_scale) {
  const long long lane = (long long)blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(rays, Lp, lane < Lp ? lane : Lp - 1, __ldg(nodes + 3).z, pad_scale);
  const bool counted = lane < Lp && r.maxt >= r.mint;
  if (live != nullptr) {  // the same for every thread of the block
    const int n = __syncthreads_count(counted);
    if (threadIdx.x == 0 && n > 0) atomicAdd(live, (unsigned long long)n);
  }
  if (lane >= Lp && walk == nullptr) return;
  int n_nodes = 0, n_faces = 0;
  Hit h = {};
  if (lane < Lp) h = traverse<false>(r, nodes, leaf_tri, n_nodes, n_faces);
  if (walk != nullptr) block_add2(walk, counted ? n_nodes : 0, counted ? n_faces : 0);
  if (lane >= Lp) return;

  const bool hit = h.face >= 0;
  out[0 * Lp + lane] = hit ? h.t : kBig;
  out[1 * Lp + lane] = h.u;
  out[2 * Lp + lane] = h.v;
  out[3 * Lp + lane] = h.fid;
  if (hit) {
    const int c = __float_as_int(__ldg(leaf_tri + 3 * (long long)h.face + 1).w);
    const int s = __float_as_int(__ldg(leaf_tri + 3 * (long long)h.face + 2).w);
    const float* row = tab + (long long)c * T * B + s;
    for (int i = 0; i < T; ++i) fd[i * Lp + lane] = __ldg(row + (long long)i * B);
  } else {
    for (int i = 0; i < T; ++i) fd[i * Lp + lane] = 0.0f;
  }
  if (counts != nullptr) {
    counts[lane] = n_nodes;
    counts[Lp + lane] = n_faces;
  }
}

__global__ void __launch_bounds__(kBlock, 8)
any_hit_kernel(const float* __restrict__ rays, long long Lp,
               const float4* __restrict__ nodes, const float4* __restrict__ leaf_tri,
               float* __restrict__ out, int* __restrict__ counts, float pad_scale) {
  const long long lane = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (lane >= Lp) return;
  const Ray r = load_ray(rays, Lp, lane, __ldg(nodes + 3).z, pad_scale);
  int n_nodes = 0, n_faces = 0;
  const Hit h = traverse<true>(r, nodes, leaf_tri, n_nodes, n_faces);
  out[lane] = h.face >= 0 ? 1.0f : 0.0f;
  if (counts != nullptr) {
    counts[lane] = n_nodes;
    counts[Lp + lane] = n_faces;
  }
}

// Next to no shared memory: give the SM's unified storage to L1.
template <typename K>
cudaError_t prefer_l1(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxL1);
}

unsigned grid_of(long long Lp) { return (unsigned)((Lp + kBlock - 1) / kBlock); }

}  // namespace

extern "C" int closest_hit_launch(const float* rays, long long Lp, const float* nodes,
                                  const float* leaf_tri, const float* tab, int T, int B,
                                  float* out, float* fd, int* counts, unsigned long long* live,
                                  unsigned long long* walk, float pad_scale, int stack_depth,
                                  void* stream) {
  static const cudaError_t carveout = prefer_l1(closest_hit_kernel);
  if (carveout != cudaSuccess) return (int)carveout;
  if (Lp <= 0 || stack_depth > kStack) return (int)cudaErrorInvalidValue;
  closest_hit_kernel<<<grid_of(Lp), kBlock, 0, (cudaStream_t)stream>>>(
      rays, Lp, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(leaf_tri), tab, T, B, out, fd, counts, live, walk,
      pad_scale);
  return (int)cudaGetLastError();
}

extern "C" int any_hit_launch(const float* rays, long long Lp, const float* nodes,
                              const float* leaf_tri, float* out, int* counts,
                              float pad_scale, int stack_depth, void* stream) {
  static const cudaError_t carveout = prefer_l1(any_hit_kernel);
  if (carveout != cudaSuccess) return (int)carveout;
  if (Lp <= 0 || stack_depth > kStack) return (int)cudaErrorInvalidValue;
  any_hit_kernel<<<grid_of(Lp), kBlock, 0, (cudaStream_t)stream>>>(
      rays, Lp, reinterpret_cast<const float4*>(nodes),
      reinterpret_cast<const float4*>(leaf_tri), out, counts, pad_scale);
  return (int)cudaGetLastError();
}
