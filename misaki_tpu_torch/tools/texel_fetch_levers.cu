// The texel-fetch kernel of csrc/texel_fetch.cu with each lever tried in its
// design switched on or off, for `tools/profile_texel_fetch_levers.py`. The
// render path never builds or launches this file: the port launches the one
// set that measured best (stream evict-first and row spans on the (N, 3)
// table) from csrc/texel_fetch.cu.
//
// Contract: that of csrc/texel_fetch.cu (out[c, l] = sum_k w4[k, l] *
// table[idx4[k, l], c], taps added in order k = 0..3, each product rounded,
// built with -fmad=false, a dead tap never read), on a texel-major float32
// RGB table of row pitch `stride` floats: 3, the scene's (N, 3) table, or 4,
// an (N, 4) copy whose fourth float is never summed. Levers (bit flags):
//   kStreamEvictFirst  idx4/w4 loaded and out stored evict-first
//                      (ld/st.global.cs);
//   kTexelEvictLast    texels loaded ld.global.nc with an L2::evict_last
//                      cache policy (the lines stay pinned in L2 after the
//                      launch, until cuCtxResetPersistingL2Cache);
//   kRowSpans          (stride 3) a bilinear row of two adjacent live texels
//                      read as two 16-byte loads (and a 4-byte one for one
//                      alignment in four); with stride 4 every tap is one
//                      16-byte load;
//   kTwoLanes          two lanes per thread, their loads issued together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

enum : int {
  kStreamEvictFirst = 1,
  kTexelEvictLast = 2,
  kRowSpans = 4,
  kTwoLanes = 8,
};

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

template <bool kEL>
__device__ __forceinline__ float ld_texel1(const float* p, uint64_t pol) {
  if constexpr (kEL) {
    float v;
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
    return v;
  } else {
    return __ldg(p);
  }
}

template <bool kEL>
__device__ __forceinline__ float4 ld_texel4(const float* p, uint64_t pol) {
  if constexpr (kEL) {
    float4 v;
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "l"(pol));
    return v;
  } else {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
}

template <bool kCS, typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
  if constexpr (kCS) {
    return __ldcs(p);
  } else {
    return *p;
  }
}

// The RGB texels of the two taps (a, b) of one bilinear row: a dead tap's
// values are 0 and its texel is not read.
template <int kStride, bool kEL, bool kSpans>
__device__ __forceinline__ void load_row(const float* __restrict__ table, long long n, int a,
                                         int b, bool live_a, bool live_b, uint64_t pol,
                                         float* va, float* vb) {
  if constexpr (kStride == 4) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 ta = live_a ? ld_texel4<kEL>(table + 4LL * a, pol) : zero;
    const float4 tb = live_b ? ld_texel4<kEL>(table + 4LL * b, pol) : zero;
    va[0] = ta.x, va[1] = ta.y, va[2] = ta.z;
    vb[0] = tb.x, vb[1] = tb.y, vb[2] = tb.z;
  } else {
    // the span's six floats [f, f + 6) inside the 16-byte-aligned window
    // [e, e + 8), plus one float for r == 3; the window stays in the table
    const long long f = 3LL * a;
    const long long e = f & ~3LL;
    const int r = (int)(f - e);
    if (kSpans && live_a && live_b && b == a + 1 && e + (r == 3 ? 9 : 8) <= 3 * n) {
      const float4 w0 = ld_texel4<kEL>(table + e, pol);
      const float4 w1 = ld_texel4<kEL>(table + e + 4, pol);
      const float w2 = r == 3 ? ld_texel1<kEL>(table + e + 8, pol) : 0.0f;
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
        va[c] = live_a ? ld_texel1<kEL>(table + f + c, pol) : 0.0f;
        vb[c] = live_b ? ld_texel1<kEL>(table + 3LL * b + c, pol) : 0.0f;
      }
    }
  }
}

template <int kStride, int kLevers>
__global__ void __launch_bounds__(kBlock)
    fetch4_lever_kernel(const float* __restrict__ table, long long n,
                        const int* __restrict__ idx4, const float* __restrict__ w4, long long L,
                        float* __restrict__ out) {
  constexpr bool kCS = (kLevers & kStreamEvictFirst) != 0;
  constexpr bool kEL = (kLevers & kTexelEvictLast) != 0;
  constexpr bool kSpans = (kLevers & kRowSpans) != 0;
  constexpr int kLanes = (kLevers & kTwoLanes) ? 2 : 1;
  const uint64_t pol = kEL ? evict_last_policy() : 0;
  const long long first = (long long)blockIdx.x * (kBlock * kLanes) + threadIdx.x;
  int id[kLanes][4];
  float w[kLanes][4];
  bool live[kLanes][4];
  // every load of every lane of the thread is issued before the first add
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const long long l = first + (long long)j * kBlock;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      id[j][k] = l < L ? ld_stream<kCS>(idx4 + k * L + l) : 0;
      w[j][k] = l < L ? ld_stream<kCS>(w4 + k * L + l) : 0.0f;
      live[j][k] = w[j][k] != 0.0f && id[j][k] >= 0 && (long long)id[j][k] < n;
    }
  }
  float v[kLanes][4][3];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    load_row<kStride, kEL, kSpans>(table, n, id[j][0], id[j][1], live[j][0], live[j][1], pol,
                                   v[j][0], v[j][1]);
    load_row<kStride, kEL, kSpans>(table, n, id[j][2], id[j][3], live[j][2], live[j][3], pol,
                                   v[j][2], v[j][3]);
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const long long l = first + (long long)j * kBlock;
    if (l >= L) continue;
    float acc[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float term = live[j][k] ? w[j][k] * v[j][k][c] : 0.0f;
        acc[c] = k == 0 ? term : acc[c] + term;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (kCS) {
        __stcs(out + c * L + l, acc[c]);
      } else {
        out[c * L + l] = acc[c];
      }
    }
  }
}

template <int kStride, int kLevers>
int launch(const float* table, long long n, const int* idx4, const float* w4, long long L,
           float* out, cudaStream_t stream) {
  const long long per_block = (long long)kBlock * ((kLevers & kTwoLanes) ? 2 : 1);
  const long long blocks = (L + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  fetch4_lever_kernel<kStride, kLevers>
      <<<(unsigned)blocks, kBlock, 0, stream>>>(table, n, idx4, w4, L, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The variants that `tools/profile_texel_fetch_levers.py` names; any other
// (stride, levers) pair is refused. The table must be 16-byte aligned.
extern "C" int fetch4_lever_launch(const float* table, long long n_texels, int stride,
                                   const int* idx4, const float* w4, long long L, float* out,
                                   int levers, void* stream) {
  if (L <= 0 || n_texels <= 0 || n_texels > 0x7FFFFFFFLL || ((uintptr_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int EF = kStreamEvictFirst, EL = kTexelEvictLast, SP = kRowSpans, TL = kTwoLanes;
  switch (stride * 16 + levers) {
    case 3 * 16: return launch<3, 0>(table, n_texels, idx4, w4, L, out, s);
    case 3 * 16 + EF: return launch<3, EF>(table, n_texels, idx4, w4, L, out, s);
    case 3 * 16 + SP: return launch<3, SP>(table, n_texels, idx4, w4, L, out, s);
    case 3 * 16 + (EF | SP): return launch<3, EF | SP>(table, n_texels, idx4, w4, L, out, s);
    case 3 * 16 + (EF | SP | EL):
      return launch<3, EF | SP | EL>(table, n_texels, idx4, w4, L, out, s);
    case 3 * 16 + (EF | SP | TL):
      return launch<3, EF | SP | TL>(table, n_texels, idx4, w4, L, out, s);
    case 4 * 16: return launch<4, 0>(table, n_texels, idx4, w4, L, out, s);
    case 4 * 16 + EF: return launch<4, EF>(table, n_texels, idx4, w4, L, out, s);
    case 4 * 16 + (EF | EL): return launch<4, EF | EL>(table, n_texels, idx4, w4, L, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
