// The single-token GQA decode of one (batch row, KV head, split) block
// over an 8-bit linear cache (flash_decode.cu, kernel 7): where key j's K
// and V rows live is the `Rows` argument's answer (`rows.offset(j)`, in
// elements from the head's base pointers), and where its two scales live
// (`rows.scale(j)`, in floats from the head's scale base pointers). Also
// the q quantizer of kernel 8 (flash_decode_mxu.cu).
//
// The block emits the unnormalized partials (m, l, y) of the G = Hq / Hkv
// query rows of its group over its keys [start, end) (and a second range
// [start1, end1), where a sliding window leaves a split two: its sink keys
// and the start of the band); merge_partials (in ops/flash_decode.py)
// combines the splits outside the kernel.
//
// What bounds it on the H100: bytes. Each key costs 4*d bytes of K and V and
// 4*G*d flops, G flops per byte at G = 4, far below the ~295 flop/byte
// ridge, so the roof is the 3.35 TB/s of HBM and tensor cores would buy
// nothing. What matters is reading only live keys, with wide loads and
// enough loads in flight to cover device-memory latency. An 8-bit cache
// (int8 or e4m3, one f32 scale per key and head for K and one for V) halves
// the K/V bytes: 2*d + 8 a key.
//
// Design: 128 threads. A split with no live key returns after writing
// (NEG_INF, 0, 0), with no K/V loads; under a window that includes every
// split in the gap between the sinks and the band. In a live split every thread loads 16
// bytes of a key row (8 bf16 dims, or 16 8-bit dims), the threads of a key
// share it, and each group of them keeps its own online (m, l, acc) for all
// G rows over the keys it visits; the loop is unrolled so that every thread
// has 4 K and 4 V loads in flight. The groups' states are merged through
// shared memory at the end. p stays f32 in the PV product, where the JAX
// kernels cast it to the value dtype: rounding p to bf16 widens the gap
// between the bf16 model's cached-decode logits and its full forward
// (ROADMAP.md, section C), and the arithmetic here is on CUDA cores, where
// f32 costs nothing extra.
//
// 8-bit caches: the values widen exactly to f32 in registers, and the
// scales enter in the JAX kernel's order: the score is
// (q . k_int) * (sm_scale * ks[j]), and p * vs[j] enters the V sum while l
// sums p alone. At G = 8 a thread takes 8 bytes (8 dims) instead of 16, so
// its q rows and accumulators (2 * G * dims floats) stay within the 255
// registers a thread may hold.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "widen.cuh"

namespace fkp_dec {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;  // bf16 per 16-byte load

// 8 bf16 (one 16-byte load) widened to f32
__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// the raw bytes a thread loads of a key row: 4 words (16 bytes) or 2
template <int kWords>
using Raw = typename std::conditional<kWords == 4, uint4, uint2>::type;

// The group's G query rows [G, D] (bf16) quantized to int8 with one
// symmetric scale a row into q_s, one warp a row, as JAX's wrapper does in
// XLA before its kernel (flash_decode.py:485-490): s = (qmax == 0 ? 1 :
// qmax) * (1 / 127), q_s = round(q / s), qs_s = s * scale. qmax is the
// row's largest |q|; rounding is half to even (rintf), as jnp.round and
// torch.round. The caller syncs before reading q_s.
template <int D, int G>
__device__ __forceinline__ void quantize_q_rows(
    const __nv_bfloat16* __restrict__ q_g, float scale, int8_t (*q_s)[D],
    float* qs_s) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int gi = warp; gi < G; gi += kWarps) {
    float x[D / 32];
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      x[i] = __bfloat162float(q_g[gi * D + lane + 32 * i]);
      mx = fmaxf(mx, fabsf(x[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float s = (mx == 0.f ? 1.f : mx) * (1.f / 127.f);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      q_s[gi][lane + 32 * i] = static_cast<int8_t>(rintf(x[i] / s));
    }
    if (lane == 0) qs_s[gi] = s * scale;
  }
}

template <class T, int kWords>
__device__ __forceinline__ void widen(const Raw<kWords>& r, float* f) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    fkp::Widen<T>::word(w[i], f + i * fkp::Widen<T>::kPerWord);
  }
}

// The live keys of the split [start, end) of a sequence of `len` keys
// under a sliding window (window > 0): the sink keys [0, min(sinks, len))
// and the band [max(len - window, 0), len), as at most two disjoint ranges
// [s0, e0) and [s1, e1) (one where they touch; an empty range has s >= e).
// window == 0: [start, end) itself.
__device__ __forceinline__ void window_ranges(int start, int end, int len,
                                              int window, int sinks, int& s0,
                                              int& e0, int& s1, int& e1) {
  s0 = start;
  e0 = end;
  s1 = e1 = 0;
  if (window <= 0) return;
  const int sink_end = min(end, min(sinks, len));  // [start, sink_end)
  const int band_start = max(start, max(len - window, 0));  // [.., end)
  const bool has_sinks = sink_end > start;
  const bool has_band = end > band_start;
  if (has_sinks && has_band && sink_end < band_start) {  // a gap between
    e0 = sink_end;
    s1 = band_start;
    e1 = end;
  } else if (has_sinks && !has_band) {
    e0 = sink_end;
  } else if (!has_sinks) {
    s0 = band_start;  // the band, or nothing (band_start >= end)
  }
}

// q_g: the group's G query rows [G, D] bf16; k, v: the head's base pointers
// (bf16, int8 or e4m3), key j's row at rows.offset(j); for an 8-bit cache,
// k_scale, v_scale: the head's scale base pointers, key j's scales at
// rows.scale(j) (unread for bf16). Partials for keys [start, end) and
// [start1, end1) (disjoint; either may be empty) into m_p[G], l_p[G],
// y_p[G, D]. Call from every thread of a kThreads block; the bounds must
// be uniform across it. Each group has kUnroll keys' loads in flight.
template <int D, int G, class T, class Rows>
__device__ __forceinline__ void decode_partials(
    const __nv_bfloat16* __restrict__ q_g, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const Rows& rows, int start, int end,
    float sm_scale, float* __restrict__ m_p, float* __restrict__ l_p,
    float* __restrict__ y_p, int start1 = 0, int end1 = 0) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kUnroll = 4;
  constexpr int kWords = kQuant && G == 8 ? 2 : 4;  // of a key row a thread
  constexpr int kDims = kWords * fkp::Widen<T>::kPerWord;  // dims a thread holds
  constexpr int kTpk = D / kDims;                     // threads per key
  constexpr int kKeysPerWarp = 32 / kTpk;
  constexpr int kGroups = kWarps * kKeysPerWarp;  // keys per block step
  __shared__ float sh_m[kGroups][G];
  __shared__ float sh_l[kGroups][G];
  __shared__ float sh_acc[kGroups][G][D];

  if (start >= end && start1 >= end1) {  // dead split: no K/V loads
    for (int i = threadIdx.x; i < G * D; i += kThreads) y_p[i] = 0.f;
    if (threadIdx.x < G) {
      m_p[threadIdx.x] = kNegInf;
      l_p[threadIdx.x] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = warp * kKeysPerWarp + lane / kTpk;
  const int c0 = (lane % kTpk) * kDims;

  // the thread's q dims in f32
  float qv[G][kDims];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
#pragma unroll
    for (int j = 0; j < kDims; j += kVec) {
      unpack8(*reinterpret_cast<const uint4*>(q_g + gi * D + c0 + j), qv[gi] + j);
    }
  }

  float m[G], l[G], acc[G][kDims];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[gi][i] = 0.f;
  }

  // `base` and the range's end are uniform across the block, so every lane
  // runs every iteration and the shuffles below see full warps
#pragma unroll 1
  for (int range = 0; range < 2; ++range) {
    const int lo = range == 0 ? start : start1;
    const int hi = range == 0 ? end : end1;
    for (int base = lo; base < hi; base += kGroups * kUnroll) {
      Raw<kWords> kr[kUnroll], vr[kUnroll];
      float ks[kUnroll], vs[kUnroll];  // the keys' scales (8-bit caches)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int key = base + u * kGroups + grp;
        kr[u] = Raw<kWords>{};
        vr[u] = Raw<kWords>{};
        ks[u] = vs[u] = 0.f;
        if (key < hi) {
          const size_t off = rows.offset(key) + c0;
          kr[u] = *reinterpret_cast<const Raw<kWords>*>(k + off);
          vr[u] = *reinterpret_cast<const Raw<kWords>*>(v + off);
          if constexpr (kQuant) {
            const size_t so = rows.scale(key);
            ks[u] = k_scale[so];
            vs[u] = v_scale[so];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = base + u * kGroups + grp < hi;
        float kf[kDims], vf[kDims];
        widen<T, kWords>(kr[u], kf);
        widen<T, kWords>(vr[u], vf);
        // an 8-bit score is (q . k_int) * (sm_scale * ks), as in the JAX kernel
        const float s_scale = kQuant ? sm_scale * ks[u] : sm_scale;
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < kDims; ++i) dot = fmaf(qv[gi][i], kf[i], dot);
#pragma unroll
          for (int off = kTpk / 2; off > 0; off >>= 1) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          const float sv = dot * s_scale;
          if (live) {
            const float mn = fmaxf(m[gi], sv);
            const float corr = expf(m[gi] - mn);
            const float p = expf(sv - mn);
            l[gi] = l[gi] * corr + p;
            // the V scale folds into p for the V sum, not into l
            const float pv = kQuant ? p * vs[u] : p;
#pragma unroll
            for (int i = 0; i < kDims; ++i) acc[gi][i] = fmaf(pv, vf[i], acc[gi][i] * corr);
            m[gi] = mn;
          }
        }
      }
    }
  }

  // merge the groups' states; a group that saw no key holds (NEG_INF, 0, 0)
  // and weighs exp(NEG_INF - mx) == 0, since group 0 saw the first live key
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane % kTpk == 0) {
      sh_m[grp][gi] = m[gi];
      sh_l[grp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < kDims; ++i) sh_acc[grp][gi][c0 + i] = acc[gi][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int gi = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, sh_m[r][gi]);
    float y = 0.f;
    for (int r = 0; r < kGroups; ++r) y += sh_acc[r][gi][d] * expf(sh_m[r][gi] - mx);
    y_p[idx] = y;
  }
  if (threadIdx.x < G) {
    const int gi = threadIdx.x;
    float mx = kNegInf;
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, sh_m[r][gi]);
    float lt = 0.f;
    for (int r = 0; r < kGroups; ++r) lt += sh_l[r][gi] * expf(sh_m[r][gi] - mx);
    m_p[gi] = mx;
    l_p[gi] = lt;
  }
}

template <int N>
using Int = std::integral_constant<int, N>;

// launch(Int<D>{}, Int<G>{}) for d in {64, 128} and g in {1, 2, 4, 8}, then
// cudaGetLastError(); cudaErrorInvalidValue for any other d or g.
template <class Launch>
int dispatch(int d, int g, Launch&& launch) {
  auto by_g = [&](auto dc) {
    switch (g) {
      case 1: launch(dc, Int<1>{}); break;
      case 2: launch(dc, Int<2>{}); break;
      case 4: launch(dc, Int<4>{}); break;
      case 8: launch(dc, Int<8>{}); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  };
  if (d == 64) return by_g(Int<64>{});
  if (d == 128) return by_g(Int<128>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class T>
struct Type {
  using type = T;
};

// dispatch for an 8-bit cache: launch(Int<D>{}, Int<G>{}, Type<T>{}) with
// T = __nv_fp8_e4m3 if fp8, else int8_t
template <class Launch>
int dispatch_8bit(int d, int g, int fp8, Launch&& launch) {
  return dispatch(d, g, [&](auto dc, auto gc) {
    if (fp8) {
      launch(dc, gc, Type<__nv_fp8_e4m3>{});
    } else {
      launch(dc, gc, Type<int8_t>{});
    }
  });
}

}  // namespace fkp_dec
