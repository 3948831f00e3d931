// The single-token GQA decode of one (batch row, KV head, split) block,
// shared by flash_decode.cu (a linear cache) and paged_decode.cu (a page
// pool): the two differ only in where key j's K and V rows live, which the
// `Rows` argument answers (`rows.offset(j)`, in elements from the head's
// base pointers).
//
// The block emits the unnormalized partials (m, l, y) of the G = Hq / Hkv
// query rows of its group over its keys [start, end); merge_partials (in
// ops/flash_decode.py) combines the splits outside the kernel.
//
// What bounds it on the H100: bytes. Each key costs 4*d bytes of K and V and
// 4*G*d flops, G flops per byte at G = 4, far below the ~295 flop/byte
// ridge, so the roof is the 3.35 TB/s of HBM and tensor cores would buy
// nothing. What matters is reading only live keys, with wide loads and
// enough loads in flight to cover device-memory latency.
//
// Design: 128 threads. A split with no live key returns after writing
// (NEG_INF, 0, 0), with no K/V loads. In a live split every thread loads 16
// bytes (8 dims) of a key row, d/8 threads share a key, and each group of
// d/8 threads keeps its own online (m, l, acc) for all G rows over the keys
// it visits; the loop is unrolled so that every thread has 4 K and 4 V loads
// in flight. The groups' states are merged through shared memory at the end.
// p stays f32 in the PV product, where the JAX kernels cast it to the value
// dtype: rounding p to bf16 widens the gap between the bf16 model's
// cached-decode logits and its full forward (ROADMAP.md, section C), and the
// arithmetic here is on CUDA cores, where f32 costs nothing extra.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fkp_dec {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;     // bf16 per 16-byte load
constexpr int kUnroll = 4;  // keys per group in flight

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// q_g: the group's G query rows [G, D]; k, v: the head's base pointers, key
// j's row at rows.offset(j); partials for keys [start, end) into m_p[G],
// l_p[G], y_p[G, D]. Call from every thread of a kThreads block; `start` and
// `end` must be uniform across it.
template <int D, int G, class Rows>
__device__ __forceinline__ void decode_partials(
    const __nv_bfloat16* __restrict__ q_g, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows& rows, int start, int end,
    float sm_scale, float* __restrict__ m_p, float* __restrict__ l_p,
    float* __restrict__ y_p) {
  constexpr int kTpk = D / kVec;             // threads per key
  constexpr int kKeysPerWarp = 32 / kTpk;
  constexpr int kGroups = kWarps * kKeysPerWarp;  // keys per block step
  __shared__ float sh_m[kGroups][G];
  __shared__ float sh_l[kGroups][G];
  __shared__ float sh_acc[kGroups][G][D];

  if (start >= end) {  // dead split: no K/V loads
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
  const int c0 = (lane % kTpk) * kVec;

  float qv[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    unpack8(*reinterpret_cast<const uint4*>(q_g + gi * D + c0), qv[gi]);
  }

  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[gi][i] = 0.f;
  }

  // `base` and `end` are uniform across the block, so every lane runs every
  // iteration and the shuffles below see full warps
  for (int base = start; base < end; base += kGroups * kUnroll) {
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = base + u * kGroups + grp;
      kr[u] = make_uint4(0u, 0u, 0u, 0u);
      vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (key < end) {
        const size_t off = rows.offset(key) + c0;
        kr[u] = *reinterpret_cast<const uint4*>(k + off);
        vr[u] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + u * kGroups + grp < end;
      float kf[kVec], vf[kVec];
      unpack8(kr[u], kf);
      unpack8(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dot = fmaf(qv[gi][i], kf[i], dot);
#pragma unroll
        for (int off = kTpk / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        if (live) {
          const float sv = dot * sm_scale;
          const float mn = fmaxf(m[gi], sv);
          const float corr = expf(m[gi] - mn);
          const float p = expf(sv - mn);
          l[gi] = l[gi] * corr + p;
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[gi][i] = fmaf(p, vf[i], acc[gi][i] * corr);
          m[gi] = mn;
        }
      }
    }
  }

  // merge the groups' states; a group that saw no key holds (NEG_INF, 0, 0)
  // and weighs exp(NEG_INF - mx) == 0, since group 0 saw key `start`
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane % kTpk == 0) {
      sh_m[grp][gi] = m[gi];
      sh_l[grp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sh_acc[grp][gi][c0 + i] = acc[gi][i];
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

}  // namespace fkp_dec
