// What the int8 x int8 decode (flash_decode_mxu.cu, kernel 8) takes of
// the earlier CUDA-core decode body: its block of 4 warps, the raw 8- or
// 16-byte piece of a key row a thread loads, the q quantizer (JAX's
// wrapper's, before its kernel), the live key ranges of a split under a
// sliding window, and the dispatch over d and G. The 8-bit linear decode
// (kernel 7) that this header's block body served is flash_decode_sm90.cuh's
// 8-bit kernel now: its keys widen in registers into tensor-core
// fragments, and its splits merge on the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fkp_dec {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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
