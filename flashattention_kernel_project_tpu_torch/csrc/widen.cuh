// How a 32-bit word of KV-cache elements widens to f32, exactly: two bf16,
// or four int8 or e4m3 values. Shared by the decode core (which widens into
// registers) and the tiled forward core (which widens 8-bit tiles into bf16
// tensor-core operands: int8 and e4m3 values are exact in bf16 too).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace fkp {

template <class T>
struct Widen;

template <>
struct Widen<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ __forceinline__ static void word(uint32_t w, float* f) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
    f[0] = x.x;
    f[1] = x.y;
  }
};

template <>
struct Widen<int8_t> {
  static constexpr int kPerWord = 4;
  __device__ __forceinline__ static void word(uint32_t w, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = static_cast<float>(static_cast<signed char>(w >> (8 * i)));
    }
  }
};

template <>
struct Widen<__nv_fp8_e4m3> {
  static constexpr int kPerWord = 4;
  __device__ __forceinline__ static void word(uint32_t w, float* f) {
    const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3));
    const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3));
    const float2 a = __half22float2(lo);
    const float2 b = __half22float2(hi);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

}  // namespace fkp
