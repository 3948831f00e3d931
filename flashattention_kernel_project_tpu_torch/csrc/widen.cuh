// How a 32-bit word of KV-cache elements widens to f32, exactly: two bf16,
// or four int8 or e4m3 values. Shared by the kernels that widen 8-bit
// tiles into bf16 tensor-core operands (int8 and e4m3 values are exact in
// bf16 too): in shared memory the paged extend and decode and the
// forward's 8-bit wgmma instances (widen16), by words (widen4: e4m3 by
// Widen, int8 by a bf16 subtraction) the 8-bit linear decode in registers
// and the 8-bit-weight wgmma GEMM into shared memory, and the 8-bit GEMM
// core.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

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

// Four int8 values widened exactly to f32 without I2F (a quarter-rate
// conversion): byte x ^ 0x80 = x + 128 placed in the mantissa of 2^23,
// then 2^23 + 128 taken off, one PRMT and one FADD a value.
__device__ __forceinline__ void widen_int8(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bytes (u.i, 0, 0, 0x4b) of (u, 0x4b): 0x4b0000.. = 2^23 + (x + 128)
    f[i] = __uint_as_float(__byte_perm(u, 0x4bu, 0x4550 | i)) - 8388736.f;
  }
}

// 16 8-bit values (int8_t or __nv_fp8_e4m3) widened exactly to bf16, as
// two 16-byte words: values 0..7 in lo, 8..15 in hi
template <class KV>
__device__ __forceinline__ void widen16(const uint4& in, uint4& lo, uint4& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&in);
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    if constexpr (std::is_same_v<KV, int8_t>) {
      widen_int8(w[i], f);
    } else {
      Widen<KV>::word(w[i], f);
    }
    __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    out[2 * i] = *reinterpret_cast<uint32_t*>(&a);
    out[2 * i + 1] = *reinterpret_cast<uint32_t*>(&b);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// Four 8-bit values (a word, value 0 in its low byte) widened exactly to
// two bf16 pairs, lo (x0, x1) and hi (x2, x3). int8: x = low7 - 128 * sign
// as the bf16 difference (128 + low7) - (128 + 128 * sign), both terms and
// the result exact (0x4300 | low7 is 128 + low7, 0x4380 is 256): one
// PRMT, two LOP3 and one HSUB2 a pair. e4m3 by Widen, then packed. The
// 8-bit linear decode widens its keys with it, the 8-bit-weight GEMM
// (gemm_w8_sm90.cu) its weights.
template <class KV>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (std::is_same_v<KV, int8_t>) {
    const auto pair = [](uint32_t t) {
      const uint32_t val = (t & 0x007f007fu) | 0x43004300u;
      const uint32_t off = (t & 0x00800080u) | 0x43004300u;
      const __nv_bfloat162 r =
          __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&val),
                  *reinterpret_cast<const __nv_bfloat162*>(&off));
      return *reinterpret_cast<const uint32_t*>(&r);
    };
    lo = pair(__byte_perm(w, 0u, 0x4140));  // bytes (x0, 0, x1, 0)
    hi = pair(__byte_perm(w, 0u, 0x4342));
  } else {
    float f[4];
    fkp::Widen<KV>::word(w, f);
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    lo = *reinterpret_cast<const uint32_t*>(&a);
    hi = *reinterpret_cast<const uint32_t*>(&b);
  }
}

}  // namespace fkp
