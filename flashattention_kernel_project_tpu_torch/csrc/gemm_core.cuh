// The mma.sync tiled GEMM shared by gemm.cu's gemm_kernel (C = A @ B over
// an optional leading batch, with an optional ReLU(. + bias) + residual
// epilogue: the calls with shapes that are not aligned or K = 0; an
// aligned call, with or without the epilogue, takes a wgmma kernel
// instead, gemm_sm90.cuh for bf16 operands and gemm_f32_sm90.cuh for f32),
// gemm_softmax.cu (the batched product with the row softmax in its
// epilogue: the calls its wgmma kernel does not take) and gemm_w8.cu (bf16
// A times 8-bit B, a per-column scale in the epilogue: the calls
// gemm_w8_sm90.cu does not take); gemm_sm90.cuh reads Out and store2 from
// here. A [M, K] and B
// [K, N] are row-major, as the TPU kernels take them; a block computes one
// 128 x 128 tile of C with 256 threads (8 warps).
//
// bf16 (the reference's cp.async double-buffered and tensor-core rungs):
// 32-deep slices of A and B go to shared memory by cp.async, two stages, so
// the copy of slice t + 1 runs under the products of slice t. Each warp owns
// a 64 x 32 piece of the tile: 4 x 4 mma.sync m16n8k16 bf16 -> f32 products
// a 16-deep step, A fragments by ldmatrix, B fragments by ldmatrix.trans
// from the [k][n] slice. Rows are padded by 8 bf16 so the ldmatrix rows of a
// warp fall on distinct banks. An 8-bit B (int8 or e4m3; gemm_w8.cu, whose
// calls are all unaligned, so element by element) is copied into a byte
// staging slice and widened, exactly, into the bf16 B stage once it has
// landed; from there the bf16 path runs unchanged.
//
// float32 (the reference's shared-memory tiled rung; the unaligned f32
// calls, with or without the epilogue): full float32 FFMA, not TF32, which
// keeps about three decimal digits where the TPU kernel runs float32 at
// Precision.HIGHEST. Each thread computes an 8 x 8 register tile
// (two 4-row by two 4-column quarters, so its shared-memory reads are 16
// bytes wide and conflict-free); A's 8-deep slice is stored transposed,
// [k][m]. The next slice is read into registers while the current one is
// multiplied, then stored to the other of two shared-memory stages.
//
// Ragged shapes: kAligned instances need K and N to be multiples of 16
// bytes' worth of elements and 16-byte aligned bases; their 16-byte pieces
// lie wholly inside or wholly outside the matrix, and those outside are
// zero-filled. The other instances read element by element with a bound on
// each, so any M, N, K runs without padding copies.
//
// What bounds it on the H100: at the ladder's shapes (M = N = K >= 1024) a
// GEMM does 2*M*N*K operations against 2*(M*K + K*N) + M*N*4 bytes, far
// above the ridge, so the rate of tensor-core (bf16) or FFMA (float32)
// instructions bounds it: 989 TFLOP/s bf16, 67 TFLOP/s float32 FFMA.
// mma.sync reaches only part of the bf16 peak (23% at 4096^3); wgmma, TMA,
// a deeper ring and a persistent schedule are gemm_sm90.cuh's and
// gemm_f32_sm90.cuh's, for gemm.cu's aligned calls with or without the
// fused epilogue (and their siblings' for the aligned softmax-epilogue and
// 8-bit-weight calls): the unaligned calls and K = 0 still run this core.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "widen.cuh"

namespace fkp_gemm_core {

using fkp_mma::cp_async_16;
using fkp_mma::load_a;
using fkp_mma::load_b_kn;
using fkp_mma::mma_16816;

constexpr int kBM = 128;  // rows of C per block
constexpr int kBN = 128;  // columns of C per block
constexpr int kThreads = 256;

// bf16: 32-deep slices, rows padded by 8 bf16 (80 and 272 bytes)
constexpr int kBK16 = 32;
constexpr int kStrideA16 = kBK16 + 8;
constexpr int kStrideB16 = kBN + 8;
struct __align__(16) SmemBf16 {
  __nv_bfloat16 a[2][kBM * kStrideA16];  // [m][k]
  __nv_bfloat16 b[2][kBK16 * kStrideB16];  // [k][n]
};

// an 8-bit B slice as it lies in device memory, [k][n], before widening
struct __align__(16) Stage8 {
  uint8_t b[2][kBK16 * kBN];
};

// float32: 8-deep slices, rows padded by 4 floats
constexpr int kBK32 = 8;
constexpr int kStride32 = kBM + 4;
struct __align__(16) SmemF32 {
  float a[2][kBK32 * kStride32];  // [k][m]: A transposed
  float b[2][kBK32 * kStride32];  // [k][n]
};

// What the epilogue does to the f32 accumulator before the single store:
// nothing; ReLU(. + bias[col]) + residual[row, col] (gemm.cu); or times
// row_scale[row] (where given), then times col_scale[col] (the 8-bit GEMMs'
// dequantization, in the TPU kernels' order).
enum Epi : int { kPlain = 0, kBiasRelu = 1, kScale = 2 };

// Where and how a block writes C. bias and residual (f32, [N] and [M, N])
// are read only by the kBiasRelu instances, row_scale and col_scale (f32,
// [M] and [N]) only by the kScale ones.
struct Out {
  void* c;
  const float* bias;
  const float* residual;
  int m, n;
  int bf16;  // C is bf16, else f32
  const float* row_scale;
  const float* col_scale;
};

// A bf16 slice: the [kBM x kBK16] block of A at (row0, k0) and the
// [kBK16 x kBN] block of B at (k0, col0) into stage `st` (an 8-bit B into
// the staging slice `b8`), zero outside [m) x [k) and [k) x [n).
template <bool kAligned, class TB>
__device__ __forceinline__ void load_slice_bf16(SmemBf16& s, Stage8* b8, int st,
                                                const __nv_bfloat16* a,
                                                const TB* b, int row0,
                                                int col0, int k0, int m, int n,
                                                int k) {
  constexpr int kPiecesA = kBK16 / 8;
  for (int i = threadIdx.x; i < kBM * kPiecesA; i += kThreads) {
    const int r = i / kPiecesA, c = (i % kPiecesA) * 8;
    const int gr = row0 + r, gc = k0 + c;
    __nv_bfloat16* dst = &s.a[st][r * kStrideA16 + c];
    if constexpr (kAligned) {
      const bool live = gr < m && gc < k;
      cp_async_16(dst, live ? a + (size_t)gr * k + gc : a, live);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dst[j] = gr < m && gc + j < k ? a[(size_t)gr * k + gc + j]
                                      : __float2bfloat16(0.f);
      }
    }
  }
  // 16-byte pieces of B: 8 bf16 or 16 8-bit values
  constexpr int kPer = 16 / sizeof(TB), kPiecesB = kBN / kPer;
  for (int i = threadIdx.x; i < kBK16 * kPiecesB; i += kThreads) {
    const int r = i / kPiecesB, c = (i % kPiecesB) * kPer;
    const int gr = k0 + r, gc = col0 + c;
    TB* dst;
    if constexpr (sizeof(TB) == 1) {
      dst = reinterpret_cast<TB*>(&b8->b[st][r * kBN + c]);
    } else {
      dst = &s.b[st][r * kStrideB16 + c];
    }
    if constexpr (kAligned) {
      const bool live = gr < k && gc < n;
      cp_async_16(dst, live ? b + (size_t)gr * n + gc : b, live);
    } else {  // element by element, as raw bits (zero is all-zero bits)
      using Bits = std::conditional_t<sizeof(TB) == 2, uint16_t, uint8_t>;
      const Bits* src = reinterpret_cast<const Bits*>(b);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        reinterpret_cast<Bits*>(dst)[j] =
            gr < k && gc + j < n ? src[(size_t)gr * n + gc + j] : Bits{0};
      }
    }
  }
}

// The 8-bit B slice of stage `st` widened into the bf16 B stage: 16 values
// a thread, exact (int8 and e4m3 values are bf16 values).
template <class TB>
__device__ __forceinline__ void widen_slice(SmemBf16& s, const Stage8& b8, int st) {
  constexpr int kPieces = kBN / 16;
  for (int i = threadIdx.x; i < kBK16 * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(&b8.b[st][r * kBN + c]);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(&w);
    uint32_t out[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
      fkp::Widen<TB>::word(words[j], f);
      out[2 * j] = fkp_mma::pack_bf16(f[0], f[1]);
      out[2 * j + 1] = fkp_mma::pack_bf16(f[2], f[3]);
    }
    uint4* dst = reinterpret_cast<uint4*>(&s.b[st][r * kStrideB16 + c]);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// acc = the 128 x 128 tile of A @ B at (row0, col0), bf16 -> f32. Warp w
// holds rows (w / 4) * 64 + i * 16 + {g, g + 8} and columns (w % 4) * 32 +
// j * 8 + {2t, 2t + 1} in acc[i][j] (mma.cuh's C layout). B is bf16, or
// int8_t or __nv_fp8_e4m3 with `b8` its staging slices (unread for bf16).
// Every thread of the block calls it; it ends with shared memory free for
// the next call.
template <bool kAligned, class TB = __nv_bfloat16>
__device__ __forceinline__ void tile_bf16(float (&acc)[4][4][4], SmemBf16& s,
                                          const __nv_bfloat16* a, const TB* b,
                                          int row0, int col0, int m, int n,
                                          int k, Stage8* b8 = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int n_k = (k + kBK16 - 1) / kBK16;
  load_slice_bf16<kAligned>(s, b8, 0, a, b, row0, col0, 0, m, n, k);
  fkp_mma::cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    if (t + 1 < n_k) {
      load_slice_bf16<kAligned>(s, b8, (t + 1) & 1, a, b, row0, col0,
                                (t + 1) * kBK16, m, n, k);
    }
    fkp_mma::cp_async_commit();  // an empty group on the last slice
    fkp_mma::cp_async_wait<1>();  // slice t has landed, t + 1 may be in flight
    __syncthreads();
    if constexpr (sizeof(TB) == 1) {
      // B stage t & 1 was last read at t - 2, staging slice t & 1 is
      // refilled only at t + 1: both behind a barrier
      widen_slice<TB>(s, *b8, t & 1);
      __syncthreads();
    }
    const __nv_bfloat16* sa = s.a[t & 1];
    const __nv_bfloat16* sb = s.b[t & 1];
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a(af[i], sa, kStrideA16, wm + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) load_b_kn(bf[j], sb, kStrideB16, kk, wn + j * 16, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_16816(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          mma_16816(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
      }
    }
    __syncthreads();  // stage t & 1 is refilled at t + 1
  }
}

// 4 consecutive floats of row `row` of a [rows, cols] matrix (leading
// dimension ld) from column col, zero outside it.
template <bool kAligned>
__device__ __forceinline__ float4 load4(const float* p, int row, int col,
                                        int rows, int cols, int ld) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* q = p + (size_t)row * ld + col;
  if constexpr (kAligned) {
    if (col < cols) v = *reinterpret_cast<const float4*>(q);
  } else {
    if (col < cols) v.x = q[0];
    if (col + 1 < cols) v.y = q[1];
    if (col + 2 < cols) v.z = q[2];
    if (col + 3 < cols) v.w = q[3];
  }
  return v;
}

// acc = the 128 x 128 tile of A @ B at (row0, col0) in float32. Thread
// (ty, tx) = (tid / 16, tid % 16) holds rows ty*4 + r (r < 4) and 64 + ty*4 +
// r - 4 (r >= 4) and columns likewise from tx*4, in acc[r][c].
template <bool kAligned>
__device__ __forceinline__ void tile_f32(float (&acc)[8][8], SmemF32& s,
                                         const float* a, const float* b,
                                         int row0, int col0, int m, int n,
                                         int k) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // the pieces this thread copies: A row tid / 2, depth (tid % 2) * 4; B
  // depth tid / 32, columns (tid % 32) * 4
  const int ar = tid / 2, ak = (tid % 2) * 4, br = tid / 32, bc = (tid % 32) * 4;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  const int n_k = (k + kBK32 - 1) / kBK32;
  float4 ra = load4<kAligned>(a, row0 + ar, ak, m, k, k);
  float4 rb = load4<kAligned>(b, br, col0 + bc, k, n, n);
  auto store = [&](int st) {
    float* sa = s.a[st];
    sa[(ak + 0) * kStride32 + ar] = ra.x;
    sa[(ak + 1) * kStride32 + ar] = ra.y;
    sa[(ak + 2) * kStride32 + ar] = ra.z;
    sa[(ak + 3) * kStride32 + ar] = ra.w;
    *reinterpret_cast<float4*>(&s.b[st][br * kStride32 + bc]) = rb;
  };
  store(0);
  __syncthreads();
  for (int t = 0; t < n_k; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_k) {
      const int k0 = (t + 1) * kBK32;
      ra = load4<kAligned>(a, row0 + ar, k0 + ak, m, k, k);
      rb = load4<kAligned>(b, k0 + br, col0 + bc, k, n, n);
    }
    const float* sa = s.a[cur];
    const float* sb = s.b[cur];
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * kStride32 + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * kStride32 + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * kStride32 + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * kStride32 + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (t + 1 < n_k) store(cur ^ 1);  // read at t - 1, which ended in a barrier
    __syncthreads();
  }
}

// C[row, col..col+1] (offset `base` elements into C) = v0, v1, past the
// epilogue kEpi; columns past n and rows past m are not written.
template <int kEpi>
__device__ __forceinline__ void store2(const Out& o, size_t base, int row,
                                       int col, float v0, float v1) {
  if (row >= o.m || col >= o.n) return;
  const bool two = col + 1 < o.n;
  if constexpr (kEpi == kBiasRelu) {
    const float* res = o.residual + (size_t)row * o.n + col;
    v0 = fmaxf(v0 + o.bias[col], 0.f) + res[0];
    if (two) v1 = fmaxf(v1 + o.bias[col + 1], 0.f) + res[1];
  } else if constexpr (kEpi == kScale) {
    if (o.row_scale != nullptr) {
      v0 = __fmul_rn(v0, o.row_scale[row]);
      v1 = __fmul_rn(v1, o.row_scale[row]);
    }
    v0 = __fmul_rn(v0, o.col_scale[col]);
    if (two) v1 = __fmul_rn(v1, o.col_scale[col + 1]);
  }
  const size_t idx = base + (size_t)row * o.n + col;
  if (o.bf16) {
    __nv_bfloat16* c = static_cast<__nv_bfloat16*>(o.c) + idx;
    if (two && idx % 2 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(v0, v1);
    } else {
      c[0] = __float2bfloat16(v0);
      if (two) c[1] = __float2bfloat16(v1);
    }
  } else {
    float* c = static_cast<float*>(o.c) + idx;
    if (two && idx % 2 == 0) {
      *reinterpret_cast<float2*>(c) = make_float2(v0, v1);
    } else {
      c[0] = v0;
      if (two) c[1] = v1;
    }
  }
}

}  // namespace fkp_gemm_core
