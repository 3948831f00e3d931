// Tile helpers shared by the two backward kernels (flash_bwd_dkdv.cu,
// flash_bwd_dq.cu): mma.sync m16n8k16 bf16 -> f32, ldmatrix fragment loads
// from padded shared-memory tiles, and bf16 packing.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// so the accumulators of two neighbouring n-tiles are, packed to bf16, the
// A fragment of one 16-wide k-tile: the register repack every product
// chain of the backward uses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fkp_bwd {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in ops/softmax.py
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A fragment of the 16 x 16 block at (row0, col0) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s,
                                       int stride, int row0, int col0, int lane) {
  ldsm_x4(a, s + (row0 + (lane % 16)) * stride + col0 + (lane / 16) * 8);
}

// B fragments of two n-tiles (n0..n0+7 in b[0..1], n0+8..n0+15 in b[2..3])
// over k0..k0+15, from a tile stored [n][k] (B = tile^T).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* s,
                                          int stride, int n0, int k0, int lane) {
  ldsm_x4(b, s + (n0 + (lane % 8) + (lane / 16) * 8) * stride + k0 +
                 ((lane / 8) % 2) * 8);
}

// The same two n-tiles from a tile stored [k][n] (B = tile), transposed
// on the way in.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* s,
                                          int stride, int k0, int n0, int lane) {
  ldsm_x4_t(b, s + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * stride + n0 +
                   (lane / 16) * 8);
}

// Copy rows [row0, row0 + rows) of a [len, D] bf16 matrix into a padded
// shared tile, zero past `len`; 16-byte vectors, all threads of the block.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int len) {
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len) {
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + c) = x;
  }
}

}  // namespace fkp_bwd
