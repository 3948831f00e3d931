// Warp-level helpers shared by every kernel that stages tiles in shared
// memory and multiplies them on the tensor cores: the mma.sync attention
// forwards (flash_fwd_core.cuh), the GEMMs (gemm_core.cuh, gemm_i8.cu) and
// the decodes (the wgmma kernels take its bf16 packing). One copy,
// so that the fragment layouts and the copy semantics cannot drift apart
// between the kernel families.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row):  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B (16 x 8, col):   b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8):        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// mma.m16n8k32 with int8 operands has the same layouts in bytes: each
// 32-bit register holds 4 int8 where the bf16 form holds 2 bf16 (a0: row g,
// k 4t..4t+3; b0: k 4t..4t+3, n g), so ldmatrix (b16) loads int8 tiles
// stored [m][k] and [n][k] unchanged, a pair of int8 taken as one b16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fkp_mma {

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

// p as a bf16 pair hi + lo with hi = bf16(p), lo = bf16(p - hi): about 16
// significant bits, where bf16 alone keeps 8.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// D = A(16x32, row) * B(32x8, col) + D, int8 inputs, exact int32 accumulate.
__device__ __forceinline__ void mma_16832_s8(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
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

// 16 bytes from device to shared memory without passing through registers
// (cp.async, sm_80+); valid == false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

// the 4 x 4 bytes w[r] (row r, bytes = columns 0..3) transposed: out[c]
// holds column c, rows 0..3 in its bytes. The int8 products want 4 bytes
// consecutive along their depth: gemm_i8.cu turns B's [k][n] rows into
// [n][k] words with it, flash_decode_mxu.cu 4 keys' V rows into one word a
// dim.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// wait until every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// close the group of this thread's cp.async started since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace fkp_mma
