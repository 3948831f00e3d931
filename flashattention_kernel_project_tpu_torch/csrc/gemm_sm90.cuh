// The bf16 GEMM for Hopper (sm_90a): wgmma, TMA and a K ring. gemm.cu's
// fkp_gemm launches it for every call with two bf16 operands, K > 0, K and
// N multiples of 8 and 16-byte-aligned bases (ops/gemm.py::gemm_path):
// matmul and matmul_bf16 at batch 1, batched_matmul at any batch and
// matmul_fused_epilogue, f32 or bf16 out. gemm_sm90.cu builds its four
// instances (tiles of 128 x 256 and 128 x 128, each plain and with the
// fused epilogue) in an nvcc process of its own.
//
// Replaces flashattention_kernel_project_tpu/ops/gemm.py::_matmul_kernel
// (:75, pallas_call :138), _batched_matmul_kernel (:172, pallas_call :226)
// and _fused_epilogue_kernel (:250, pallas_call :310) on those calls;
// aligned f32 calls take gemm_f32_sm90.cuh, which shares this skeleton,
// and the mma.sync core of gemm_core.cuh keeps the unaligned ones and
// K = 0. The function is the same: C = A @ B with f32 accumulation over
// the whole of K (with the epilogue, ReLU(A @ B + bias[col]) +
// residual[row, col] in f32, JAX's order), rounded once to the output
// type; rows past M and K are zero-filled by the TMA maps and columns past
// N never written.
//
// What bounds it on the H100: at the ladder's shapes (M = N = K = 4096;
// 8 x 1024^3) a GEMM does 2*M*N*K flops against 2*(M*K + K*N) bytes in and
// M*N*2 or 4 out, some 600-1400 flops a byte, far above the card's ~295
// flop/byte ridge: the tensor cores' issue rate bounds it (989 TFLOP/s
// bf16). The mma.sync core reached 23% of that at 4096^3: m16n8k16
// products fed by ldmatrix through registers, 32-deep slices in a 2-stage
// cp.async ring behind two block barriers a slice, 128 x 128 tiles at two
// blocks an SM. What each choice here does about that:
// - wgmma m64nNk16 (N = 256 or 128), both operands read from shared memory
//   by descriptor: A [rows][k] row-major is the K-major operand, B
//   [k][cols] row-major the MN-major one (imm-trans-b = 1, the layout of
//   the dense forward's V). No fragment passes through registers; each
//   consumer thread holds only its accumulator (N / 2 f32).
// - A tile of 128 x 256 (two consumer warpgroups of 64 rows, each issuing
//   m64n256k16, 128 accumulators a thread): A's slice is read once for 256
//   columns. Where the 128 x 256 grid would fill at most half the SMs, 128
//   x 128 tiles (m64n128k16) spread the work over twice the blocks
//   (tile_n below).
// - TMA: a producer warpgroup, one thread of which issues the loads, gives
//   its registers to the consumers by setmaxnreg (40 and 232 a thread).
//   A stage holds a 64-deep slice: A as one box of 128 rows x 64 (a
//   128-byte row, swizzled 128B) and B as up to four boxes of 64 k-rows x
//   64 columns, one box apart (boxes wholly past N are not loaded: a
//   column of C reads only its own column of B, and those are never
//   written). The maps are 3-D over [batch, rows, cols], so a ragged tile
//   never reads the next batch's rows.
// - A ring of 4 stages of 48 KB (128 x 256) or 6 of 32 KB (128 x 128) with
//   full and empty mbarriers; a stage is released when the products that
//   read it have retired: one slice's wgmmas stay in flight while the
//   next slice's are issued (wgmma.wait_group 1). Every issue and wait
//   lies on control flow uniform in the warpgroup (under data-dependent
//   branches ptxas serializes wgmma).
// - A persistent schedule: one block an SM walks the tiles, grouped 8 row
//   tiles at a time along M so that the blocks in flight share A's rows
//   and B's columns in L2; the producer loads the next tile's first slices
//   while the consumers write the last one.
// - The epilogue writes the accumulator from registers, in 16-byte pieces
//   (the four threads of a quad trade columns by xor shuffles), each piece
//   wholly inside or outside C: a warp's store covers whole 32-byte
//   sectors. Written in pairs (store2, 4 bytes a thread for bf16) it took
//   22% of the time at 8 x 1024^3.
// - The fused epilogue (kEpi = kBiasRelu) is a template switch of those
//   stores: a thread's piece takes its columns of bias and of its row of
//   the residual as f32 vectors (64 MB of f32 residual at 4096^2, read
//   while the tensor cores idle), loaded a few pieces ahead of the piece
//   being written (`EpiBuf`: four pieces ahead for bf16 C, eight for f32),
//   the first ones before the tile's last wgmma wait. Measured on the H100
//   (PERF.md): the epilogue costs ~0.025 ms at 4096^3 over kernel 13's
//   0.183. Tried and dropped: the producer's L2 prefetch of each tile's
//   residual rows (~5% slower), no loads before the wait (2-4% slower),
//   half the inputs held ahead (~1.4% slower).
// The ring, its producer (load_tile), the consumers' products (mma_tile),
// the maps (encode_ab) and the 16-byte stores are shared with the
// softmax-epilogue GEMM (gemm_softmax_sm90.cuh); the ring, the tile order
// and the stores with the int8 GEMM (gemm_i8_sm90.cu), the tile order with
// the 8-bit-weight GEMM (gemm_w8_sm90.cu).
// What sets the pace now (PERF.md, on the H100): the products alone run at
// ~83% of the bound at 4096^3, and the loads alone as fast as the bound;
// the tensor cores idle while C is written, 7% of the time at 4096^3 and
// 25% at 8 x 1024^3, where every SM writes its tile at once. Tried and
// dropped: two-CTA clusters sharing B's boxes by multicast (as fast, so the
// L2 reads do not bound it), C through shared memory and TMA stores (4%
// slower at 4096^3 and 19% at 8 x 1024^3: the ring lost a stage to C's
// buffer).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_core.cuh"
#include "sm90.cuh"

// The probes of tools/ab_gemm.py's builds (-DFKP_GEMM_PROBE; the library
// builds 0, the GEMM): 1 the loads alone (no wgmma); 2 the products alone
// (each stage loaded once, then re-armed without a load); 3 no epilogue
// (C is not written); 4 gemm_softmax_sm90.cuh's own. Their times say
// which part sets the pace (PERF.md).
#ifndef FKP_GEMM_PROBE
#define FKP_GEMM_PROBE 0
#endif

namespace fkp_gemm_sm90 {

using fkp_gemm_core::Out;
using namespace fkp_sm90;

constexpr int kBM = 128;         // rows of a C tile: two consumer warpgroups
constexpr int kBK = 64;          // K a stage: one 128-byte box row of bf16
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg (128 * 40 + 256 * 232 <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBoxA = kBM * 128;  // A's box: 128 rows of 64 bf16, 16 KB
constexpr int kBoxB = kBK * 128;  // a B box: 64 k-rows of 64 bf16, 8 KB
constexpr int kGroup = 8;         // row tiles a group of the tile order

// Shared memory of the kBN-column instance: the ring's stages, each A's box
// then B's, every box 1024-byte aligned (the 128B swizzle's period), after
// up to 1 KB of alignment slack.
template <int kBN>
struct Layout {
  static constexpr int kBoxesB = kBN / kBoxCols;
  static constexpr int kStage = kBoxA + kBoxesB * kBoxB;  // 48 or 32 KB
  static constexpr int kStages = 192 * 1024 / kStage;     // 4 or 6
  static constexpr int kBytes = 1024 + kStages * kStage;
};

// D[64 x 256] += A[64 x 16] * B[16 x 256], both in shared memory by
// descriptor: A K-major, B MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], both in shared memory by
// descriptor: A K-major, B MN-major (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kBN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (kBN == 256) {
    wgmma_n256(d, da, db);
  } else {
    wgmma_n128(d, da, db);
  }
}

// The fused epilogue's inputs a thread holds ahead of the pieces it
// writes: kEpiBuf float4, for each of the next few pieces its columns of
// bias, then of its row of the residual (kW = 8 columns a piece for bf16
// C, four float4 a piece; kW = 4 for f32 C, two): epi_ahead<kW>() pieces.
constexpr int kEpiBuf = 16;
struct EpiBuf {
  float4 v[kEpiBuf];
};

template <int kW>
__host__ __device__ constexpr int epi_ahead() {
  return 2 * kEpiBuf / kW;
}

// Piece p's first column of the pieces a thread writes, of kW columns
// (store_bf16x8's for kW = 8, store_f32x4's for 4).
template <int kW>
__device__ __forceinline__ int piece_col(int col0, int p, int q) {
  return kW == 8 ? col0 + (2 * p + (q >> 1)) * 8 : col0 + p * 8 + 4 * (q >> 1);
}

// Loads into slot `slot` of e the bias and residual of the piece of kW
// columns at (row, col); a piece outside C (never written) reads row 0,
// column 0 instead, so that every load stays inside the tensors.
template <int kW>
__device__ __forceinline__ void load_piece(EpiBuf& e, int slot, const Out& o,
                                           int row, int col) {
  constexpr int kV = kW / 4;  // float4s of bias (and of residual) a piece
  const bool live = row < o.m && col < o.n;
  const int r = live ? row : 0, c = live ? col : 0;
  const float4* b = reinterpret_cast<const float4*>(o.bias + c);
  const float4* x = reinterpret_cast<const float4*>(o.residual + (size_t)r * o.n + c);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    e.v[slot * 2 * kV + i] = __ldg(b + i);
    e.v[slot * 2 * kV + kV + i] = __ldg(x + i);
  }
}

// The first pieces' epilogue inputs of a thread writing row `row` of the
// tile at col0 (as many as e holds).
template <int kW>
__device__ __forceinline__ void epi_first(EpiBuf& e, const Out& o, int row,
                                          int col0, int q) {
#pragma unroll
  for (int p = 0; p < epi_ahead<kW>(); ++p) {
    load_piece<kW>(e, p, o, row, piece_col<kW>(col0, p, q));
  }
}

// ReLU(acc + bias) + residual, in f32, in the TPU kernel's order
__device__ __forceinline__ float bias_relu(float acc, float bias, float res) {
  return fmaxf(acc + bias, 0.f) + res;
}

// Piece p's epilogue inputs (bias then residual, kW of each) from e as
// f32, and the load of piece p + epi_ahead<kW>() into its slot (of
// `pieces`).
template <int kW>
__device__ __forceinline__ void take_piece(EpiBuf& e, int p, int pieces,
                                           const Out& o, int row, int col0,
                                           int q, float (&bias)[kW],
                                           float (&res)[kW]) {
  constexpr int kAhead = epi_ahead<kW>(), kV = kW / 4;
  const int slot = p % kAhead;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const float4 b = e.v[slot * 2 * kV + i], x = e.v[slot * 2 * kV + kV + i];
    bias[4 * i] = b.x, bias[4 * i + 1] = b.y, bias[4 * i + 2] = b.z, bias[4 * i + 3] = b.w;
    res[4 * i] = x.x, res[4 * i + 1] = x.y, res[4 * i + 2] = x.z, res[4 * i + 3] = x.w;
  }
  if (p + kAhead < pieces) {
    load_piece<kW>(e, slot, o, row, piece_col<kW>(col0, p + kAhead, q));
  }
}

// bf16 C in 16-byte pieces: for n8 blocks j and j + 1, the four threads of
// a quad hold columns 2q, 2q + 1 of rows g and g + 8 in each; three xor
// shuffles give thread q the eight columns of piece q: block j + (q >> 1),
// row g + 8 (q & 1), written to row `row` of C. A piece lies wholly inside
// or outside [n) (n % 8 == 0).
template <int kBN>
__device__ __forceinline__ void store_bf16x8(const Out& o, size_t bbase,
                                             int row, int col0,
                                             const float (&acc)[kBN / 2],
                                             int q) {
  __nv_bfloat16* c = static_cast<__nv_bfloat16*>(o.c) + bbase + (size_t)row * o.n;
#pragma unroll
  for (int j = 0; j < kBN / 8; j += 2) {
    uint32_t w[4];  // piece i's columns 2q, 2q + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = fkp_mma::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
    uint32_t out[4];  // this thread's piece, from quad lane i's columns
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int peer = q ^ r;  // sends w[q], receives our w[peer]
      const uint32_t send = peer == 0 ? w[0] : peer == 1 ? w[1]
                          : peer == 2 ? w[2] : w[3];
      const uint32_t got = r == 0 ? send : __shfl_xor_sync(0xffffffffu, send, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i == peer) out[i] = got;
      }
    }
    const int col = col0 + (j + (q >> 1)) * 8;
    if (row < o.m && col < o.n) {
      *reinterpret_cast<uint4*>(c + col) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// The same stores through the epilogue kEpi (kBiasRelu): the shuffles
// trade f32 pairs, and each piece takes its bias and residual from e
// (epi_first's, refilled as the pieces go) before it is rounded.
template <int kBN, int kEpi>
__device__ __forceinline__ void store_bf16x8(const Out& o, size_t bbase,
                                             int row, int col0,
                                             const float (&acc)[kBN / 2],
                                             int q, EpiBuf& e) {
  static_assert(kEpi == fkp_gemm_core::kBiasRelu, "the plain stores take no EpiBuf");
  __nv_bfloat16* c = static_cast<__nv_bfloat16*>(o.c) + bbase + (size_t)row * o.n;
#pragma unroll
  for (int j = 0; j < kBN / 8; j += 2) {
    float2 w[4];  // piece i's columns 2q, 2q + 1, in f32
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    float2 got2[4];  // the piece's columns 2i, 2i + 1, from quad lane i
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int peer = q ^ r;
      const float2 send = peer == 0 ? w[0] : peer == 1 ? w[1] : peer == 2 ? w[2] : w[3];
      float2 got = send;
      if (r != 0) {
        got.x = __shfl_xor_sync(0xffffffffu, send.x, r);
        got.y = __shfl_xor_sync(0xffffffffu, send.y, r);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i == peer) got2[i] = got;
      }
    }
    float bias[8], res[8];
    take_piece<8>(e, j / 2, kBN / 16, o, row, col0, q, bias, res);
    uint32_t out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = fkp_mma::pack_bf16(bias_relu(got2[i].x, bias[2 * i], res[2 * i]),
                                  bias_relu(got2[i].y, bias[2 * i + 1], res[2 * i + 1]));
    }
    const int col = col0 + (j + (q >> 1)) * 8;
    if (row < o.m && col < o.n) {
      *reinterpret_cast<uint4*>(c + col) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

// f32 C in 16-byte pieces: in n8 block j, quad lanes q and q ^ 1 swap one
// pair (one xor shuffle of two words) so that lane q holds columns
// 4 (q >> 1) .. + 3 of row g + 8 (q & 1), written to row `row` of C. A
// piece lies wholly inside or outside [n).
template <int kBN>
__device__ __forceinline__ void store_f32x4(const Out& o, size_t bbase,
                                            int row, int col0,
                                            const float (&acc)[kBN / 2],
                                            int q) {
  float* c = static_cast<float*>(o.c) + bbase + (size_t)row * o.n;
  const bool odd = q & 1;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    // keep this row's pair, send the other row's
    const float k0 = odd ? acc[4 * j + 2] : acc[4 * j];
    const float k1 = odd ? acc[4 * j + 3] : acc[4 * j + 1];
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const int col = col0 + j * 8 + 4 * (q >> 1);
    if (row < o.m && col < o.n) {
      *reinterpret_cast<float4*>(c + col) =
          odd ? make_float4(g0, g1, k0, k1) : make_float4(k0, k1, g0, g1);
    }
  }
}

// The same stores through the epilogue kEpi (kBiasRelu), each piece's bias
// and residual from e, as store_bf16x8's.
template <int kBN, int kEpi>
__device__ __forceinline__ void store_f32x4(const Out& o, size_t bbase,
                                            int row, int col0,
                                            const float (&acc)[kBN / 2],
                                            int q, EpiBuf& e) {
  static_assert(kEpi == fkp_gemm_core::kBiasRelu, "the plain stores take no EpiBuf");
  float* c = static_cast<float*>(o.c) + bbase + (size_t)row * o.n;
  const bool odd = q & 1;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const float k0 = odd ? acc[4 * j + 2] : acc[4 * j];
    const float k1 = odd ? acc[4 * j + 3] : acc[4 * j + 1];
    const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
    const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
    const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 v = odd ? make_float4(g0, g1, k0, k1) : make_float4(k0, k1, g0, g1);
    float bias[4], res[4];
    take_piece<4>(e, j, kBN / 8, o, row, col0, q, bias, res);
    const int col = col0 + j * 8 + 4 * (q >> 1);
    if (row < o.m && col < o.n) {
      *reinterpret_cast<float4*>(c + col) =
          make_float4(bias_relu(v.x, bias[0], res[0]), bias_relu(v.y, bias[1], res[1]),
                      bias_relu(v.z, bias[2], res[2]), bias_relu(v.w, bias[3], res[3]));
    }
  }
}

// Tile t of the order the blocks walk: batch-major; in a batch, groups of
// kGroup row tiles, each group column by column, its row tiles innermost
// (tiles of kRows x kBN; the 8-bit-weight GEMM's small-M plan takes 64
// rows).
template <int kBN, int kRows = kBM>
__device__ __forceinline__ void tile_at(int t, int m_tiles, int n_tiles,
                                        int& b, int& row0, int& col0) {
  const int per_batch = m_tiles * n_tiles;
  b = t / per_batch;
  const int r = t - b * per_batch;
  const int span = kGroup * n_tiles;  // tiles of a whole group
  const int first = r / span * kGroup;
  const int rows = min(m_tiles - first, kGroup);
  const int in = r - first * n_tiles;
  row0 = (first + in % rows) * kRows;
  col0 = in / rows * kBN;
}

// The K ring of a kBN-column instance in shared memory, as one role (the
// producer, or a consumer warpgroup) walks it: the stages' boxes from
// `base` (1024-byte aligned), their full and empty mbarriers from shared
// address `bars` (full [kStages], then empty [kStages]), and the role's
// stage and phase.
template <int kBN>
struct Ring {
  using L = Layout<kBN>;
  uint32_t base;
  uint32_t bars;
  int st = 0, phase = 0;

  __device__ __forceinline__ uint32_t a_s(int s) const { return base + s * L::kStage; }
  __device__ __forceinline__ uint32_t b_s(int s) const { return a_s(s) + kBoxA; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (L::kStages + s);
  }
  __device__ __forceinline__ void advance() {
    if (++st == L::kStages) {
      st = 0;
      phase ^= 1;
    }
  }
  // one thread, before the block's barrier: a load completes a stage's full
  // barrier, one arrival of each consumer warp its empty one
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The producer warpgroup gives its registers to the consumers.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
}

// The producer thread's loads for one tile of C (rows row0.., columns
// col0.. of batch b): A's box and B's boxes that hold a column below n, a
// 64-deep slice of K a stage, n_k slices. `first`: the block's first tile
// (the products-alone probe loads the ring's stages then only).
template <int kBN>
__device__ __forceinline__ void load_tile(Ring<kBN>& r, const CUtensorMap* a_map,
                                          const CUtensorMap* b_map, int b,
                                          int row0, int col0, int n, int n_k,
                                          bool first) {
  using L = Layout<kBN>;
  const int boxes = min(L::kBoxesB, (n - col0 + kBoxCols - 1) / kBoxCols);
  for (int kt = 0; kt < n_k; ++kt) {
    // the stage's previous slice released by every consumer warp (the
    // first round passes at once)
    mbar_wait(r.empty(r.st), r.phase ^ 1);
    if (FKP_GEMM_PROBE == 2 && (r.phase || !first || kt >= L::kStages)) {
      mbar_arrive(r.full(r.st));
    } else {
      mbar_expect_tx(r.full(r.st), kBoxA + boxes * kBoxB);
      tma_load(r.a_s(r.st), a_map, r.full(r.st), kt * kBK, row0, b);
      for (int x = 0; x < boxes; ++x) {
        tma_load(r.b_s(r.st) + x * kBoxB, b_map, r.full(r.st),
                 col0 + x * kBoxCols, kt * kBK, b);
      }
    }
    r.advance();
  }
}

// nothing: mma_tile's default work before its last wait
struct NoPre {
  __device__ __forceinline__ void operator()() const {}
};

// A consumer warpgroup's products for one tile: acc = its 64 rows of A @
// the tile's columns of B over n_k slices of the ring. A stage is released
// when the products that read it have retired: one slice's wgmmas stay in
// flight while the next slice's are issued. acc's element 4j + e lies at
// (row g if e < 2 else g + 8, column 8j + 2q + (e & 1)) of the warp's 16
// rows (lane = 4g + q). pre() runs before the last wait, while the last
// slice's products are in flight (the fused epilogue's first loads).
template <int kBN, class Pre = NoPre>
__device__ __forceinline__ void mma_tile(Ring<kBN>& r, float (&acc)[kBN / 2],
                                         int wg, int lane, int n_k,
                                         Pre pre = Pre{}) {
  const auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty(s));
  };
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  int prev = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(r.full(r.st), r.phase);
    wgmma_fence();
    // 16 of k (32 bytes) a step: along A's swizzled rows, and 16 rows
    // (2048 bytes) down B's boxes, whose next 64 columns lie a box away
#pragma unroll
    for (int kk = 0; kk < (FKP_GEMM_PROBE == 1 ? 0 : kBK / 16); ++kk) {
      wgmma_tile<kBN>(acc, desc(r.a_s(r.st) + wg * 64 * 128 + kk * 32, 16, 1024),
                      desc(r.b_s(r.st) + kk * 2048, kBoxB, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products have retired
    if (kt > 0) release(prev);
    prev = r.st;
    r.advance();
  }
  pre();
  wgmma_wait<0>();
  pin(acc);
  release(prev);
}

// C [batch, m, n] = A [batch, m, k] @ B [batch, k, n] through the maps
// a_map (boxes of 128 rows x 64 of k) and b_map (boxes of 64 k-rows x 64
// columns), with the fused epilogue where kEpi = kBiasRelu (o.bias and
// o.residual f32, 16-byte aligned; batch 1). The first 256 threads are the
// consumer warpgroups, 64 rows of the tile each, the last 128 the producer
// warpgroup. Block i takes tiles i, i + gridDim.x, ...
template <int kBN, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, Out o, int k,
                     int batch) {
  using L = Layout<kBN>;
  constexpr bool kEpilogue = kEpi == fkp_gemm_core::kBiasRelu;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * L::kStages];  // full, empty
  Ring<kBN> ring{(smem_u32(smem_raw) + 1023u) & ~1023u, smem_u32(bars)};
  const int m_tiles = (o.m + kBM - 1) / kBM;
  const int n_tiles = (o.n + kBN - 1) / kBN;
  const int total = batch * m_tiles * n_tiles;
  const int n_k = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread loads
    producer_regs();
    if (threadIdx.x == kConsumers) {
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int b, row0, col0;
        tile_at<kBN>(t, m_tiles, n_tiles, b, row0, col0);
        load_tile(ring, &a_map, &b_map, b, row0, col0, o.n, n_k, t == blockIdx.x);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int q = lane % 4;  // accumulator column pair
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int b, row0, col0;
    tile_at<kBN>(t, m_tiles, n_tiles, b, row0, col0);
    float acc[kBN / 2];
    [[maybe_unused]] EpiBuf epi;  // the fused epilogue's inputs, a few pieces ahead
    if constexpr (kEpilogue) {
      // the first pieces' inputs, loaded while the last slice's products run
      const int erow = row0 + wg * 64 + warp * 16 + g + 8 * (q & 1);
      mma_tile(ring, acc, wg, lane, n_k, [&] {
        if (o.bf16) {
          epi_first<8>(epi, o, erow, col0, q);
        } else {
          epi_first<4>(epi, o, erow, col0, q);
        }
      });
    } else {
      mma_tile(ring, acc, wg, lane, n_k);
    }
    if (FKP_GEMM_PROBE == 3) {  // keep the products live: one test, no store
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) bits |= __float_as_uint(acc[i]);
      if (bits == 0x7fc00001u) static_cast<float*>(o.c)[0] = 0.f;
      continue;
    }
    // this thread's pieces lie in row g + 8 (q & 1) of its warp's 16
    const int row = row0 + wg * 64 + warp * 16 + g + 8 * (q & 1);
    const size_t bbase = (size_t)b * o.m * o.n;
    if constexpr (kEpilogue) {
      if (o.bf16) {
        store_bf16x8<kBN, kEpi>(o, bbase, row, col0, acc, q, epi);
      } else {
        store_f32x4<kBN, kEpi>(o, bbase, row, col0, acc, q, epi);
      }
    } else if (o.bf16) {
      store_bf16x8<kBN>(o, bbase, row, col0, acc, q);
    } else {
      store_f32x4<kBN>(o, bbase, row, col0, acc, q);
    }
  }
}

// The column width of the tiles a call takes: 256, or 128 where the
// 128 x 256 grid would fill at most half the card's SMs (twice the blocks
// then, each at half the work).
inline int tile_n(int batch, int m, int n, int sms) {
  const long long wide = (long long)batch * ((m + kBM - 1) / kBM) * ((n + 255) / 256);
  return 2 * wide <= sms ? 128 : 256;
}

// The 3-D maps over [batch, rows, cols] of A (boxes of 128 rows x 64 of k)
// and B (boxes of 64 k-rows x 64 columns): a ragged tile reads zeros past
// its own batch's rows, never the next batch's. False if one fails.
inline bool encode_ab(CUtensorMap* am, CUtensorMap* bm, const void* a,
                      const void* b, const Out& o, int batch, int k) {
  return encode_map(am, a, k, o.m, batch, kBM) &&
         encode_map(bm, b, o.n, k, batch, kBK);
}

// Launches instance (kBN, kEpi) on a grid of min(tiles, sms) blocks;
// returns a CUDA error code (the shared-memory attribute's,
// cudaErrorInvalidValue where a map cannot be encoded, else
// cudaGetLastError() after the launch).
template <int kBN, int kEpi>
int launch(const void* a, const void* b, const Out& o, int batch, int k,
           int sms, cudaStream_t stream) {
  const auto kernel = &gemm_sm90_kernel<kBN, kEpi>;
  constexpr int kBytes = Layout<kBN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap am, bm;
  if (!encode_ab(&am, &bm, a, b, o, batch, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      (long long)batch * ((o.m + kBM - 1) / kBM) * ((o.n + kBN - 1) / kBN);
  const long long grid = tiles > sms ? sms : tiles;
  kernel<<<static_cast<unsigned>(grid), kThreads, kBytes, stream>>>(
      am, bm, o, k, batch);
  return static_cast<int>(cudaGetLastError());
}

// The card's SM count into *sms; a CUDA error code.
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(err);
}

// C = A @ B for a [batch, m, k] and b [batch, k, n] bf16, contiguous, k > 0,
// k and n multiples of 8, 16-byte-aligned bases, into o (bf16 or f32) on
// `stream`, through the fused epilogue where `epilogue` (batch 1, o.bias
// and o.residual f32 and 16-byte aligned); gemm_sm90.cu builds it. A CUDA
// error code.
int launch_gemm(const void* a, const void* b, const Out& o, int batch, int k,
                int epilogue, cudaStream_t stream);

}  // namespace fkp_gemm_sm90
