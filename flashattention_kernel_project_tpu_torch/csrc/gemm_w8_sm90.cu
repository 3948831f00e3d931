// The 8-bit-weight GEMM for Hopper (sm_90a) on wgmma: out = (bf16(x) @
// w_q) * w_scale[col], x [M, K] bf16, w_q [K, N] int8 or e4m3, w_scale
// [1, N] f32, the sum in f32 and one rounding to the output type.
// ops/quant.py's matmul_int8_weights and matmul_fp8_weights launch it for
// every call that `w8_path` calls aligned (K > 0, K a multiple of 8, N of
// 16, 16-byte bases), with the tile `w8_plan` picks; the other calls keep
// gemm_w8.cu's mma.sync kernel.
//
// Replaces flashattention_kernel_project_tpu/ops/quant.py::_matmul_w8_kernel
// (matmul_int8_weights, :133; matmul_fp8_weights, :193) on those calls:
// the TPU kernel widens an 8-bit tile to bf16 in VMEM and applies the
// column scale on the f32 accumulator at the last K step. The products stay
// bf16: x is bf16, and both 8-bit types widen to bf16 exactly.
//
// The design computes C^T = W^T x^T, so that the weights are wgmma's A
// operand from registers and each weight byte is read from shared memory
// once a tile:
// - A tile is kBM rows of x (C's rows) by 64 kWG columns of C, each consumer
//   warpgroup owning 64 columns. The producer warpgroup's first thread
//   loads by TMA, a 64-deep slice a stage, x's box (kBM rows x 64 of k,
//   128B-swizzled, K-major: wgmma's B operand as it is, imm-trans-b = 0,
//   read as kernel 13 reads its A) and w_q's bytes (64 k-rows x 64 kWG,
//   swizzled 128B, or 64B for 64-byte rows).
// - A consumer warp widens its 16 columns of the slice in registers: two
//   ldmatrix.x4.trans of the bytes read as b16 pairs give each thread, a
//   k16 step, the bytes (k 2q, 2q + 1) x (columns 2g, 2g + 1) of its rows;
//   one byte permute and widen.cuh::widen4 (int8 by a bf16 subtraction,
//   e4m3 through cvt to f16, both exact) make the step's four A-fragment
//   registers. Fragment row r < 8 is column 2r of the warp's 16, row r + 8
//   column 2r + 1. The next slice is widened while this one's products
//   run (two fragment buffers).
// - wgmma m64nKBMk16 (kBM = 256, 128, 64 or 16) sums C^T's 64 columns x
//   kBM rows in f32; a stage is released when its products have retired.
// - The epilogue multiplies by the column scale (two a thread: its columns
//   2g, 2g + 1) with __fmul_rn and rounds once, as _matmul_w8_plain does,
//   and stores each (row, column pair) as one 4- or 8-byte piece: a warp's
//   store covers 4 rows x 16 columns, whole 32-byte sectors for bf16.
// - The tile (w8_plan): 256 x 128 (x rows x columns, two consumer
//   warpgroups, one block an SM) where M > 128 and that grid has a tile an
//   SM, 128 x 128 where 64 < M <= 128 and it has; else 64 x 64, or 16 x 64
//   where M <= 16 (one consumer warpgroup, two blocks an SM): the decode
//   shape (M 8, K 2048, N 11008) takes 172 tiles of 16 x 64 for 132 SMs.
// Dropped (PERF.md): C = x W with the bytes widened by three producer
// warps into the MN-major planes kernel 13 reads took 0.3501 ms int8 and
// 0.2813 e4m3 at 4096^3 on the H100: the planes' extra 48 KB of
// shared-memory traffic a slice, on top of kernel 13's ~128 KB, and the
// widening warps' latency set the pace (its loads alone 0.1176, without
// the widening 0.1813).
//
// What bounds it on the H100: at 4096^3 the bf16 tensor-core rate (2*M*N*K
// operations at 989 TFLOP/s, 0.139 ms); at the decode shape the bytes
// (K*N of weights, 22.8 MB in all, 0.0068 ms at 3.35 TB/s). A 64-deep
// slice of a 256 x 128 tile moves ~112 KB of shared memory (the TMA's 40
// KB, the wgmmas' 64 KB of x, the bytes' 8 KB) against kernel 13's ~128 KB
// for the same products.

#include "gemm_sm90.cuh"
#include "widen.cuh"

// The probes of tools/ab_gemm.py w8 (-DFKP_GEMM_PROBE; the library builds
// 0): 1 the loads alone (no widening, no products); 2 the products and the
// widening alone (each stage loaded once, then re-armed without a load);
// 7 no widening (the A fragments are the raw words of the ldmatrix).

namespace fkp_w8_sm90 {

using namespace fkp_gemm_sm90;

constexpr bool kWork = FKP_GEMM_PROBE != 1;   // widening and products
constexpr bool kWiden = FKP_GEMM_PROBE != 7;

// The instance of kBM rows of x and kWG consumer warpgroups (64 kWG
// columns of C): shared memory is the ring's stages (x's box, then w_q's
// bytes), every box 1024-byte aligned, after up to 1 KB of alignment
// slack; two consumer warpgroups take setmaxnreg and one block an SM, one
// takes two blocks an SM.
template <int kBM, int kWG>
struct W8Layout {
  static constexpr int kCols = 64 * kWG;
  static constexpr int kConsumerThreads = 128 * kWG;
  static constexpr int kThreads = kConsumerThreads + 128;
  static constexpr int kBoxX = kBM * 128;    // x: kBM rows x 64 bf16
  static constexpr int kBytesW = kBK * kCols;  // w_q: 64 k-rows x kCols bytes
  static constexpr int kStage = kBoxX + kBytesW;
  static constexpr int kMinBlocks = kWG == 2 ? 1 : 2;
  static constexpr int kBudget = kWG == 2 ? 224 * 1024 : 108 * 1024;
  static constexpr int kStages = kBudget / kStage > 8 ? 8 : kBudget / kStage;
  static constexpr int kBytes = 1024 + kStages * kStage;
};

// D[64 x 256] += A[64 x 16] * B[16 x 256], A in registers (each warp's 16
// rows in the m16n8k16 A-fragment layout), B in shared memory K-major
// (imm-trans-b = 0: x's rows, as kernel 13 reads its A)
__device__ __forceinline__ void wgmma_rs_kmaj_n256(float (&d)[128],
                                                  const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (each warp's 16
// rows in the m16n8k16 A-fragment layout), B in shared memory K-major
// (imm-trans-b = 0: x's rows, as kernel 13 reads its A)
__device__ __forceinline__ void wgmma_rs_kmaj_n128(float (&d)[64],
                                                  const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (each warp's 16
// rows in the m16n8k16 A-fragment layout), B in shared memory K-major
// (imm-trans-b = 0: x's rows, as kernel 13 reads its A)
__device__ __forceinline__ void wgmma_rs_kmaj_n64(float (&d)[32],
                                                  const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], A in registers (each warp's 16
// rows in the m16n8k16 A-fragment layout), B in shared memory K-major
// (imm-trans-b = 0: x's rows, as kernel 13 reads its A)
__device__ __forceinline__ void wgmma_rs_kmaj_n16(float (&d)[8],
                                                  const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kBM>
__device__ __forceinline__ void wgmma_w8(float (&d)[kBM / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kBM == 256) {
    wgmma_rs_kmaj_n256(d, a, db);
  } else if constexpr (kBM == 128) {
    wgmma_rs_kmaj_n128(d, a, db);
  } else if constexpr (kBM == 64) {
    wgmma_rs_kmaj_n64(d, a, db);
  } else {
    wgmma_rs_kmaj_n16(d, a, db);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The byte offset of 16-byte chunk c of k-row k in w_q's box of kCols-byte
// rows, as the TMA swizzles it (128B: chunk c ^ (k & 7); 64B: c ^ ((k >> 1)
// & 3))
template <int kCols>
__device__ __forceinline__ uint32_t w_off(int k, int c) {
  if constexpr (kCols == 128) {
    return k * 128 + ((c ^ (k & 7)) << 4);
  } else {
    return k * 64 + ((c ^ ((k >> 1) & 3)) << 4);
  }
}

// This warp's A fragments of one 64-deep slice (four k16 steps) from the
// stage's bytes at w (shared address): f[s] is step s's fragment of the
// warp's 16 columns, chunk c of the rows.
template <class TB, int kCols>
__device__ __forceinline__ void widen_slice(uint32_t (&f)[4][4], uint32_t w, int c,
                                            int lane) {
  // lane t addresses row t % 8 of matrix t / 8: steps 2h + (t / 8) / 2, k
  // rows 8 ((t / 8) % 2) .. + 7 of the step
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 16 * (2 * h + lane / 16) + 8 * (lane / 8 % 2) + lane % 8;
    uint32_t r[4];
    ldsm_x4_trans(r, w + w_off<kCols>(k, c));
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t(&a)[4] = f[2 * h + s];
      if constexpr (kWiden) {
        // bytes (k 2q, col 2g), (2q, 2g + 1), (2q + 1, 2g), (2q + 1, 2g + 1)
        // permuted to column pairs, then widened
        fkp::widen4<TB>(__byte_perm(r[2 * s], 0u, 0x3120), a[0], a[1]);
        fkp::widen4<TB>(__byte_perm(r[2 * s + 1], 0u, 0x3120), a[2], a[3]);
      } else {
        a[0] = a[1] = r[2 * s];
        a[2] = a[3] = r[2 * s + 1];
      }
    }
  }
}

// C [m, n] = bf16 x [m, k] @ widened w_q [k, n], times w_scale, through
// the maps x_map (boxes of kBM rows x 64 of k) and w_map (w_q's bytes,
// boxes of 64 k-rows x 64 kWG). The first 128 kWG threads are the consumer
// warpgroups, 64 columns of the tile each; the last 128 the producer
// warpgroup, whose first thread loads. Block i takes tiles i, i +
// gridDim.x, ...
template <class TB, int kBM, int kWG>
__global__ void __launch_bounds__(W8Layout<kBM, kWG>::kThreads,
                                  W8Layout<kBM, kWG>::kMinBlocks)
    gemm_w8_sm90_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap w_map, Out o, int k) {
  using L = W8Layout<kBM, kWG>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * L::kStages];  // full, empty
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const auto x_s = [&](int st) { return base + st * L::kStage; };
  const auto w_s = [&](int st) { return base + st * L::kStage + L::kBoxX; };
  const auto full = [&](int st) { return smem_u32(&bars[st]); };
  const auto empty = [&](int st) { return smem_u32(&bars[L::kStages + st]); };
  const int m_tiles = (o.m + kBM - 1) / kBM;
  const int n_tiles = (o.n + L::kCols - 1) / L::kCols;
  const int total = m_tiles * n_tiles;
  const int n_k = (k + kBK - 1) / kBK;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), L::kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumerThreads) {  // the producer warpgroup
    if constexpr (kWG == 2) producer_regs();
    if (threadIdx.x != L::kConsumerThreads) return;
    int st = 0, phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int b, row0, col0;
      tile_at<L::kCols, kBM>(t, m_tiles, n_tiles, b, row0, col0);
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(empty(st), phase ^ 1);
        if (FKP_GEMM_PROBE == 2 && (phase || t != blockIdx.x || kt >= L::kStages)) {
          mbar_arrive(full(st));
        } else {
          mbar_expect_tx(full(st), L::kStage);
          tma_load(x_s(st), &x_map, full(st), kt * kBK, row0, 0);
          tma_load(w_s(st), &w_map, full(st), col0, kt * kBK, 0);
        }
        if (++st == L::kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  if constexpr (kWG == 2) consumer_regs();
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  const int g = lane / 4, q = lane % 4;
  const int chunk = wg * 4 + warp;  // this warp's 16 columns of a byte row
  int st = 0, sph = 0;
  const auto advance = [&]() {
    if (++st == L::kStages) {
      st = 0;
      sph ^= 1;
    }
  };
  const auto release = [&](int s) {  // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  };
  uint32_t fa[4][4], fb[4][4];  // the A fragments of two slices
  float acc[kBM / 2];  // element 4j + e: fragment row g (e < 2) or g + 8,
                       // C's row 8j + 2q + (e & 1) of the tile
  // one slice: its products from `cur`, then the next slice widened into
  // `nxt` under them; prev: the stage of the slice before
  const auto slice = [&](uint32_t (&cur)[4][4], uint32_t (&nxt)[4][4], int kt,
                         int& prev) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < (kWork ? 4 : 0); ++s) {
      wgmma_w8<kBM>(acc, cur[s], desc(x_s(st) + s * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products have retired
    pin(nxt);
    if (kt > 0) release(prev);
    prev = st;
    advance();
    if (kt + 1 < n_k) {
      mbar_wait(full(st), sph);
      if (kWork) widen_slice<TB, L::kCols>(nxt, w_s(st), chunk, lane);
    }
  };
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int b, row0, col0;
    tile_at<L::kCols, kBM>(t, m_tiles, n_tiles, b, row0, col0);
#pragma unroll
    for (int i = 0; i < kBM / 2; ++i) acc[i] = 0.f;
    mbar_wait(full(st), sph);
    if (kWork) widen_slice<TB, L::kCols>(fa, w_s(st), chunk, lane);
    int prev = 0;
    for (int kt = 0; kt < n_k; kt += 2) {
      slice(fa, fb, kt, prev);
      if (kt + 1 < n_k) slice(fb, fa, kt + 1, prev);
    }
    wgmma_wait<0>();
    pin(acc);
    pin(fa);
    pin(fb);
    release(prev);
    // this thread's columns n, n + 1 (fragment rows g, g + 8), C's rows
    // row0 + 8j + 2q + h
    const int n = col0 + wg * 64 + warp * 16 + 2 * g;
    if (n >= o.n) continue;  // n % 16 == 0: both columns or neither
    const float s0 = __ldg(o.col_scale + n), s1 = __ldg(o.col_scale + n + 1);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * j + 2 * q + h;
        if (m >= o.m) continue;
        const float v0 = __fmul_rn(acc[4 * j + h], s0);
        const float v1 = __fmul_rn(acc[4 * j + 2 + h], s1);
        const size_t idx = (size_t)m * o.n + n;
        if (o.bf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o.c) + idx) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(o.c) + idx) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <class TB, int kBM, int kWG>
int launch_w8(const void* x, const void* w, const Out& o, int k, int sms,
              cudaStream_t stream) {
  using L = W8Layout<kBM, kWG>;
  const auto kernel = &gemm_w8_sm90_kernel<TB, kBM, kWG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xm, wm;
  if (!encode_tiled(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, k, o.m, 1, kBM) ||
      !encode_tiled(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, o.n, k, 1, kBK, L::kCols,
                    L::kCols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      (long long)((o.m + kBM - 1) / kBM) * ((o.n + L::kCols - 1) / L::kCols);
  const long long slots = (long long)sms * L::kMinBlocks;
  const long long grid = tiles > slots ? slots : tiles;
  kernel<<<static_cast<unsigned>(grid), L::kThreads, L::kBytes, stream>>>(xm, wm, o, k);
  return static_cast<int>(cudaGetLastError());
}

template <class TB>
int launch_plan(const void* x, const void* w, const Out& o, int k, int rows,
                int cols, int sms, cudaStream_t stream) {
  if (rows == 256 && cols == 128) return launch_w8<TB, 256, 2>(x, w, o, k, sms, stream);
  if (rows == 128 && cols == 128) return launch_w8<TB, 128, 2>(x, w, o, k, sms, stream);
  if (rows == 64 && cols == 64) return launch_w8<TB, 64, 1>(x, w, o, k, sms, stream);
  if (rows == 16 && cols == 64) return launch_w8<TB, 16, 1>(x, w, o, k, sms, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fkp_w8_sm90

// x [m, k] bf16, w [k, n] int8 (fp8 == 0) or e4m3 (fp8 == 1), w_scale [n]
// f32, all contiguous, k > 0, k a multiple of 8 and n of 16, 16-byte-aligned
// bases; c [m, n] bf16 (bf16_out) or f32; tiles of rows of x x cols of C
// (w8_plan: 256 x 128, 128 x 128, 64 x 64 or 16 x 64, else
// cudaErrorInvalidValue). A CUDA error code (the shared-memory attribute's,
// cudaErrorInvalidValue where a map cannot be encoded, else
// cudaGetLastError() after the launch).
extern "C" int fkp_gemm_w8_sm90(const void* x, const void* w, const void* w_scale,
                                void* c, int m, int n, int k, int fp8, int bf16_out,
                                int rows, int cols, void* stream) {
  using namespace fkp_w8_sm90;
  const Out o{c, nullptr, nullptr, m, n, bf16_out, nullptr,
              static_cast<const float*>(w_scale)};
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  return fp8 ? launch_plan<__nv_fp8_e4m3>(x, w, o, k, rows, cols, sms, s)
             : launch_plan<int8_t>(x, w, o, k, rows, cols, sms, s);
}
