// The f32 GEMM for Hopper (sm_90a) as JAX computes f32 at
// Precision.HIGHEST: each f32 operand split exactly into three bf16 pieces
// (hi + mid + lo = x) and six bf16 products accumulated in f32 on wgmma.
// gemm.cu's fkp_gemm launches it (path 3) for every call with two f32
// operands, K > 0, K and N multiples of 4 and 16-byte-aligned bases
// (ops/gemm.py::gemm_path): matmul at batch 1, batched_matmul at any batch
// and matmul_fused_epilogue, f32 or bf16 out. gemm_f32_sm90.cu builds its
// two instances (plain and with the fused epilogue) in an nvcc process of
// its own.
//
// Replaces flashattention_kernel_project_tpu/ops/gemm.py::_matmul_kernel
// (:75, pallas_call :138), _batched_matmul_kernel (:172, pallas_call :226)
// and _fused_epilogue_kernel (:250, pallas_call :310) on those calls, whose
// jnp.dot runs f32 at Precision.HIGHEST: six bf16 passes on the MXU (JAX
// gemm.py:30-45). The unaligned f32 calls and K = 0 keep gemm_core.cuh's
// f32 FFMA tile. The function is C = A @ B to f32 accuracy (with the
// epilogue, ReLU(C + bias[col]) + residual[row, col] in f32, as
// gemm_sm90.cuh's stores take it), rounded once to the output type; rows
// past M and K are zero-filled by the TMA maps and columns past N never
// written.
//
// The split (`split` below): hi = x with its low 16 bits cleared, mid the
// same of x - hi, lo of x - hi - mid, each with x's sign (so -0 splits
// into three -0); both subtractions are exact, so hi + mid + lo == x for
// every finite x whose bits lie at or above 2^-133 (bf16's subnormal
// spacing), which holds for |x| >= 2^-110; below that the bits under
// 2^-133 are lost. Truncating, not rounding, costs a mask and a subtract a
// piece and never turns a value near FLT_MAX into inf. The products,
// smallest first and hi.hi last: lo.hi, hi.lo, mid.hi, hi.mid, mid.mid,
// hi.hi (mid.lo, lo.mid and lo.lo, about 2^-24 of a product, are dropped,
// as JAX drops them). Non-finite values: a non-finite x keeps hi = x (a NaN
// as the quiet NaN) and has mid = lo = 0, and the five lower products read
// a fourth piece, hf = hi where x is finite and 0 where it is not; so an
// inf or NaN meets the other operand only in hi.hi, where it gives what
// f32 gives (inf times a zero piece of the other operand, NaN, never
// arises), except that an inf times a nonzero |b| < 2^-133 (whose hi is 0)
// gives NaN, not inf.
//
// What bounds it on the H100: six bf16 products of 2*M*N*K flops each at
// 989 TFLOP/s (0.1042 ms at 2048^3; the FFMA core's f32 bound at 67 TFLOP/s
// is 0.2564). What each choice does about that:
// - The skeleton of gemm_sm90.cuh: a producer warpgroup, two consumer
//   warpgroups of 64 rows on wgmma, a persistent grid walking tiles grouped
//   8 row tiles along M, C written from registers in 16-byte pieces (bf16
//   out with N not a multiple of 8 in pairs of columns). The two consumer
//   warpgroups issue a slice's products in turns (two named barriers), so
//   that one's promotion and A split run under the other's products; both
//   waiting on the same plane set had kept them in step (-4% at 2048^3).
// - The accumulation (measured on the H100, PERF.md): the tensor cores add
//   each product into the f32 accumulator with a truncation, so with all six
//   products of the whole of K in one accumulator the error grew with K:
//   1.5e-5 rel-L2 against the fp64 oracle at K = 2048 and 5.8e-5 at 8192
//   (torch.matmul f32 2.2e-7 and 2.5e-7), against a gate of 2e-5. So each
//   32-deep slice's twelve products go into a fresh accumulator (the first
//   with scale-d 0), which FADD adds into a register total: the truncation
//   now acts on a slice's partial sum only. Two accumulators of 64 f32 a
//   thread fit at 128 x 128 tiles, not at 128 x 256: every call takes
//   128 x 128 (wgmma m64n128k16).
// - TMA brings 32-deep f32 slices (A one box of 128 rows x 32, B up to four
//   boxes of 32 k-rows x 32 columns, boxes wholly past N not loaded; 128B
//   swizzle) into a ring of three f32 stages.
// - The splits are what sets the pace (probes 4-6 below, PERF.md):
//   the products with neither split take ~0.13 ms at 2048^3, the kernel
//   ~0.18. So a value takes four operations
//   (`split_pairs`: two masks, two subtractions; a bf16 pair is the high
//   halves of two words, one byte permute) and one more to see whether
//   any value of the slice is not finite; only then is the slice split
//   again by `split` with the fourth piece, hf (with `split` for every
//   value the kernel took a third longer).
// - A's pieces are built in the consumers' registers, wgmma's A operand
//   from registers (B MN-major from shared memory): each thread reads its
//   16 f32 values of the next slice (8-byte loads, two wavefronts a warp)
//   and releases the stage while the current slice's products run, then
//   splits them into fragments a k16 step once those have retired.
// - B's pieces are made by three warps of the producer warpgroup (the
//   fourth issues the TMA loads), apart from the consumers so that the
//   split overlaps the products: a thread takes one k-row of 8 columns (two
//   16-byte loads, three 16-byte stores of bf16 pieces into the MN-major
//   128B-swizzled planes wgmma reads; a quarter-warp covers 8 k-rows of
//   one column group, so both the loads and the stores are conflict-free),
//   two column groups at a time with both loaded first (a warp alone on
//   its sub-partition: -9% at 2048^3), then a proxy fence and one arrival
//   a warp, into a ring of three plane sets. The hf plane is written only
//   for a slice with a value that is not finite (the three warps agree at
//   a named barrier); otherwise the consumers read hf from the hi plane.
// - Shared memory: an f32 stage is A 16 KB + B 16 KB and a set of B planes
//   four of 8 KB; three of each are 192 KB of the 227 KB.
// - Registers: 216 a consumer thread (the total and the slice's
//   accumulator, 64 f32 each, two k16 steps' A fragments, the next slice's
//   16 f32 values) and 72 a producer thread (setmaxnreg, which trades within
//   the 168 a thread the launch gives 384 threads: 256 * 216 + 128 * 72 =
//   384 * 168; an increase past what the decrease frees waits for ever).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

// The probes of tools/ab_gemm.py's builds (-DFKP_GEMM_PROBE; the library
// builds 0, the GEMM): 4 B not split (the planes are not written), 5 A not
// split (the fragments are the raw f32 bits), 6 neither. Their times say
// what the splits cost (PERF.md).

namespace fkp_gemm_sm90 {

constexpr int kF32BN = 128;          // columns of a C tile
constexpr int kBK32 = 32;            // K a stage: one 128-byte box row of f32
constexpr int kF32Cols = 32;         // f32 columns of a 128-byte box row
constexpr int kF32BoxA = kBM * 128;  // A's f32 box: 128 rows x 32, 16 KB
constexpr int kF32BoxB = kBK32 * 128;   // a B box: 32 k-rows x 32 columns, 4 KB
constexpr int kF32BoxesB = kF32BN / kF32Cols;              // 4
constexpr int kF32Stage = kF32BoxA + kF32BoxesB * kF32BoxB;  // 32 KB
constexpr int kPlaneBox = kBK32 * 128;  // a bf16 plane box: 32 k-rows x 64 columns
constexpr int kPlane = kF32BN / kBoxCols * kPlaneBox;       // 8 KB
constexpr int kPieces = 4;              // planes a set: hi, hf, mid, lo
constexpr int kSet = kPieces * kPlane;  // 32 KB
constexpr int kF32Stages = 3;
constexpr int kSets = 3;
// f32 stages, then plane sets, every box 1024-byte aligned (the 128B
// swizzle's period), after up to 1 KB of alignment slack
constexpr int kF32Bytes = 1024 + kF32Stages * kF32Stage + kSets * kSet;
constexpr int kConverters = 3;  // producer warps that split B (warp 0 loads)
// registers a thread after setmaxnreg: the 168 a thread the launch gives
// 384 threads, traded (128 * 72 + 256 * 216 = 384 * 168)
constexpr int kF32ProducerRegs = 72;
constexpr int kF32ConsumerRegs = 216;

// The pieces of x as f32 bit patterns whose low 16 bits are zero (bf16
// values): hi, hf (hi where x is finite, else 0), mid, lo (header).
struct Pieces {
  uint32_t hi, hf, mid, lo;
};

__device__ __forceinline__ Pieces split(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t sign = u & 0x80000000u;  // a zero piece of a negative x is -0
  const uint32_t h = u & 0xffff0000u;
  const float r1 = __fsub_rn(x, __uint_as_float(h));
  const uint32_t m = (__float_as_uint(r1) & 0xffff0000u) | sign;
  const float r2 = __fsub_rn(r1, __uint_as_float(m));
  const uint32_t l = (__float_as_uint(r2) & 0xffff0000u) | sign;
  if ((u & 0x7f800000u) != 0x7f800000u) return {h, h, m, l};
  return {(u & 0x007fffffu) ? 0x7fc00000u : h, 0u, 0u, 0u};
}

// two pieces as one bf16 pair: `first` in the low half
__device__ __forceinline__ uint32_t pair(uint32_t first, uint32_t second) {
  return __byte_perm(first, second, 0x7632);
}

// The split of 2N finite values in four operations a value, as bf16 pairs
// of (2i, 2i + 1): hi, mid, lo (each the high half of x, x - hi, x - hi -
// mid: a pair takes the high halves, so only the subtraction needs a
// mask). Adds each x - hi into `chk`, which turns NaN where a value is not
// finite (inf - inf, NaN - NaN; the finite ones stay far from overflow),
// and then the pieces are wrong: the caller takes `split` instead. Its
// zero pieces of a negative x are +0 where split's are -0, which moves
// nothing but the sign of an exact zero in C.
template <int N>
__device__ __forceinline__ void split_pairs(const float (&x)[2 * N],
                                            uint32_t (&hi)[N], uint32_t (&mid)[N],
                                            uint32_t (&lo)[N], float& chk) {
  uint32_t r1b[2 * N], r2b[2 * N];
#pragma unroll
  for (int i = 0; i < 2 * N; ++i) {
    const float r1 = __fsub_rn(x[i], __uint_as_float(__float_as_uint(x[i]) & 0xffff0000u));
    const float r2 = __fsub_rn(r1, __uint_as_float(__float_as_uint(r1) & 0xffff0000u));
    chk = __fadd_rn(chk, r1);
    r1b[i] = __float_as_uint(r1);
    r2b[i] = __float_as_uint(r2);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = pair(__float_as_uint(x[2 * i]), __float_as_uint(x[2 * i + 1]));
    mid[i] = pair(r1b[2 * i], r1b[2 * i + 1]);
    lo[i] = pair(r2b[2 * i], r2b[2 * i + 1]);
  }
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A in registers (each warp's
// 16 rows in the m16n8k16 A-fragment layout), B in shared memory MN-major
// (imm-trans-b = 1); scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n128_d(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// C in pairs of columns (bf16 out with n not a multiple of 8, where a
// 16-byte piece could straddle n): rows rg and rg + 8 of the accumulator,
// through the epilogue kEpi (store2's, reading bias and residual in pairs).
template <int kEpi>
__device__ __forceinline__ void store_pairs(const Out& o, size_t bbase, int rg,
                                            int col0, const float (&acc)[kF32BN / 2],
                                            int q) {
#pragma unroll
  for (int j = 0; j < kF32BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * q;
    fkp_gemm_core::store2<kEpi>(o, bbase, rg, col, acc[4 * j], acc[4 * j + 1]);
    fkp_gemm_core::store2<kEpi>(o, bbase, rg + 8, col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// C [batch, m, n] = A [batch, m, k] @ B [batch, k, n], f32 operands,
// through the maps a_map (f32 boxes of 128 rows x 32 of k) and b_map (32
// k-rows x 32 columns), with the fused epilogue where kEpi = kBiasRelu
// (gemm_sm90_kernel's). The first 256 threads are the consumer warpgroups,
// 64 rows of the tile each; the last 128 the producer warpgroup: its warp
// 0 issues the loads, warps 1-3 split B. Block i takes tiles i,
// i + gridDim.x, ...
template <int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_f32_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map, Out o,
                         int k, int batch) {
  constexpr bool kEpilogue = kEpi == fkp_gemm_core::kBiasRelu;
  extern __shared__ uint8_t smem_raw[];
  // f32 stages full / empty, plane sets full / empty
  __shared__ __align__(8) uint64_t bars[2 * kF32Stages + 2 * kSets];
  // a set's B slice held a value that is not finite: by splitting warp,
  // and whether the set's hf plane was written
  __shared__ int nonfinite[kSets][kConverters];
  __shared__ int hf_plane[kSets];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic pointer to base
  const auto stage = [](int st) { return st * kF32Stage; };  // offsets
  const auto set = [](int ps) { return kF32Stages * kF32Stage + ps * kSet; };
  const auto full_f32 = [&](int st) { return smem_u32(&bars[st]); };
  const auto empty_f32 = [&](int st) { return smem_u32(&bars[kF32Stages + st]); };
  const auto full_set = [&](int ps) { return smem_u32(&bars[2 * kF32Stages + ps]); };
  const auto empty_set = [&](int ps) {
    return smem_u32(&bars[2 * kF32Stages + kSets + ps]);
  };
  const int m_tiles = (o.m + kBM - 1) / kBM;
  const int n_tiles = (o.n + kF32BN - 1) / kF32BN;
  const int total = batch * m_tiles * n_tiles;
  const int n_k = (k + kBK32 - 1) / kBK32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kF32Stages; ++st) {
      mbar_init(full_f32(st), 1);
      // one arrival a consumer warp (A read) and a splitting warp (B split)
      mbar_init(empty_f32(st), kConsumers / 32 + kConverters);
    }
    for (int ps = 0; ps < kSets; ++ps) {
      mbar_init(full_set(ps), kConverters);
      mbar_init(empty_set(ps), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kF32ProducerRegs));
    const int pw = (threadIdx.x - kConsumers) / 32;
    if (pw == 0) {  // one thread loads
      if (lane != 0) return;
      int st = 0, phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int b, row0, col0;
        tile_at<kF32BN>(t, m_tiles, n_tiles, b, row0, col0);
        // B's boxes that hold a column below n
        const int boxes = min(kF32BoxesB, (o.n - col0 + kF32Cols - 1) / kF32Cols);
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(empty_f32(st), phase ^ 1);
          mbar_expect_tx(full_f32(st), kF32BoxA + boxes * kF32BoxB);
          const uint32_t s = base + stage(st);
          tma_load(s, &a_map, full_f32(st), kt * kBK32, row0, b);
          for (int x = 0; x < boxes; ++x) {
            tma_load(s + kF32BoxA + x * kF32BoxB, &b_map, full_f32(st),
                     col0 + x * kF32Cols, kt * kBK32, b);
          }
          if (++st == kF32Stages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    // warps 1-3 split B: thread `lane` takes k-row `lane` of a slice, 8
    // columns (a column group) at a time, every third group
    const int kr = lane, sw = lane & 7;
    int st = 0, sph = 0, ps = 0, pph = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int b, row0, col0;
      tile_at<kF32BN>(t, m_tiles, n_tiles, b, row0, col0);
      const int groups = FKP_GEMM_PROBE == 4 || FKP_GEMM_PROBE == 6
                             ? 0 : min(kF32BN / 8, (o.n - col0 + 7) / 8);
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(full_f32(st), sph);
        mbar_wait(empty_set(ps), pph ^ 1);
        const uint8_t* src = gbase + stage(st) + kF32BoxA + kr * 128;
        uint8_t* dst = gbase + set(ps) + kr * 128;
        // column group cg: f32 box cg / 4, its 16-byte chunks 2 (cg % 4)
        // and + 1; plane box cg / 8, its chunk cg % 8; all swizzled
        const auto load8 = [&](int cg, float (&v)[8]) {
          const uint8_t* s = src + (cg >> 2) * kF32BoxB;
          const int c0 = (cg & 3) * 2;
          const float4 v0 = *reinterpret_cast<const float4*>(s + ((c0 ^ sw) << 4));
          const float4 v1 = *reinterpret_cast<const float4*>(s + (((c0 + 1) ^ sw) << 4));
          v[0] = v0.x, v[1] = v0.y, v[2] = v0.z, v[3] = v0.w;
          v[4] = v1.x, v[5] = v1.y, v[6] = v1.z, v[7] = v1.w;
        };
        const auto plane = [&](int cg, int p) {
          return reinterpret_cast<uint4*>(dst + p * kPlane + (cg >> 3) * kPlaneBox +
                                          (((cg & 7) ^ sw) << 4));
        };
        float chk = 0.f;
        const auto split_store = [&](int cg, const float (&v)[8]) {
          uint32_t h[4], m[4], l[4];
          split_pairs<4>(v, h, m, l, chk);
          *plane(cg, 0) = make_uint4(h[0], h[1], h[2], h[3]);
          *plane(cg, 2) = make_uint4(m[0], m[1], m[2], m[3]);
          *plane(cg, 3) = make_uint4(l[0], l[1], l[2], l[3]);
        };
        // two groups at a time, both loaded first: a warp alone on its
        // sub-partition hides its load latency behind the other's split
        int cg = pw - 1;
        for (; cg + kConverters < groups; cg += 2 * kConverters) {
          float v[8], w[8];
          load8(cg, v);
          load8(cg + kConverters, w);
          split_store(cg, v);
          split_store(cg + kConverters, w);
        }
        if (cg < groups) {
          float v[8];
          load8(cg, v);
          split_store(cg, v);
        }
        // a non-finite value anywhere in the slice: every splitting warp
        // writes its groups again by `split`, the hf plane too, and the
        // consumers read hf from it (else from hi, equal where finite)
        const int bad = __any_sync(0xffffffffu, chk != chk);
        if (lane == 0) nonfinite[ps][pw - 1] = bad;
        named_sync(1, kConverters * 32);
        const int any = nonfinite[ps][0] | nonfinite[ps][1] | nonfinite[ps][2];
        if (any) {
          for (int cg = pw - 1; cg < groups; cg += kConverters) {
            float v[8];
            load8(cg, v);
            Pieces p[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) p[i] = split(v[i]);
            *plane(cg, 0) = make_uint4(pair(p[0].hi, p[1].hi), pair(p[2].hi, p[3].hi),
                                       pair(p[4].hi, p[5].hi), pair(p[6].hi, p[7].hi));
            *plane(cg, 1) = make_uint4(pair(p[0].hf, p[1].hf), pair(p[2].hf, p[3].hf),
                                       pair(p[4].hf, p[5].hf), pair(p[6].hf, p[7].hf));
            *plane(cg, 2) = make_uint4(pair(p[0].mid, p[1].mid), pair(p[2].mid, p[3].mid),
                                       pair(p[4].mid, p[5].mid), pair(p[6].mid, p[7].mid));
            *plane(cg, 3) = make_uint4(pair(p[0].lo, p[1].lo), pair(p[2].lo, p[3].lo),
                                       pair(p[4].lo, p[5].lo), pair(p[6].lo, p[7].lo));
          }
        }
        if (pw == 1 && lane == 0) hf_plane[ps] = any;
        fence_proxy_async();  // the planes are wgmma's (async proxy) operands
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(full_set(ps));
          mbar_arrive(empty_f32(st));
        }
        if (++st == kF32Stages) {
          st = 0;
          sph ^= 1;
        }
        if (++ps == kSets) {
          ps = 0;
          pph ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kF32ConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;  // in the warpgroup
  const int g = lane / 4;  // accumulator row (and row + 8)
  const int q = lane % 4;  // accumulator column pair
  // this thread's A rows g and g + 8 of its warp's 16, as offsets into a
  // stage's 128B-swizzled A box (row r's 16-byte chunk c at c ^ (r & 7))
  const int ra = (wg * 64 + warp * 16 + g) * 128;
  const int sw = g & 7;
  int st = 0, sph = 0, ps = 0, pph = 0;
  // the slice's A values of this thread: for k16 step s, fragment
  // register i holds (row g, k 2q), (g + 8, 2q), (g, 2q + 8), (g + 8, 2q + 8)
  float2 av[2][4];
  const auto load_a = [&]() {  // the next stage's values, then release it
    mbar_wait(full_f32(st), sph);
    const uint8_t* sa = gbase + stage(st);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = 16 * s + 2 * q + (i >> 1) * 8;
        av[s][i] = *reinterpret_cast<const float2*>(
            sa + ra + (i & 1) * 8 * 128 + (((kc >> 2) ^ sw) << 4) + ((kc & 3) << 2));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_f32(st));
    if (++st == kF32Stages) {
      st = 0;
      sph ^= 1;
    }
  };
  uint32_t fa[2][kPieces][4];  // the slice's A fragments: hi, hf, mid, lo
  // the two warpgroups issue their products of a slice in turns (named
  // barriers 2 and 3, warpgroup 0 first), so that one's promotion and
  // split run under the other's products
  if (wg == 1) named_arrive(2);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int b, row0, col0;
    tile_at<kF32BN>(t, m_tiles, n_tiles, b, row0, col0);
    float acc[kF32BN / 2];  // the total; element 4j + e at (row g if e < 2
                            // else g + 8, column 8j + 2q + (e & 1))
    float part[kF32BN / 2];  // a slice's products, in the same layout
#pragma unroll
    for (int i = 0; i < kF32BN / 2; ++i) acc[i] = 0.f;
    load_a();
    for (int kt = 0; kt < n_k; ++kt) {
      float chk = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float x[8] = {av[s][0].x, av[s][0].y, av[s][1].x, av[s][1].y,
                            av[s][2].x, av[s][2].y, av[s][3].x, av[s][3].y};
        if (FKP_GEMM_PROBE == 5 || FKP_GEMM_PROBE == 6) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t w = pair(__float_as_uint(x[2 * i]), __float_as_uint(x[2 * i + 1]));
            fa[s][0][i] = fa[s][2][i] = fa[s][3][i] = w;
          }
        } else {
          split_pairs<4>(x, fa[s][0], fa[s][2], fa[s][3], chk);
        }
      }
      // hf = hi unless a value is not finite: then the pieces by `split`
      if (__any_sync(0xffffffffu, chk != chk)) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const Pieces x = split(av[s][i].x), y = split(av[s][i].y);
            fa[s][0][i] = pair(x.hi, y.hi);
            fa[s][1][i] = pair(x.hf, y.hf);
            fa[s][2][i] = pair(x.mid, y.mid);
            fa[s][3][i] = pair(x.lo, y.lo);
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int i = 0; i < 4; ++i) fa[s][1][i] = fa[s][0][i];
        }
      }
      mbar_wait(full_set(ps), pph);
      const uint32_t planes = base + set(ps);
      const int hf = hf_plane[ps] ? 1 : 0;  // B's hf plane, or its hi plane
      named_sync(2 + wg);  // the other warpgroup has issued its last slice
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // plane p's k16 step s: 16 k-rows (2048 bytes) down its boxes,
        // whose next 64 columns lie a box away
        const auto db = [&](int p) {
          return desc(planes + p * kPlane + s * 2048, kPlaneBox, 1024);
        };
        wgmma_rs_n128_d(part, fa[s][3], db(hf), s);  // lo . hi (a fresh part)
        wgmma_rs_n128_d(part, fa[s][1], db(3), 1);   // hi . lo
        wgmma_rs_n128_d(part, fa[s][2], db(hf), 1);  // mid . hi
        wgmma_rs_n128_d(part, fa[s][1], db(2), 1);   // hi . mid
        wgmma_rs_n128_d(part, fa[s][2], db(2), 1);  // mid . mid
        wgmma_rs_n128_d(part, fa[s][0], db(0), 1);  // hi . hi
      }
      wgmma_commit();
      if (wg == 0 || kt + 1 < n_k || t + gridDim.x < total) named_arrive(3 - wg);
      if (kt + 1 < n_k) load_a();  // under the products
      wgmma_wait<0>();
      pin(part);
      pin(fa[0]);
      pin(fa[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_set(ps));
      if (++ps == kSets) {
        ps = 0;
        pph ^= 1;
      }
#pragma unroll
      for (int i = 0; i < kF32BN / 2; ++i) acc[i] += part[i];
    }
    const int rg = row0 + wg * 64 + warp * 16 + g;
    const size_t bbase = (size_t)b * o.m * o.n;
    if (o.bf16 && o.n % 8) {
      store_pairs<kEpi>(o, bbase, rg, col0, acc, q);
    } else if constexpr (kEpilogue) {
      // this thread's pieces lie in row g + 8 (q & 1); their first bias
      // and residual loaded after the last wait (before it, beside the
      // slice's products and A fragments, the consumers spilled)
      EpiBuf epi;
      const int row = rg + 8 * (q & 1);
      if (o.bf16) {
        epi_first<8>(epi, o, row, col0, q);
        store_bf16x8<kF32BN, kEpi>(o, bbase, row, col0, acc, q, epi);
      } else {
        epi_first<4>(epi, o, row, col0, q);
        store_f32x4<kF32BN, kEpi>(o, bbase, row, col0, acc, q, epi);
      }
    } else if (o.bf16) {  // this thread's pieces lie in row g + 8 (q & 1)
      store_bf16x8<kF32BN>(o, bbase, rg + 8 * (q & 1), col0, acc, q);
    } else {
      store_f32x4<kF32BN>(o, bbase, rg + 8 * (q & 1), col0, acc, q);
    }
  }
}

// Launches instance kEpi on a grid of min(tiles, sms) blocks; returns a
// CUDA error code (the shared-memory attribute's, cudaErrorInvalidValue
// where a map cannot be encoded, else cudaGetLastError() after the launch).
template <int kEpi>
int launch_f32(const void* a, const void* b, const Out& o, int batch, int k,
               int sms, cudaStream_t stream) {
  const auto kernel = &gemm_f32_sm90_kernel<kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap am, bm;
  if (!encode_tiled(&am, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, k, o.m, batch, kBM) ||
      !encode_tiled(&bm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, o.n, k, batch, kBK32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles =
      (long long)batch * ((o.m + kBM - 1) / kBM) * ((o.n + kF32BN - 1) / kF32BN);
  const long long grid = tiles > sms ? sms : tiles;
  kernel<<<static_cast<unsigned>(grid), kThreads, kF32Bytes, stream>>>(
      am, bm, o, k, batch);
  return static_cast<int>(cudaGetLastError());
}

// C = A @ B for a [batch, m, k] and b [batch, k, n] f32, contiguous, k > 0,
// k and n multiples of 4, 16-byte-aligned bases, into o (bf16 or f32) on
// `stream`, through the fused epilogue where `epilogue` (as launch_gemm's);
// gemm_f32_sm90.cu builds it. A CUDA error code.
int launch_gemm_f32(const void* a, const void* b, const Out& o, int batch,
                    int k, int epilogue, cudaStream_t stream);

}  // namespace fkp_gemm_sm90
