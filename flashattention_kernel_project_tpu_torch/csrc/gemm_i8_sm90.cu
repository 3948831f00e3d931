// The int8 x int8 GEMM for Hopper (sm_90a) on wgmma: out = (f32(a_q @
// b_q) * a_scale[row]) * b_scale[col], a_q [M, K] and b_q [K, N] int8, the
// sum exact in int32, a_scale [M, 1] and b_scale [1, N] f32, one rounding
// to the output type. ops/quant.py::matmul_int8 launches it for every call
// that `i8_path` calls aligned (K > 0, K and N multiples of 16, 16-byte
// bases); the other calls keep gemm_i8.cu's mma.sync kernel.
//
// Replaces flashattention_kernel_project_tpu/ops/quant.py::_matmul_i8_kernel
// (matmul_int8, :289) on those calls: the TPU kernel sums int8 MXU products
// into an int32 VMEM accumulator over a sequential K grid axis and
// dequantizes in the epilogue, in this order.
//
// B's layout is the work: wgmma takes 8-bit operands K-major only (its
// imm-trans is for 16-bit types), and b_q is [K, N] row-major, as JAX takes
// it. So a call is two launches:
// - transpose_i8_kernel writes B^T [N, K] into a workspace the wrapper
//   allocates (a 128 x 128 byte tile a block: 16-byte loads along N, 4 x 4
//   byte transposes in registers (mma.cuh::transpose4), words into a
//   shared-memory tile whose 4-word groups are XOR-swizzled by the row's
//   16-row group, so that both its stores and its 16-byte reads are
//   conflict-free, then 16-byte stores along K). It moves 2 * K * N bytes,
//   0.01 ms at 4096^2; nothing is kept across calls.
// - gemm_i8_sm90_kernel is gemm_sm90.cuh's skeleton with int8 products: the
//   same Ring and Layout (a stage is A's box of 128 rows x 128 bytes and
//   B^T's kBN rows x 128 bytes, both K-major and 128B-swizzled, 16 KB +
//   kBN * 128), a producer thread of its own warpgroup issuing the TMA
//   loads (a 128-deep slice a stage; boxes of B^T wholly past N not
//   loaded), the persistent tile order of tile_at, two consumer warpgroups
//   of 64 rows on wgmma m64nNk32 s8 x s8 -> s32 (N = 256, or 128 where the
//   128 x 256 grid fills at most half the SMs, tile_n), one slice's
//   products in flight while the next is issued, and the 16-byte stores.
//   The epilogue converts each int32 sum by __int2float_rn, multiplies by
//   the row scale, then by the column scale (__fmul_rn, as the plain
//   version's steps) and rounds once: bit-equal to _matmul_i8_plain.
//
// What bounds it on the H100: at the ladder's 4096^3 the function does
// 2*M*N*K operations against M*K + K*N + 4*(M + N) + M*N*out bytes, far
// above the ridge: the int8 tensor-core rate (1,979 TOP/s, 0.069 ms). The
// transposing pass adds 2*K*N bytes (0.0100 ms at 3.35 TB/s).

#include "gemm_sm90.cuh"
#include "mma.cuh"

namespace fkp_i8_sm90 {

using namespace fkp_gemm_sm90;

constexpr int kBK8 = 128;  // K a stage: one 128-byte box row of int8
constexpr int kT = 128;    // the transposing pass's tile: 128 x 128 bytes
constexpr int kBtRows = kBoxB / 128;  // rows of n in a box of B^T: 64

__global__ void __launch_bounds__(256)
    transpose_i8_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt,
                        int k, int n) {
  // [n][k / 4] words of the tile; word group (4 words) g of row r at
  // g ^ ((r >> 4) & 7)
  __shared__ __align__(16) uint32_t s[kT][kT / 4];
  const int k0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  const int t = threadIdx.x;
  // thread t: k-rows 4 (t / 8) .. + 3 of the tile, columns 16 (t % 8) .. + 15
  const int kw = t / 8, c16 = t % 8;
  uint4 rows[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gk = k0 + 4 * kw + r, gn = n0 + 16 * c16;
    rows[r] = gk < k && gn < n
                  ? *reinterpret_cast<const uint4*>(b + (size_t)gk * n + gn)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) {  // columns 16 c16 + 4 w .. + 3
    const uint32_t in[4] = {(&rows[0].x)[w], (&rows[1].x)[w], (&rows[2].x)[w],
                            (&rows[3].x)[w]};
    uint32_t out[4];
    fkp_mma::transpose4(in, out);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = 16 * c16 + 4 * w + c;
      s[row][kw ^ (4 * ((row >> 4) & 7))] = out[c];
    }
  }
  __syncthreads();
  // thread t: rows t / 8 + 32 j of B^T's tile, k bytes 16 (t % 8) .. + 15
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = t / 8 + 32 * j;
    const int gn = n0 + row, gk = k0 + 16 * (t % 8);
    if (gn < n && gk < k) {
      const int g = (t % 8) ^ ((row >> 4) & 7);
      *reinterpret_cast<uint4*>(bt + (size_t)gn * k + gk) =
          *reinterpret_cast<const uint4*>(&s[row][4 * g]);
    }
  }
}

// D[64 x 256] (+)= A[64 x 32] * B[32 x 256], int8 (s8) operands in shared
// memory by descriptor, both K-major, int32 accumulators (exact);
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_i8_n256(int (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 32] * B[32 x 128], int8 (s8) operands in shared
// memory by descriptor, both K-major, int32 accumulators (exact);
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_i8_n128(int (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kBN>
__device__ __forceinline__ void wgmma_i8(int (&d)[kBN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (kBN == 256) {
    wgmma_i8_n256(d, da, db, 1);
  } else {
    wgmma_i8_n128(d, da, db, 1);
  }
}

// The producer thread's loads for one tile of C: A's box (128 rows x 128
// bytes of k) and B^T's boxes (64 rows of n x 128 bytes of k each, one box
// apart, so that together they are one K-major tile of kBN rows) that hold
// a row below n, a 128-deep slice a stage, n_k slices. The probes as
// load_tile's.
template <int kBN>
__device__ __forceinline__ void load_tile_i8(Ring<kBN>& r, const CUtensorMap* a_map,
                                             const CUtensorMap* bt_map, int row0,
                                             int col0, int n, int n_k, bool first) {
  using L = Layout<kBN>;
  const int boxes = min(L::kBoxesB, (n - col0 + kBtRows - 1) / kBtRows);
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(r.empty(r.st), r.phase ^ 1);
    if (FKP_GEMM_PROBE == 2 && (r.phase || !first || kt >= L::kStages)) {
      mbar_arrive(r.full(r.st));
    } else {
      mbar_expect_tx(r.full(r.st), kBoxA + boxes * kBoxB);
      tma_load(r.a_s(r.st), a_map, r.full(r.st), kt * kBK8, row0, 0);
      for (int x = 0; x < boxes; ++x) {
        tma_load(r.b_s(r.st) + x * kBoxB, bt_map, r.full(r.st), kt * kBK8,
                 col0 + x * kBtRows, 0);
      }
    }
    r.advance();
  }
}

// A consumer warpgroup's int8 products for one tile, as mma_tile's: 32 of k
// (32 bytes) a step along both operands' swizzled 128-byte rows.
template <int kBN>
__device__ __forceinline__ void mma_tile_i8(Ring<kBN>& r, int (&acc)[kBN / 2],
                                            int wg, int lane, int n_k) {
  const auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty(s));
  };
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  int prev = 0;
  for (int kt = 0; kt < n_k; ++kt) {
    mbar_wait(r.full(r.st), r.phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (FKP_GEMM_PROBE == 1 ? 0 : kBK8 / 32); ++kk) {
      wgmma_i8<kBN>(acc, desc(r.a_s(r.st) + wg * 64 * 128 + kk * 32, 16, 1024),
                    desc(r.b_s(r.st) + kk * 32, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kt > 0) release(prev);
    prev = r.st;
    r.advance();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");
  release(prev);
}

// C [m, n] = dequantized A [m, k] @ B [k, n] through the maps a_map (boxes
// of 128 rows x 128 bytes of k) and bt_map (B^T [n, k], boxes of 64 rows x
// 128 bytes). The first 256 threads are the consumer warpgroups, 64 rows
// of the tile each, the last 128 the producer warpgroup. Block i takes
// tiles i, i + gridDim.x, ...
template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_i8_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap bt_map, Out o, int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * Layout<kBN>::kStages];
  Ring<kBN> ring{(smem_u32(smem_raw) + 1023u) & ~1023u, smem_u32(bars)};
  const int m_tiles = (o.m + kBM - 1) / kBM;
  const int n_tiles = (o.n + kBN - 1) / kBN;
  const int total = m_tiles * n_tiles;
  const int n_k = (k + kBK8 - 1) / kBK8;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    producer_regs();
    if (threadIdx.x == kConsumers) {
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int b, row0, col0;
        tile_at<kBN>(t, m_tiles, n_tiles, b, row0, col0);
        load_tile_i8(ring, &a_map, &bt_map, row0, col0, o.n, n_k, t == blockIdx.x);
      }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int b, row0, col0;
    tile_at<kBN>(t, m_tiles, n_tiles, b, row0, col0);
    int acc[kBN / 2];
    mma_tile_i8(ring, acc, wg, lane, n_k);
    // element 4j + e: row g (e < 2) or g + 8, column col0 + 8j + 2q + (e & 1)
    const int rg = row0 + wg * 64 + warp * 16 + g;
    const float rs0 = rg < o.m ? __ldg(o.row_scale + rg) : 0.f;
    const float rs1 = rg + 8 < o.m ? __ldg(o.row_scale + rg + 8) : 0.f;
    float f[kBN / 2];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col0 + 8 * j + 2 * q;
      const float c0 = col < o.n ? __ldg(o.col_scale + col) : 0.f;
      const float c1 = col < o.n ? __ldg(o.col_scale + col + 1) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[4 * j + e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]),
                                           e < 2 ? rs0 : rs1),
                                 e & 1 ? c1 : c0);
      }
    }
    if (FKP_GEMM_PROBE == 3) {  // keep the products live: one test, no store
      uint32_t bits = 0;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) bits |= __float_as_uint(f[i]);
      if (bits == 0x7fc00001u) static_cast<float*>(o.c)[0] = 0.f;
      continue;
    }
    // this thread's pieces lie in row g + 8 (q & 1) of its warp's 16
    const int row = rg + 8 * (q & 1);
    if (o.bf16) {
      store_bf16x8<kBN>(o, 0, row, col0, f, q);
    } else {
      store_f32x4<kBN>(o, 0, row, col0, f, q);
    }
  }
}

template <int kBN>
int launch_i8(const void* a, const void* bt, const Out& o, int k, int sms,
           cudaStream_t stream) {
  const auto kernel = &gemm_i8_sm90_kernel<kBN>;
  constexpr int kBytes = Layout<kBN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap am, bm;
  if (!encode_tiled(&am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, k, o.m, 1, kBM) ||
      !encode_tiled(&bm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bt, k, o.n, 1, kBtRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (long long)((o.m + kBM - 1) / kBM) * ((o.n + kBN - 1) / kBN);
  const long long grid = tiles > sms ? sms : tiles;
  kernel<<<static_cast<unsigned>(grid), kThreads, kBytes, stream>>>(am, bm, o, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fkp_i8_sm90

// B^T [n, k] = B [k, n], int8, both contiguous, k and n multiples of 16,
// 16-byte-aligned bases. Returns cudaGetLastError() after the launch.
extern "C" int fkp_gemm_i8_transpose(const void* b, void* bt, int k, int n,
                                     void* stream) {
  using fkp_i8_sm90::kT;
  const dim3 grid((n + kT - 1) / kT, (k + kT - 1) / kT);
  fkp_i8_sm90::transpose_i8_kernel<<<grid, 256, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), k, n);
  return static_cast<int>(cudaGetLastError());
}

// a [m, k] and bt = B^T [n, k] int8 (fkp_gemm_i8_transpose's), a_scale [m]
// and b_scale [n] f32, all contiguous, k > 0, k and n multiples of 16,
// 16-byte-aligned bases; c [m, n] bf16 (bf16_out) or f32. A CUDA error code
// (the shared-memory attribute's, cudaErrorInvalidValue where a map cannot
// be encoded, else cudaGetLastError() after the launch).
extern "C" int fkp_gemm_i8_sm90(const void* a, const void* bt, const void* a_scale,
                                const void* b_scale, void* c, int m, int n, int k,
                                int bf16_out, void* stream) {
  using namespace fkp_i8_sm90;
  const Out o{c, nullptr, nullptr, m, n, bf16_out,
              static_cast<const float*>(a_scale), static_cast<const float*>(b_scale)};
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  return tile_n(1, m, n, sms) == 128 ? launch_i8<128>(a, bt, o, k, sms, s)
                                     : launch_i8<256>(a, bt, o, k, sms, s);
}
