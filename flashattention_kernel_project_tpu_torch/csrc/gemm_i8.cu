// The int8 x int8 GEMM for Hopper (sm_90a): out = (f32(a_q @ b_q) *
// a_scale[row]) * b_scale[col], a_q [M, K] and b_q [K, N] int8, the sum
// exact in int32, a_scale [M, 1] and b_scale [1, N] f32, one rounding to the
// output type. Since the wgmma kernel (gemm_i8_sm90.cu) takes every
// aligned call, this mma.sync kernel takes the calls
// ops/quant.py::i8_path does not send there (K or N not a multiple of 16,
// an offset base, K = 0), so it reads element by element.
//
// Replaces flashattention_kernel_project_tpu/ops/quant.py::_matmul_i8_kernel
// (matmul_int8, :289): the TPU kernel sums int8 MXU products into an int32
// VMEM accumulator over a sequential K grid axis and dequantizes in the
// epilogue. Here a block computes one 128 x 128 tile of C with 256 threads,
// as the bf16 core (gemm_core.cuh) does, on mma.sync m16n8k32 s8 x s8 ->
// s32: each warp owns 64 x 32 of the tile, 4 x 4 products a 32-deep step,
// the int32 accumulators in registers.
//
// B's layout is the work: the instruction wants each thread's 4 B bytes
// consecutive along K, and ldmatrix.trans moves 16-bit elements only, so it
// cannot transpose an int8 tile. B's 64-deep [k][n] slice is therefore read
// into registers (4 rows of 8 bytes a thread, issued before the products of
// the slice in shared memory, so the loads run under them), transposed 4 x
// 4 bytes at a time with byte permutes, and stored [n][k]. A's slice goes
// to the other of two stages. Both lie in shared memory as [row][k] with rows of
// 64 + 16 bytes, the bf16 core's 80-byte rows, so a plain ldmatrix (b16)
// loads both fragments (mma.cuh: the int8 layouts are the bf16 ones in
// bytes) without bank conflicts. K is zero-filled to the next 64.
//
// What bounds it on the H100: at the ladder's 4096^3 the function does
// 2*M*N*K operations against M*K + K*N + 4*(M + N) + M*N*out bytes, far
// above the ridge, so the int8 tensor-core rate bounds it (1,979 TOP/s,
// 0.069 ms); mma.sync reaches part of that peak.

#include "gemm_core.cuh"

namespace {

using fkp_gemm_core::kBM;
using fkp_gemm_core::kBN;
using fkp_gemm_core::kScale;
using fkp_gemm_core::kThreads;
using fkp_gemm_core::Out;
using fkp_gemm_core::store2;
using fkp_mma::transpose4;

constexpr int kBK = 64;            // int8 depth of a slice
constexpr int kStride = kBK + 16;  // bytes a row in shared memory
struct __align__(16) SmemI8 {
  int8_t a[2][kBM * kStride];  // [m][k]
  int8_t b[2][kBN * kStride];  // [n][k]: B transposed
};

// A's [kBM x kBK] slice at (row0, k0) into stage st, zero outside [m) x [k)
__device__ __forceinline__ void load_a(SmemI8& s, int st, const int8_t* a, int row0,
                                       int k0, int m, int k) {
  constexpr int kPieces = kBK / 16;
  for (int i = threadIdx.x; i < kBM * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i % kPieces) * 16;
    const int gr = row0 + r, gc = k0 + c;
    int8_t* dst = &s.a[st][r * kStride + c];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      dst[j] = gr < m && gc + j < k ? a[(size_t)gr * k + gc + j] : int8_t{0};
    }
  }
}

// This thread's piece of B's [kBK x kBN] slice at (k0, col0): rows k0 + 4 *
// (tid % 16) + r (r < 4), columns col0 + 8 * (tid / 16) + 0..7, as two
// words a row (bytes in column order), zero outside [k) x [n).
__device__ __forceinline__ void load_b(uint32_t (&w)[4][2], const int8_t* b,
                                       int k0, int col0, int n, int k) {
  const int kr = k0 + 4 * (threadIdx.x % 16), gc = col0 + 8 * (threadIdx.x / 16);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = kr + r;
    uint32_t v[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (gr < k && gc + j < n) {
        v[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(b[(size_t)gr * n + gc + j]))
                    << (8 * (j % 4));
      }
    }
    w[r][0] = v[0];
    w[r][1] = v[1];
  }
}

// the piece of load_b transposed into stage st: column c of the piece
// becomes 4 consecutive k bytes of B^T's row col0 + 8 * (tid / 16) + c
__device__ __forceinline__ void store_b(SmemI8& s, int st, const uint32_t (&w)[4][2]) {
  const int kc = 4 * (threadIdx.x % 16), nr = 8 * (threadIdx.x / 16);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t rows[4] = {w[0][h], w[1][h], w[2][h], w[3][h]};
    uint32_t cols[4];
    transpose4(rows, cols);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<uint32_t*>(&s.b[st][(nr + 4 * h + c) * kStride + kc]) = cols[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    gemm_qq_kernel(const int8_t* a, const int8_t* b, Out o, int k) {
  __shared__ SmemI8 s;
  const int m = o.m, n = o.n;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  const int n_k = (k + kBK - 1) / kBK;
  uint32_t wb[4][2];
  load_a(s, 0, a, row0, 0, m, k);
  load_b(wb, b, 0, col0, n, k);
  store_b(s, 0, wb);
  for (int t = 0; t < n_k; ++t) {
    if (t + 1 < n_k) {
      // A's stage (t + 1) & 1 was last read at t - 1, which ended in a barrier
      load_a(s, (t + 1) & 1, a, row0, (t + 1) * kBK, m, k);
      load_b(wb, b, (t + 1) * kBK, col0, n, k);  // in flight below
    }
    __syncthreads();  // A's and B's slice t, stored before this barrier
    // a pair of int8 read as one b16: 16 b16 = one 32-deep step
    const auto* sa = reinterpret_cast<const __nv_bfloat16*>(s.a[t & 1]);
    const auto* sb = reinterpret_cast<const __nv_bfloat16*>(s.b[t & 1]);
#pragma unroll
    for (int kk = 0; kk < kBK / 2; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fkp_mma::load_a(af[i], sa, kStride / 2, wm + i * 16, kk, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        fkp_mma::load_b_nk(bf[j], sb, kStride / 2, wn + j * 16, kk, lane);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          fkp_mma::mma_16832_s8(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          fkp_mma::mma_16832_s8(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
      }
    }
    // B's stage (t + 1) & 1 was last read at t - 1, which ended in a barrier
    if (t + 1 < n_k) store_b(s, (t + 1) & 1, wb);
    __syncthreads();
  }
  const int r0 = row0 + wm + lane / 4;
  const int c0 = col0 + wn + (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store2<kScale>(o, 0, r0 + i * 16, c0 + j * 8, __int2float_rn(acc[i][j][0]),
                     __int2float_rn(acc[i][j][1]));
      store2<kScale>(o, 0, r0 + i * 16 + 8, c0 + j * 8, __int2float_rn(acc[i][j][2]),
                     __int2float_rn(acc[i][j][3]));
    }
  }
}

}  // namespace

// a [m, k], b [k, n] int8, a_scale [m], b_scale [n] f32, all contiguous;
// any m, n, k and bases; c [m, n] bf16 (bf16_out) or f32. Returns
// cudaGetLastError() after the launch.
extern "C" int fkp_gemm_i8(const void* a, const void* b, const void* a_scale,
                           const void* b_scale, void* c, int m, int n, int k,
                           int bf16_out, void* stream) {
  const Out o{c, nullptr, nullptr, m, n, bf16_out,
              static_cast<const float*>(a_scale), static_cast<const float*>(b_scale)};
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_qq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), o, k);
  return static_cast<int>(cudaGetLastError());
}
