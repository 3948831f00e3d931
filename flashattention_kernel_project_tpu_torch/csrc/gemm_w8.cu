// The weight-only 8-bit GEMM for Hopper (sm_90a): out = (bf16(x) @ w_q) *
// w_scale[col], x [M, K] bf16, w_q [K, N] int8 or e4m3, w_scale [1, N] f32,
// the sum in f32 and one rounding to the output type. Since the wgmma
// kernel (gemm_w8_sm90.cu) takes every aligned call, this mma.sync kernel
// takes the calls ops/quant.py::w8_path does not send there (K or N off
// 16-byte rows, an offset base, K = 0), so it reads element by element.
//
// Replaces flashattention_kernel_project_tpu/ops/quant.py::_matmul_w8_kernel
// (matmul_int8_weights, :133; matmul_fp8_weights, :193). The TPU kernel
// widens an int8 tile to bf16 in VMEM (an e4m3 tile it feeds to the dot,
// which promotes it) and applies the scale on the f32 accumulator at the
// last K step. Here the block is the bf16 tile of gemm_core.cuh: the 8-bit
// [k][n] slice of w_q goes to a byte staging slice, two stages, and is
// widened exactly into the core's bf16 B stage once it has landed;
// the bf16 mma.sync products run unchanged and the scale multiplies the f32
// accumulator in the epilogue. The products stay bf16: x is bf16, so an fp8
// tensor-core product would compute another function (and mma.sync takes
// e4m3 operands only on sm_89; Hopper's fp8 rate is wgmma's).
//
// What bounds it on the H100: at the ladder's 4096^3 the function does
// 2*M*N*K operations against 2*M*K + K*N + 4*N + 2*M*N bytes, far above the
// ridge, so the bf16 tensor-core rate bounds it (0.139 ms at 989 TFLOP/s);
// the halved weight bytes matter at decode shapes (M = 8), where the bytes
// bound it. The widening costs one shared-memory pass a slice and a barrier.

#include "gemm_core.cuh"

namespace {

using namespace fkp_gemm_core;

template <class TB>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_q_kernel(const __nv_bfloat16* x, const TB* w, Out o, int k) {
  __shared__ SmemBf16 s;
  __shared__ Stage8 b8;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  float acc[4][4][4];
  tile_bf16<false, TB>(acc, s, x, w, row0, col0, o.m, o.n, k, &b8);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + (warp / 4) * 64 + lane / 4;
  const int c0 = col0 + (warp % 4) * 32 + (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      store2<kScale>(o, 0, r0 + i * 16, c0 + j * 8, acc[i][j][0], acc[i][j][1]);
      store2<kScale>(o, 0, r0 + i * 16 + 8, c0 + j * 8, acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <class TB>
int launch(const void* x, const void* w, const Out& o, int k, cudaStream_t stream) {
  const dim3 grid((o.n + kBN - 1) / kBN, (o.m + kBM - 1) / kBM);
  gemm_q_kernel<TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const TB*>(w), o, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [m, k] bf16, w [k, n] int8 (fp8 == 0) or e4m3 (fp8 == 1), w_scale [n]
// f32, all contiguous, any m, n, k and bases; c [m, n] bf16 (bf16_out) or
// f32. Returns cudaGetLastError() after the launch.
extern "C" int fkp_gemm_w8(const void* x, const void* w, const void* w_scale,
                           void* c, int m, int n, int k, int fp8, int bf16_out,
                           void* stream) {
  const Out o{c, nullptr, nullptr, m, n, bf16_out, nullptr,
              static_cast<const float*>(w_scale)};
  const auto s = static_cast<cudaStream_t>(stream);
  return fp8 ? launch<__nv_fp8_e4m3>(x, w, o, k, s) : launch<int8_t>(x, w, o, k, s);
}
