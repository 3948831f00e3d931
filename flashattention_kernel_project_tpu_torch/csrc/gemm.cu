// The GEMM ladder's products for Hopper (sm_90a): C = A @ B with f32
// accumulation, over an optional leading batch, with an optional fused
// epilogue C = ReLU(A @ B + bias[col]) + residual.
//
// Replaces flashattention_kernel_project_tpu/ops/gemm.py::_matmul_kernel
// (matmul, matmul_bf16), _batched_matmul_kernel (batched_matmul: the batch
// on blockIdx.z with strides, as the TPU's leading parallel grid axis) and
// _fused_epilogue_kernel (matmul_fused_epilogue: the epilogue in f32 on the
// accumulator before the single store). The TPU kernels walk K on a
// sequential grid axis into a VMEM accumulator; here a block keeps its
// accumulator in registers and loops over K itself. fkp_gemm takes one of
// three kernels by the call's path (ops/gemm.py::gemm_path), every call
// with aligned operands (K and N multiples of 16 bytes' worth of elements,
// 16-byte bases) and K > 0 on wgmma, with or without the epilogue: two
// bf16 operands go to gemm_sm90.cuh (built in gemm_sm90.cu), two f32
// operands to gemm_f32_sm90.cuh (built in gemm_f32_sm90.cu: JAX's six-pass
// bf16 product for f32 at Precision.HIGHEST), each with the epilogue a
// template switch of its 16-byte stores. Unaligned shapes and K = 0 go to
// gemm_kernel below, on gemm_core.cuh's mma.sync (bf16) and FFMA (f32)
// tiles of 128 x 128, the epilogue a template switch of store2.

#include "gemm_core.cuh"
#include "gemm_sm90.cuh"

namespace fkp_gemm_sm90 {
// the f32 wgmma kernel's launch (gemm_f32_sm90.cuh, built in
// gemm_f32_sm90.cu, whose kernel must be defined in one object only)
int launch_gemm_f32(const void* a, const void* b, const Out& o, int batch,
                    int k, int epilogue, cudaStream_t stream);
}  // namespace fkp_gemm_sm90

namespace {

using namespace fkp_gemm_core;

// two blocks an SM: at most 128 registers a thread (without the bound the
// aligned f32 instance took 149 and ran one block an SM)
template <class T, bool kEpi, bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const T* a, const T* b, Out o, int k) {
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  a += (size_t)blockIdx.z * o.m * k;
  b += (size_t)blockIdx.z * k * o.n;
  const size_t base = (size_t)blockIdx.z * o.m * o.n;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    __shared__ SmemBf16 s;
    float acc[4][4][4];
    tile_bf16<kAligned>(acc, s, a, b, row0, col0, o.m, o.n, k);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = row0 + (warp / 4) * 64 + lane / 4;
    const int c0 = col0 + (warp % 4) * 32 + (lane % 4) * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        store2<kEpi ? kBiasRelu : kPlain>(o, base, r0 + i * 16, c0 + j * 8, acc[i][j][0], acc[i][j][1]);
        store2<kEpi ? kBiasRelu : kPlain>(o, base, r0 + i * 16 + 8, c0 + j * 8, acc[i][j][2], acc[i][j][3]);
      }
    }
  } else {
    __shared__ SmemF32 s;
    float acc[8][8];
    tile_f32<kAligned>(acc, s, a, b, row0, col0, o.m, o.n, k);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row0 + (r / 4) * 64 + ty * 4 + r % 4;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = col0 + q * 64 + tx * 4;
        store2<kEpi ? kBiasRelu : kPlain>(o, base, row, col, acc[r][q * 4], acc[r][q * 4 + 1]);
        store2<kEpi ? kBiasRelu : kPlain>(o, base, row, col + 2, acc[r][q * 4 + 2], acc[r][q * 4 + 3]);
      }
    }
  }
}

template <class T, bool kEpi>
int launch(const void* a, const void* b, const Out& o, int batch, int k,
           int aligned, cudaStream_t stream) {
  const dim3 grid((o.n + kBN - 1) / kBN, (o.m + kBM - 1) / kBM, batch);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (aligned) {
    gemm_kernel<T, kEpi, true><<<grid, kThreads, 0, stream>>>(ta, tb, o, k);
  } else {
    gemm_kernel<T, kEpi, false><<<grid, kThreads, 0, stream>>>(ta, tb, o, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [batch, m, k], b [batch, k, n] contiguous, both bf16 (bf16_in) or both
// f32; c [batch, m, n] bf16 (bf16_out) or f32. epilogue: bias f32 [n] and
// residual f32 [m, n] (batch 1; on paths 2 and 3 both 16-byte aligned),
// else both may be null. path: 0 reads element by element (any shape); 1
// copies 16-byte pieces (k and n multiples of 8 (bf16) or 4 (f32)
// elements, a and b 16-byte aligned); 2 the bf16 wgmma kernel
// (gemm_sm90.cuh: path 1's alignment, bf16 operands, k > 0); 3 the f32
// wgmma kernel (gemm_f32_sm90.cuh: path 1's alignment, f32 operands, k >
// 0); cudaErrorInvalidValue for a call a wgmma path does not take. Returns
// cudaGetLastError() after the launch, or the wgmma launch's error code.
extern "C" int fkp_gemm(const void* a, const void* b, void* c,
                        const void* bias, const void* residual, int batch,
                        int m, int n, int k, int bf16_in, int bf16_out,
                        int epilogue, int path, void* stream) {
  const Out o{c, static_cast<const float*>(bias),
              static_cast<const float*>(residual), m, n, bf16_out};
  const auto s = static_cast<cudaStream_t>(stream);
  if (path == 2 || path == 3) {
    const auto misaligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 != 0;
    };
    if (bf16_in != (path == 2) || k <= 0 ||
        (epilogue && (batch != 1 || misaligned(bias) || misaligned(residual)))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return path == 2
               ? fkp_gemm_sm90::launch_gemm(a, b, o, batch, k, epilogue, s)
               : fkp_gemm_sm90::launch_gemm_f32(a, b, o, batch, k, epilogue, s);
  }
  const int aligned = path;
  if (bf16_in) {
    return epilogue ? launch<__nv_bfloat16, true>(a, b, o, batch, k, aligned, s)
                    : launch<__nv_bfloat16, false>(a, b, o, batch, k, aligned, s);
  }
  return epilogue ? launch<float, true>(a, b, o, batch, k, aligned, s)
                  : launch<float, false>(a, b, o, batch, k, aligned, s);
}
