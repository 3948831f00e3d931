// The softmax-epilogue GEMM's wgmma instances (gemm_softmax_sm90.cuh), in
// an nvcc process of their own; gemm_softmax.cu's entries launch them.

#include "gemm_softmax_sm90.cuh"

namespace fkp_gemm_softmax_sm90 {

namespace {

template <int kBN, bool kResident>
int launch_instance(const CUtensorMap& am, const CUtensorMap& bm,
                    const float* bias, const Out& o, float* tile_max,
                    int* witness, const int* gate, int batch, int k,
                    float scale_log2, int sms, cudaStream_t stream) {
  const auto kernel = &gemm_softmax_sm90_kernel<kBN, kResident>;
  constexpr int kBytes = Layout<kBN>::kBytes + kStaging;  // the ring, C's boxes
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap cm;  // C's boxes, unswizzled, as the rescalers stage them
  const bool bf16 = o.bf16 != 0;
  if (!encode_tiled(&cm, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    bf16 ? 2 : 4, o.c, o.n, o.m, batch, c_rows(kBN, bf16), kBN,
                    CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a cluster of two a band, as many clusters as the card holds at once (a
  // cluster beyond them would start only when another had walked all its
  // bands); the count is read once an instance
  static int clusters = 0;
  if (clusters == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * (sms / 2));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kBytes;
    int fit = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    clusters = fit > 0 && fit < sms / 2 ? fit : sms / 2;
  }
  const long long bands = (long long)batch * ((o.m + kBM - 1) / kBM);
  const long long grid = 2 * (bands > clusters ? clusters : bands);
  kernel<<<static_cast<unsigned>(grid), kThreads, kBytes, stream>>>(
      am, bm, cm, o, bias, tile_max, witness, gate, k, batch, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_softmax(const void* a, const void* b, const float* bias,
                   const Out& o, float* tile_max, int* witness,
                   const int* gate, int batch, int k, float scale_log2,
                   bool resident, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  CUtensorMap am, bm;
  if (!encode_ab(&am, &bm, a, b, o, batch, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool wide = band_tile_n(batch, o.m, o.n, sms) == 256;
  const auto args = [&](auto launch) {
    return launch(am, bm, bias, o, tile_max, witness, gate, batch, k,
                  scale_log2, sms, stream);
  };
  if (resident) {
    return wide ? args(launch_instance<256, true>) : args(launch_instance<128, true>);
  }
  return wide ? args(launch_instance<256, false>) : args(launch_instance<128, false>);
}

}  // namespace fkp_gemm_softmax_sm90

// The column width of the tiles the softmax epilogue's wgmma kernel takes
// for a call of this shape on the current device (128 or 256), or -1 where
// the device cannot be read.
extern "C" int fkp_gemm_softmax_sm90_tile_n(int batch, int m, int n) {
  int sms = 0;
  if (fkp_gemm_sm90::sm_count(&sms) != 0) return -1;
  return fkp_gemm_softmax_sm90::band_tile_n(batch, m, n, sms);
}
