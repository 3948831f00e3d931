// The f32 GEMM's wgmma kernel (gemm_f32_sm90.cuh), plain and with the
// fused epilogue, in an nvcc process of its own; gemm.cu's fkp_gemm
// launches it.

#include "gemm_f32_sm90.cuh"

namespace fkp_gemm_sm90 {

int launch_gemm_f32(const void* a, const void* b, const Out& o, int batch,
                    int k, int epilogue, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  return epilogue ? launch_f32<fkp_gemm_core::kBiasRelu>(a, b, o, batch, k, sms, stream)
                  : launch_f32<fkp_gemm_core::kPlain>(a, b, o, batch, k, sms, stream);
}

}  // namespace fkp_gemm_sm90
