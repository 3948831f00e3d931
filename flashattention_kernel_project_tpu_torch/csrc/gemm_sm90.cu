// The bf16 GEMM's wgmma instances (gemm_sm90.cuh): tiles of 128 x 256 and
// 128 x 128, plain and with the fused epilogue, in an nvcc process of
// their own; gemm.cu's fkp_gemm launches them.

#include "gemm_sm90.cuh"

namespace fkp_gemm_sm90 {

int launch_gemm(const void* a, const void* b, const Out& o, int batch, int k,
                int epilogue, cudaStream_t stream) {
  using fkp_gemm_core::kBiasRelu;
  using fkp_gemm_core::kPlain;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  if (tile_n(batch, o.m, o.n, sms) == 128) {
    return epilogue ? launch<128, kBiasRelu>(a, b, o, batch, k, sms, stream)
                    : launch<128, kPlain>(a, b, o, batch, k, sms, stream);
  }
  return epilogue ? launch<256, kBiasRelu>(a, b, o, batch, k, sms, stream)
                  : launch<256, kPlain>(a, b, o, batch, k, sms, stream);
}

}  // namespace fkp_gemm_sm90

// The column width of the tiles fkp_gemm's bf16 wgmma path takes for a
// call of this shape on the current device (128 or 256), or -1 where the
// device cannot be read (the f32 one always takes 128).
extern "C" int fkp_gemm_sm90_tile_n(int batch, int m, int n) {
  int sms = 0;
  if (fkp_gemm_sm90::sm_count(&sms) != 0) return -1;
  return fkp_gemm_sm90::tile_n(batch, m, n, sms);
}
