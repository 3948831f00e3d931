// The paged decode's 8-bit instances at ring depths 3 and 4 (the deeper
// gathers of `slots`): an int8 or e4m3 pool, d in {64, 128} (8), compiled
// apart from paged_decode.cu so that nvcc builds them in parallel. The
// kernel and what it replaces: paged_decode.cu and paged_extend_sm90.cuh.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {

int decode_8bit_deep(int fp8, int depth, int d, const Params& p,
                     const void* k_pages, const void* v_pages, int n_pages,
                     int b, int* counters, cudaStream_t stream) {
  const auto go = [&](auto depth_c) {
    constexpr int kDepth = decltype(depth_c)::value;
    return fp8 ? launch_decode<__nv_fp8_e4m3, kDepth, kAttend>(
                     d, p, k_pages, v_pages, n_pages, b, counters, stream)
               : launch_decode<int8_t, kDepth, kAttend>(
                     d, p, k_pages, v_pages, n_pages, b, counters, stream);
  };
  switch (depth) {
    case 3: return go(std::integral_constant<int, 3>{});
    case 4: return go(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fkp_ext90
