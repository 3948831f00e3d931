// The paged decode's bf16 instances at ring depths 3 and 4 (the deeper
// gathers of `slots`; d in {64, 128}: 4), compiled apart from
// paged_decode.cu so that nvcc builds them in parallel. The kernel and what
// it replaces: paged_decode.cu and paged_extend_sm90.cuh.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {

int decode_bf16_deep(int depth, int d, const Params& p, const void* k_pages,
                     const void* v_pages, int n_pages, int b, int* counters,
                     cudaStream_t stream) {
  switch (depth) {
    case 3: return launch_decode<__nv_bfloat16, 3, kAttend>(
        d, p, k_pages, v_pages, n_pages, b, counters, stream);
    case 4: return launch_decode<__nv_bfloat16, 4, kAttend>(
        d, p, k_pages, v_pages, n_pages, b, counters, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fkp_ext90
