// The paged decode's 8-bit instances at the ring depth of every serving
// path (2): an int8 or e4m3 pool, d in {64, 128} (4), compiled apart from
// paged_decode.cu so that nvcc builds them in parallel. The kernel and what
// it replaces: paged_decode.cu and paged_extend_sm90.cuh.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {

int decode_8bit(int fp8, int d, const Params& p, const void* k_pages,
                const void* v_pages, int n_pages, int b, int* counters,
                cudaStream_t stream) {
  return fp8 ? launch_decode<__nv_fp8_e4m3, 2, kAttend>(
                   d, p, k_pages, v_pages, n_pages, b, counters, stream)
             : launch_decode<int8_t, 2, kAttend>(d, p, k_pages, v_pages,
                                                 n_pages, b, counters, stream);
}

}  // namespace fkp_ext90
