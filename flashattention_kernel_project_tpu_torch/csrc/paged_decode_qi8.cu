// The paged decode's int8 score product (paged_flash_decode_quant(
// q_int8=True) over an int8 pool; JAX's _paged_gather_kernel_q q_int8
// branch, paged_decode.py:915-928): d in {64, 128} at ring depths 2, 3 and
// 4 (6), compiled apart from paged_decode.cu so that nvcc builds them in
// parallel. The kernel and its bound: paged_decode.cu and
// paged_extend_sm90.cuh (kQInt8).

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {

int decode_qi8(int depth, int d, const Params& p, const void* k_pages,
               const void* v_pages, int n_pages, int b, int* counters,
               cudaStream_t stream) {
  switch (depth) {
    case 2: return launch_decode<int8_t, 2, kQInt8>(d, p, k_pages, v_pages,
                                                    n_pages, b, counters, stream);
    case 3: return launch_decode<int8_t, 3, kQInt8>(d, p, k_pages, v_pages,
                                                    n_pages, b, counters, stream);
    case 4: return launch_decode<int8_t, 4, kQInt8>(d, p, k_pages, v_pages,
                                                    n_pages, b, counters, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fkp_ext90
