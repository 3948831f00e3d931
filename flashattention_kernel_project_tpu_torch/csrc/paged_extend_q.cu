// The 8-bit instances of the paged extend (paged_extend_sm90.cuh): an int8
// or e4m3 pool, d in {64, 128} x 16, 32 or 64 folded rows a block (12), in
// a source of their own so that they build beside the bf16 ones. The C
// entry fkp_paged_extend_q is paged_extend.cu's.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {

int launch_8bit(int fp8, int d, int block_rows, const Params& p,
                const void* k_pages, const void* v_pages, int n_pages, int b,
                int* counters, cudaStream_t stream) {
  return fp8 ? launch_any<__nv_fp8_e4m3>(d, block_rows, p, k_pages, v_pages,
                                         n_pages, b, counters, stream)
             : launch_any<int8_t>(d, block_rows, p, k_pages, v_pages, n_pages,
                                  b, counters, stream);
}

}  // namespace fkp_ext90
