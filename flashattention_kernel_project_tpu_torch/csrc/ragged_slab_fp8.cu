// The e4m3 instances of the ragged forward's slab route
// (paged_extend_sm90.cuh's block over a linear cache): d in {64, 128} x 16,
// 32 or 64 folded rows a block x the plain and the general call (12), in a
// source of their own so that they build beside the bf16 and int8 ones.
// The C entry fkp_ragged_slab is ragged_slab.cu's.

#include "paged_extend_sm90.cuh"

namespace fkp_ext90 {

int linear_e4m3(int d, int block_rows, const Params& p, const void* k,
                const void* v, int b, int* counters, cudaStream_t stream) {
  return launch_linear_any<__nv_fp8_e4m3>(d, block_rows, p, k, v, b, counters,
                                          stream);
}

}  // namespace fkp_ext90
