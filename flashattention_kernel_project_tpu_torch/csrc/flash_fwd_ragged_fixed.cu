// The fixed-max instances (stable=False) of the ragged forward's wgmma
// route over a bf16 cache (flash_fwd_sm90.cuh); flash_fwd_ragged.cu's entry
// launches them.

#include "flash_fwd_sm90.cuh"

int fkp_sm90::launch_ragged_fixed(int d, const RaggedArgs& a) {
  return launch_ragged_disc<__nv_bfloat16, fkp_fwd::kFixed>(d, a);
}
