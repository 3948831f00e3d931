// The e4m3 instances of the ragged forward's wgmma route
// (flash_fwd_sm90.cuh: 64-key byte tiles widened to bf16 by the producer
// warpgroup), online and fixed-max; flash_fwd_ragged.cu's entry launches
// them.

#include "flash_fwd_sm90.cuh"

int fkp_sm90::launch_ragged_e4m3(int d, int disc, const RaggedArgs& a) {
  return disc == fkp_fwd::kFixed
             ? launch_ragged_disc<__nv_fp8_e4m3, fkp_fwd::kFixed>(d, a)
             : launch_ragged_disc<__nv_fp8_e4m3, fkp_fwd::kOnline>(d, a);
}
