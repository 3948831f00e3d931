// The int8 hybrid ("auto") instances of the dense 8-bit forward
// (flash_fwd_sm90.cuh's block body over 64-key byte tiles widened to
// bf16); flash_fwd_q.cu's entry launches them.

#include "flash_fwd_sm90.cuh"

int fkp_sm90::launch_q_int8_hybrid(int d, const FwdArgs& a) {
  return launch_q_disc<int8_t, fkp_fwd::kHybrid>(d, a);
}
