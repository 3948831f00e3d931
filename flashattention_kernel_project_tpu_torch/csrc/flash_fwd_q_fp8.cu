// The e4m3 online instances of the dense 8-bit forward (flash_fwd_sm90.cuh's
// block body over 64-key byte tiles widened to bf16); flash_fwd_q.cu's
// entry launches them.

#include "flash_fwd_sm90.cuh"

int fkp_sm90::launch_q_e4m3(int d, const FwdArgs& a) {
  return launch_q_disc<__nv_fp8_e4m3, fkp_fwd::kOnline>(d, a);
}
