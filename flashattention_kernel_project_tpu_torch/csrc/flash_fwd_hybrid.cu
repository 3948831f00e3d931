// The hybrid instances (stable="auto") of the dense forward in
// flash_fwd_sm90.cuh; flash_fwd.cu's entry launches them.

#include "flash_fwd_sm90.cuh"

int fkp_sm90::launch_hybrid(int d, const FwdArgs& a) {
  return launch_disc<fkp_fwd::kHybrid>(d, a);
}
