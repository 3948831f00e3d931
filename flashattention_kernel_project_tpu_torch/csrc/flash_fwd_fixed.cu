// The fixed-max instances (stable=False) of the dense forward in
// flash_fwd_sm90.cuh, with the range guard; flash_fwd.cu's entry launches
// them. Kernel 2's counterpart (_fwd_kernel_packed) is the d=64 one.

#include "flash_fwd_sm90.cuh"

int fkp_sm90::launch_fixed(int d, const FwdArgs& a) {
  return launch_disc<fkp_fwd::kFixed>(d, a);
}
