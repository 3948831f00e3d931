// Kernel A of the attention backward (flash_bwd_sm90.cuh) for dK and dV (the
// two-kernel schedule), d = 64, with and without a band, in an nvcc process
// of its own.

#include "flash_bwd_sm90.cuh"

template int fkp_bwd_sm90::launch_dkdv<64, false>(const fkp_bwd_sm90::BwdArgs&);
