// Kernel A of the attention backward (flash_bwd_sm90.cuh) for dK, dV and the
// dQ partials (the fused-dq schedule), d = 128, with and without a band, in
// an nvcc process of its own.

#include "flash_bwd_sm90.cuh"

template int fkp_bwd_sm90::launch_dkdv<128, true>(const fkp_bwd_sm90::BwdArgs&);
