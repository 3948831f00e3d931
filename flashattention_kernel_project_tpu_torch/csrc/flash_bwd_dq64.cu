// Kernel B of the attention backward (flash_bwd_dq_sm90.cuh), dQ alone
// (the two-kernel schedule), d = 64, with and without a band, in an nvcc
// process of its own.

#include "flash_bwd_dq_sm90.cuh"

template int fkp_bwd_sm90::launch_dq<64>(const fkp_bwd_sm90::BwdArgs&);
