// The paged decode's slots = 3 instances (paged_decode.cuh: 8 keys a
// thread group in flight), compiled apart from paged_decode.cu so that nvcc
// builds the gather's depths in parallel.

#include "paged_decode.cuh"

namespace fkp_paged {
template int launch<8>(const Args&);
}  // namespace fkp_paged
