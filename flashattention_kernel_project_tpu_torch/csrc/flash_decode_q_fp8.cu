// The e4m3 instances of the 8-bit linear decode (kernel 7,
// flash_decode_sm90.cuh's 8-bit kernel: d in {64, 128} x G in {1, 2, 4, 8}
// x with and without a window: 16); flash_decode_q.cu's entries launch
// them.

#include "flash_decode_sm90.cuh"

int fkp_dec90::launch_e4m3(int d, int g, const Params& p, const void* k,
                           const void* v, int b, int* counters,
                           cudaStream_t stream) {
  return launch_q_any<__nv_fp8_e4m3>(d, g, p, k, v, b, counters, stream);
}
