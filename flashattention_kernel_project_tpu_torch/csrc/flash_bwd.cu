// The attention backward's C entries: kernel A (flash_bwd_sm90.cuh: dK and
// dV, and with dq_accum the fused-dq schedule's dQ partials) and kernel B
// (flash_bwd_dq_sm90.cuh: dQ alone). Their instances are built in
// flash_bwd_kv64.cu, _kv128.cu, _fused64.cu, _fused128.cu, _dq64.cu and
// _dq128.cu, each in an nvcc process of its own; this source builds none.

#include "flash_bwd_dq_sm90.cuh"

namespace {

bool valid(int d, int window, int causal) {
  return (d == 64 || d == 128) && (window <= 0 || causal);
}

}  // namespace

// q, dout [b, hq, n, d], k/v [b, hkv, s, d] bf16 contiguous and 16-byte
// aligned; lse2 (the forward's natural-log LSE times log2(e)) and delta
// (rowsum(o * dout)) [b, hq, n_pad] f32, n_pad = n rounded up to a
// multiple of 64 (the pad is never read as a row's); dk/dv [b, hkv, s, d]
// bf16, every row written (zero for a key that no row sees). dq_accum
// (null: the two-kernel schedule) [b, hq, n, d] f32, zeroed by the caller:
// kernel A adds every (query tile, key block) pair's unscaled dQ partial to
// it. d in {64, 128}. window > 0 (causal only): the forward's band plus
// `sinks`; 0: none. Returns a CUDA error code: the instance's
// shared-memory attribute's, cudaErrorInvalidValue for a d or band outside
// these or inputs a TMA map cannot describe, else cudaGetLastError() after
// the launch.
extern "C" int fkp_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse2,
                                  const void* delta, void* dk, void* dv,
                                  void* dq_accum, int b, int hq, int hkv,
                                  int n, int s, int d, float sm_scale,
                                  int causal, int q_offset, int window,
                                  int sinks, void* stream) {
  if (!valid(d, window, causal)) return static_cast<int>(cudaErrorInvalidValue);
  const fkp_bwd_sm90::BwdArgs a{
      q, k, v, dout, static_cast<const float*>(lse2),
      static_cast<const float*>(delta), dk, dv, dq_accum, b, hq, hkv, n, s,
      sm_scale, causal, q_offset, window, sinks,
      static_cast<cudaStream_t>(stream)};
  using fkp_bwd_sm90::launch_dkdv;
  if (dq_accum != nullptr) {
    return d == 64 ? launch_dkdv<64, true>(a) : launch_dkdv<128, true>(a);
  }
  return d == 64 ? launch_dkdv<64, false>(a) : launch_dkdv<128, false>(a);
}

// Inputs as fkp_flash_bwd_dkdv's; dq [b, hq, n, d] bf16 (sm_scale * dS K),
// every row written. Returns a CUDA error code as fkp_flash_bwd_dkdv.
extern "C" int fkp_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse2,
                                const void* delta, void* dq, int b, int hq,
                                int hkv, int n, int s, int d, float sm_scale,
                                int causal, int q_offset, int window,
                                int sinks, void* stream) {
  if (!valid(d, window, causal)) return static_cast<int>(cudaErrorInvalidValue);
  const fkp_bwd_sm90::BwdArgs a{
      q, k, v, dout, static_cast<const float*>(lse2),
      static_cast<const float*>(delta), nullptr, nullptr, dq, b, hq, hkv, n,
      s, sm_scale, causal, q_offset, window, sinks,
      static_cast<cudaStream_t>(stream)};
  using fkp_bwd_sm90::launch_dq;
  return d == 64 ? launch_dq<64>(a) : launch_dq<128>(a);
}
