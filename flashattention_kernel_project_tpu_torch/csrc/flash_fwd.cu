// Fused GQA attention forward for Hopper (sm_90a): O and LSE in one pass.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel (reached through _fwd) in its three disciplines, stable=True
// (online), False (fixed-max) and "auto" (the per-block hybrid), with a
// static q_offset and, optionally, a sliding window with sinks (the band's
// key tiles alone are visited, as the TPU kernel's windowed grid); and
// _fwd_kernel_packed (reached through _fwd(pack=True)), the fixed-max d=64
// forward, whose launches the wrapper counts apart. With `bad` set, the
// fixed-max kernel also counts the rows that breach its range
// (_fwd_kernel's guard=True, :672-701), and with `pairs` set too, a row
// once for the two heads of a KV pair (the packed kernel's, :957-974). The
// kernel is flash_fwd_sm90.cuh's (wgmma, TMA, a K/V ring), where its design
// and bound are described. This source builds the online instances and
// the entry; flash_fwd_fixed.cu and flash_fwd_hybrid.cu the others, so that
// the three compile in parallel.

#include "flash_fwd_sm90.cuh"

// q [b, hq, n, d], k/v [b, hkv, s, d] bf16 contiguous and 16-byte aligned;
// o [b, hq, n, d] bf16, lse [b, hq, n] f32. scale_log2 = sm_scale *
// log2(e). d in {64, 128}. window > 0 (causal only): the band of `window`
// keys plus the first `sinks`; 0: none. disc: 0 online, 1 fixed-max, 2
// hybrid, which reads the f32 scalar at k_max (max_t ||k_t||, not null) on
// the device. bad (null: off; fixed-max only): an int32 on the device,
// zeroed by the caller, to which the fixed-max range guard adds its
// breaching rows; pairs (null, or with bad and an even hkv): b * hq / 2 * n
// bits on the device, zeroed by the caller, so that a row counts once for
// the two heads of a KV pair. Returns cudaGetLastError() after the launch
// (or the error of the instance's shared-memory attribute), or
// cudaErrorInvalidValue without one for a d, disc, k_max, bad or pairs
// outside these, or inputs a TMA map cannot describe.
extern "C" int fkp_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* k_max, void* bad,
                             void* pairs, int b, int hq, int hkv, int n, int s,
                             int d,
                             float scale_log2, int causal, int q_offset,
                             int window, int sinks, int disc, void* stream) {
  if ((d != 64 && d != 128) || disc < fkp_fwd::kOnline ||
      disc > fkp_fwd::kHybrid || (disc == fkp_fwd::kHybrid && !k_max) ||
      (bad && disc != fkp_fwd::kFixed) || (pairs && (!bad || hkv % 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fkp_sm90::FwdArgs a{
      q, k, v, o, lse, static_cast<const float*>(k_max),
      fkp_fwd::GuardArgs{static_cast<int*>(bad), static_cast<unsigned*>(pairs)},
      b, hq, hkv, n, s, scale_log2, causal, q_offset, window, sinks,
      static_cast<cudaStream_t>(stream)};
  if (disc == fkp_fwd::kFixed) return fkp_sm90::launch_fixed(d, a);
  if (disc == fkp_fwd::kHybrid) return fkp_sm90::launch_hybrid(d, a);
  return fkp_sm90::launch_disc<fkp_fwd::kOnline>(d, a);
}
