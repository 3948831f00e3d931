// Fused GQA attention forward over an 8-bit KV cache for Hopper (sm_90a):
// O and LSE in one pass.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel with quant=True (:135, :286-352, :459-559; pallas_call
// :1375/:1380), reached through flash_attention_kv_quant (:3002) and
// flash_attention_kv_quant_with_lse (:3039): the dense forward over int8
// or e4m3 K/V [B, Hkv, S, D] with one f32 scale per key and head ([B, Hkv,
// S, 1]), in the three disciplines ("auto" bounded by k_max of the
// dequantized keys), with a static q_offset, the optional window and
// sinks, and the fixed-max range guard (JAX's _fwd takes guard=True with
// k_scale too). It serves the long-context prefill over a quantized cache
// (the 32K int8 case of BASELINE.json's config 5). The kernel is
// flash_fwd_sm90.cuh's block body (wgmma, TMA, a ring) in its 8-bit form:
// 64-key byte tiles brought by TMA into a ring of byte stages and widened
// exactly to the swizzled bf16 tiles the products' descriptors read by the
// producer warpgroup's four warps, the K scale on the f32 score
// column, the V scale folded into p after l has summed it, as the ragged
// forward's 8-bit route; the bf16 dense forward's LSE epilogue, per-warp
// hybrid and guard count, and its blocks of 128 query rows in two
// ping-ponging consumer warpgroups (64 where their grid fits one wave of
// the SMs). At prefill shapes it is bound by the tensor cores and the
// softmax arithmetic, as the bf16 forward is; it reads half its K/V bytes.
// This source builds the int8 online instances and the C entry;
// flash_fwd_q_fixed.cu, flash_fwd_q_hybrid.cu, flash_fwd_q_fp8.cu,
// flash_fwd_q_fp8_fixed.cu and flash_fwd_q_fp8_hybrid.cu the others, so
// that the six compile in parallel.

#include "flash_fwd_sm90.cuh"

// q [b, hq, n, d] bf16 16-byte aligned; k/v [b, hkv, s, d] int8 (fp8 == 0)
// or e4m3 (fp8 == 1) and their scales [b, hkv, s, 1] f32, all contiguous;
// o [b, hq, n, d] bf16, lse [b, hq, n] f32. scale_log2, causal, q_offset,
// window, sinks, disc, k_max (the max norm of the dequantized keys; not
// null for hybrid) and bad (the fixed-max range guard's count, or null)
// as fkp_flash_fwd. Returns cudaGetLastError() after the launch (or the
// error of the instance's shared-memory attribute), or
// cudaErrorInvalidValue without one for a d, disc, k_max or bad outside
// these, or inputs a TMA map cannot describe.
extern "C" int fkp_flash_fwd_q(const void* q, const void* k,
                               const void* k_scale, const void* v,
                               const void* v_scale, void* o, void* lse,
                               const void* k_max, void* bad, int b, int hq,
                               int hkv, int n, int s, int d, float scale_log2,
                               int causal, int q_offset, int window, int sinks,
                               int disc, int fp8, void* stream) {
  if ((d != 64 && d != 128) || disc < fkp_fwd::kOnline ||
      disc > fkp_fwd::kHybrid || (disc == fkp_fwd::kHybrid && !k_max) ||
      (bad && disc != fkp_fwd::kFixed) || !k_scale || !v_scale || b <= 0 ||
      hkv <= 0 || hq % hkv || n <= 0 || s <= 0 || b > 65535 || hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fkp_sm90::FwdArgs a{
      q, k, v, o, lse, static_cast<const float*>(k_max),
      fkp_fwd::GuardArgs{static_cast<int*>(bad), nullptr},
      b, hq, hkv, n, s, scale_log2, causal, q_offset, window, sinks,
      static_cast<cudaStream_t>(stream)};
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  if (fp8) {
    return disc == fkp_fwd::kHybrid  ? fkp_sm90::launch_q_e4m3_hybrid(d, a)
           : disc == fkp_fwd::kFixed ? fkp_sm90::launch_q_e4m3_fixed(d, a)
                                     : fkp_sm90::launch_q_e4m3(d, a);
  }
  return disc == fkp_fwd::kHybrid  ? fkp_sm90::launch_q_int8_hybrid(d, a)
         : disc == fkp_fwd::kFixed ? fkp_sm90::launch_q_int8_fixed(d, a)
                                   : fkp_sm90::launch_q_disc<int8_t, fkp_fwd::kOnline>(d, a);
}
