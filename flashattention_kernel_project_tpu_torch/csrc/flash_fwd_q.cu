// Fused GQA attention forward over an 8-bit KV cache for Hopper (sm_90a):
// O and LSE in one pass.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel with quant=True (reached through flash_attention_kv_quant and
// flash_attention_kv_quant_with_lse): the dense forward over int8 or e4m3
// K/V [B, Hkv, S, D] with one f32 scale per key and head ([B, Hkv, S, 1]),
// in the three disciplines and with the optional window and sinks of the
// bf16 forward (flash_fwd.cu). It serves the long-context prefill over a
// quantized cache (the 32K int8 case of BASELINE.json's config 5). The
// kernel is the mma.sync core of flash_fwd_core.cuh:
// each tile's 8-bit rows widen exactly to bf16 in shared memory, the K
// scale multiplies the f32 score column, the V scale folds into p after l
// has summed it. It reads half the K/V bytes of the bf16 forward; at
// prefill shapes it is bound by the tensor cores and the softmax
// arithmetic, as that one is, and the widening adds to the latter. Its own
// source (not flash_fwd.cu) so that its 24 instances compile beside the
// others, in parallel. With `bad` set, the fixed-max instance counts the
// rows that breach its range, as flash_fwd.cu's (JAX's _fwd takes guard=True
// with k_scale too).

#include "flash_fwd_core.cuh"

using fkp_fwd::flash_fwd_q_kernel;
using fkp_fwd::kBlockM;
using fkp_fwd::kThreads;

namespace {

template <class KV>
int launch_dense_q(const dim3& grid, cudaStream_t st, const void* q,
                   const void* k, const void* k_scale, const void* v,
                   const void* v_scale, void* o, void* lse, const void* k_max,
                   void* bad, int hq, int hkv, int n, int s, int d,
                   float scale_log2, int causal, int q_offset, int window,
                   int sinks, int disc) {
  const auto kernel = fkp_fwd::pick_instance(
      d, window > 0, disc, [](auto D, auto W, auto C) {
        return &flash_fwd_q_kernel<decltype(D)::value, KV,
                                   decltype(W)::value, decltype(C)::value>;
      });
  if (!kernel || (disc == fkp_fwd::kHybrid && !k_max) ||
      (bad && disc != fkp_fwd::kFixed)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const fkp_fwd::QuantArgs qa{static_cast<const float*>(k_scale),
                              static_cast<const float*>(v_scale)};
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), hq, hkv, n, s, scale_log2, causal, q_offset,
      window, sinks, qa,
      static_cast<const float*>(k_max),
      fkp_fwd::GuardArgs{static_cast<int*>(bad), nullptr});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, hq, n, d] bf16; k/v [b, hkv, s, d] int8 (fp8 == 0) or e4m3
// (fp8 == 1) and their scales [b, hkv, s, 1] f32, all contiguous; o [b, hq,
// n, d] bf16, lse [b, hq, n] f32. scale_log2, causal, q_offset, window,
// sinks, disc, k_max (the max norm of the dequantized keys; not null for
// hybrid) and bad (the fixed-max range guard's count, or null) as
// fkp_flash_fwd. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without one for a d, disc, k_max or bad outside
// these.
extern "C" int fkp_flash_fwd_q(const void* q, const void* k,
                               const void* k_scale, const void* v,
                               const void* v_scale, void* o, void* lse,
                               const void* k_max, void* bad, int b, int hq,
                               int hkv, int n, int s, int d, float scale_log2,
                               int causal, int q_offset, int window, int sinks,
                               int disc, int fp8, void* stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8) {
    return launch_dense_q<__nv_fp8_e4m3>(grid, st, q, k, k_scale, v, v_scale,
                                         o, lse, k_max, bad, hq, hkv, n, s, d,
                                         scale_log2, causal, q_offset, window,
                                         sinks, disc);
  }
  return launch_dense_q<int8_t>(grid, st, q, k, k_scale, v, v_scale, o, lse,
                                k_max, bad, hq, hkv, n, s, d, scale_log2,
                                causal, q_offset, window, sinks, disc);
}
