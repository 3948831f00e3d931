// Fused GQA attention forward for Hopper (sm_90a): O and LSE in one pass.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel (reached through _fwd) in its stable=True discipline, with a
// static q_offset and, optionally, a sliding window with sinks (the band's
// key tiles alone are visited, as the TPU kernel's windowed grid). The kernel is the dense flavour of the tiled forward in
// flash_fwd_core.cuh, where its design, precision and bound are described.

#include "flash_fwd_core.cuh"

using fkp_fwd::flash_fwd_kernel;
using fkp_fwd::kBlockM;
using fkp_fwd::kThreads;

// q [b, hq, n, d], k/v [b, hkv, s, d] bf16 contiguous; o [b, hq, n, d] bf16,
// lse [b, hq, n] f32. scale_log2 = sm_scale * log2(e). d in {64, 128}.
// window > 0 (causal only): the band of `window` keys plus the first
// `sinks`; 0: none. Returns cudaGetLastError() after the launch.
extern "C" int fkp_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int b, int hq, int hkv, int n,
                             int s, int d, float scale_log2, int causal,
                             int q_offset, int window, int sinks,
                             void* stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  auto launch = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(qp, kp, vp, op, lp, hq, hkv, n, s,
                                      scale_log2, causal, q_offset, window,
                                      sinks, nullptr, nullptr,
                                      fkp_fwd::PagedArgs{});
  };
  const bool win = window > 0;
  if (d == 64) {
    launch(win ? &flash_fwd_kernel<64, fkp_fwd::kDense, true>
               : &flash_fwd_kernel<64, fkp_fwd::kDense, false>);
  } else if (d == 128) {
    launch(win ? &flash_fwd_kernel<128, fkp_fwd::kDense, true>
               : &flash_fwd_kernel<128, fkp_fwd::kDense, false>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
