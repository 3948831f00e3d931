// Fused GQA attention forward for Hopper (sm_90a): O and LSE in one pass.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel (reached through _fwd) in its three disciplines, stable=True
// (online), False (fixed-max) and "auto" (the per-block hybrid), with a
// static q_offset and, optionally, a sliding window with sinks (the band's
// key tiles alone are visited, as the TPU kernel's windowed grid); and
// _fwd_kernel_packed (reached through _fwd(pack=True)), the fixed-max d=64
// forward. The TPU pairs two KV heads block-diagonally there because a d=64
// product fills only half of its 128-deep matrix unit; mma.sync m16n8k16 is
// 16 deep, so d=64 leaves no unit idle and the fixed-max d=64 instance
// computes kernel 2's function as it stands (the wrapper counts those
// launches apart). With `bad` set, the fixed-max kernel also counts the
// rows that breach its range (_fwd_kernel's guard=True, :672-701), and with
// `pairs` set too, a row once for the two heads of a KV pair (the packed
// kernel's, :957-974), in the epilogue of flash_fwd_core.cuh. The kernel is
// the dense flavour of the tiled forward in flash_fwd_core.cuh, where its
// design, disciplines, precision and bound are described.

#include "flash_fwd_core.cuh"

using fkp_fwd::flash_fwd_kernel;
using fkp_fwd::kBlockM;
using fkp_fwd::kDense;
using fkp_fwd::kThreads;

// q [b, hq, n, d], k/v [b, hkv, s, d] bf16 contiguous; o [b, hq, n, d] bf16,
// lse [b, hq, n] f32. scale_log2 = sm_scale * log2(e). d in {64, 128}.
// window > 0 (causal only): the band of `window` keys plus the first
// `sinks`; 0: none. disc: 0 online, 1 fixed-max, 2 hybrid, which reads the
// f32 scalar at k_max (max_t ||k_t||, not null) on the device. bad (null:
// off; fixed-max only): an int32 on the device, zeroed by the caller, to
// which the fixed-max range guard adds its breaching rows; pairs (null, or
// with bad and an even hkv): b * hq / 2 * n bits on the device, zeroed by
// the caller, so that a row counts once for the two heads of a KV pair.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// without one for a d, disc, k_max, bad or pairs outside these.
extern "C" int fkp_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* k_max, void* bad,
                             void* pairs, int b, int hq, int hkv, int n, int s,
                             int d,
                             float scale_log2, int causal, int q_offset,
                             int window, int sinks, int disc, void* stream) {
  const auto kernel = fkp_fwd::pick_instance<kDense>(
      d, window > 0, disc, [](auto D, auto W, auto C) {
        return &flash_fwd_kernel<decltype(D)::value, kDense, decltype(W)::value,
                                 decltype(C)::value>;
      });
  if (!kernel || (disc == fkp_fwd::kHybrid && !k_max) ||
      (bad && disc != fkp_fwd::kFixed) || (pairs && (!bad || hkv % 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), hq, hkv, n, s, scale_log2, causal, q_offset,
      window, sinks, nullptr, nullptr, fkp_fwd::PagedArgs{},
      static_cast<const float*>(k_max),
      fkp_fwd::GuardArgs{static_cast<int*>(bad),
                         static_cast<unsigned*>(pairs)});
  return static_cast<int>(cudaGetLastError());
}
