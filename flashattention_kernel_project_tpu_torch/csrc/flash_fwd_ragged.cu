// Ragged GQA attention forward for Hopper (sm_90a): per-row KV lengths and
// causal query offsets, O only.
//
// Replaces flashattention_kernel_project_tpu/ops/flash_attention.py::
// _fwd_kernel_ragged in its stable=True (online) and stable=False
// (fixed-max) disciplines ("auto" is online, as the TPU kernel has no
// hybrid), for a bf16 cache (reached through flash_attention_ragged) and
// for an int8 or e4m3 cache with per-token scales [B, Hkv, S_max, 1]
// (quant=True, reached through flash_attention_ragged_kv_quant): chunked
// prefill and the prefix-cache suffix, where a chunk of T queries attends
// a live KV cache of S_max rows of which row b holds kv_lens[b]. Query i of row b sees key j iff j < kv_lens[b] and, when
// causal, j <= i + q_offsets[b] (and, with a sliding window, j lies in the
// band of the last `window` positions or among the first `sinks` keys).
// A row that sees no key gives zeros.
//
// It is the ragged flavour of the tiled forward in flash_fwd_core.cuh (the
// design, precision and bound are described there). What this flavour adds:
// - The bounds stay on the device. kv_lens and q_offsets arrive as int32
//   pointers and each block reads its row's pair, so the host never syncs to
//   learn them (one sync per layer per chunk otherwise).
// - Live key tiles are counted per (batch row, query tile) from those
//   bounds: tiles past kv_len or past the causal diagonal of the tile's last
//   query, or between the sinks and the band, are never loaded, as the TPU
//   kernel's `live` test skips them.
// - Tiles wholly inside every row's bound skip the mask.
// - K and V are the cache buffers themselves, [B, Hkv, S_max, D]: S_max is
//   the row stride and kv_len the bound.
// Tile size: 64 query rows, as the dense forward. In serving, T is the
// prefill chunk (256) for all but a prompt's last chunk, which pads its
// tile; a smaller tile for short chunks would pay only on that last chunk.

#include "flash_fwd_core.cuh"

using fkp_fwd::flash_fwd_kernel;
using fkp_fwd::flash_fwd_q_kernel;
using fkp_fwd::kBlockM;
using fkp_fwd::kRagged;
using fkp_fwd::kThreads;

// q [b, hq, n, d], k/v [b, hkv, s_max, d] bf16 contiguous, kv_lens and
// q_offsets [b] int32 on the device; o [b, hq, n, d] bf16. scale_log2 =
// sm_scale * log2(e). d in {64, 128}. window > 0 (causal only): the band
// plus `sinks`; 0: none. disc: 0 online, 1 fixed-max. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue without one
// for a d or disc outside these.
extern "C" int fkp_flash_fwd_ragged(const void* q, const void* k,
                                    const void* v, void* o,
                                    const void* kv_lens, const void* q_offsets,
                                    int b, int hq, int hkv, int n, int s_max,
                                    int d, float scale_log2, int causal,
                                    int window, int sinks, int disc,
                                    void* stream) {
  const auto kernel = fkp_fwd::pick_instance<kRagged>(
      d, window > 0, disc, [](auto D, auto W, auto C) {
        return &flash_fwd_kernel<decltype(D)::value, kRagged,
                                 decltype(W)::value, decltype(C)::value>;
      });
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      nullptr, hq, hkv, n, s_max, scale_log2, causal, 0, window, sinks,
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_offsets),
      nullptr, fkp_fwd::GuardArgs{});
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <class KV>
int launch_ragged_q(const dim3& grid, cudaStream_t st, const void* q,
                    const void* k, const void* k_scale, const void* v,
                    const void* v_scale, void* o, const void* kv_lens,
                    const void* q_offsets, int hq, int hkv, int n, int s_max,
                    int d, float scale_log2, int causal, int window, int sinks,
                    int disc) {
  const auto kernel = fkp_fwd::pick_instance<kRagged>(
      d, window > 0, disc, [](auto D, auto W, auto C) {
        return &flash_fwd_q_kernel<decltype(D)::value, kRagged, KV,
                                   decltype(W)::value, decltype(C)::value>;
      });
  if (!kernel) return static_cast<int>(cudaErrorInvalidValue);
  const fkp_fwd::QuantArgs qa{static_cast<const float*>(k_scale),
                              static_cast<const float*>(v_scale)};
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<__nv_bfloat16*>(o), nullptr, hq,
      hkv, n, s_max, scale_log2, causal, 0, window, sinks,
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_offsets),
      qa, nullptr, fkp_fwd::GuardArgs{});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, hq, n, d] bf16; k/v [b, hkv, s_max, d] int8 (fp8 == 0) or e4m3
// (fp8 == 1) and their scales [b, hkv, s_max, 1] f32, all contiguous;
// kv_lens, q_offsets, o, scale_log2, window, sinks and disc as
// fkp_flash_fwd_ragged. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without one for a d or disc outside these.
extern "C" int fkp_flash_fwd_ragged_q(const void* q, const void* k,
                                      const void* k_scale, const void* v,
                                      const void* v_scale, void* o,
                                      const void* kv_lens,
                                      const void* q_offsets, int b, int hq,
                                      int hkv, int n, int s_max, int d,
                                      float scale_log2, int causal, int window,
                                      int sinks, int disc, int fp8,
                                      void* stream) {
  const dim3 grid((n + kBlockM - 1) / kBlockM, hq, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp8) {
    return launch_ragged_q<__nv_fp8_e4m3>(grid, st, q, k, k_scale, v, v_scale,
                                          o, kv_lens, q_offsets, hq, hkv, n,
                                          s_max, d, scale_log2, causal, window,
                                          sinks, disc);
  }
  return launch_ragged_q<int8_t>(grid, st, q, k, k_scale, v, v_scale, o,
                                 kv_lens, q_offsets, hq, hkv, n, s_max, d,
                                 scale_log2, causal, window, sinks, disc);
}
